// Stage markers of the device decode: one empty kernel a stage.
//
// Not a TPU kernel. A CUDA graph captured from one stream is a chain, so
// in a profiler trace of a replay the kernels between uwspr_mark_<X> and
// the next marker belong to stage X, on the device trace's own clock.
// ops/marks.py::STAGES holds the stages in the order of `stage` below;
// DeviceDecoder launches a marker at the start of each stage and
// uwspr_mark_end after the packed output is written.
//
// Each marker is one thread that does nothing: about a microsecond of
// device time a launch, eleven launches a single-pass replay. extern "C"
// keeps the kernels' names unmangled, so a trace shows them as written
// here.

#include <cuda_runtime.h>

extern "C" {

__global__ void uwspr_mark_stft() {}
__global__ void uwspr_mark_coarse() {}
__global__ void uwspr_mark_select() {}
__global__ void uwspr_mark_compact() {}
__global__ void uwspr_mark_refine() {}
__global__ void uwspr_mark_prefano_tail() {}
__global__ void uwspr_mark_fano1() {}
__global__ void uwspr_mark_fano2() {}
__global__ void uwspr_mark_osd() {}
__global__ void uwspr_mark_subtract() {}
__global__ void uwspr_mark_pack() {}
__global__ void uwspr_mark_end() {}

// stage: the index of the stage in ops/marks.py::STAGES. Launches its
// marker on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a stage it does not know.
int uwspr_mark(int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: uwspr_mark_stft<<<1, 1, 0, s>>>(); break;
    case 1: uwspr_mark_coarse<<<1, 1, 0, s>>>(); break;
    case 2: uwspr_mark_select<<<1, 1, 0, s>>>(); break;
    case 3: uwspr_mark_compact<<<1, 1, 0, s>>>(); break;
    case 4: uwspr_mark_refine<<<1, 1, 0, s>>>(); break;
    case 5: uwspr_mark_prefano_tail<<<1, 1, 0, s>>>(); break;
    case 6: uwspr_mark_fano1<<<1, 1, 0, s>>>(); break;
    case 7: uwspr_mark_fano2<<<1, 1, 0, s>>>(); break;
    case 8: uwspr_mark_osd<<<1, 1, 0, s>>>(); break;
    case 9: uwspr_mark_subtract<<<1, 1, 0, s>>>(); break;
    case 10: uwspr_mark_pack<<<1, 1, 0, s>>>(); break;
    case 11: uwspr_mark_end<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
