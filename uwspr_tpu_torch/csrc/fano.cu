// Batched Fano sequential decoder: one thread per lane, each lane free.
//
// Replaces: uwspr_tpu/fec/fano_pallas.py::fano_decode_batch_pallas (kernel
// built by `_make_kernel`, fano_pallas.py:73-237). The per-lane algorithm is
// fano_lane.cuh, which follows uwspr_tpu/fec/native/fano_native.cc:45-132.
//
// What bounds it on the card: the longest lane. A lane is a data-dependent
// walk of up to 3 * maxcycles * 81 dependent steps (the full budget is
// 810,000 forward looks at maxcycles 10,000); every step reads and writes
// its node arrays. Bytes and operations are tiny (162 symbols in, 26 bytes
// out); latency of the serial chain is everything.
//
// What the design does about it: the TPU kernel ran 128 lanes in lockstep
// over (88, 128) planes with iota row selects because Mosaic cannot index a
// lane's arrays dynamically (fano_pallas.py:15-27), so a block ran as long
// as its slowest lane and every step paid full-plane selects. Here each
// thread owns its lane: the ~1.4 KB of node state (gamma, enc, tm0, tm1,
// branch for 82 nodes) sits in thread-local memory, which stays in L1,
// branch metrics come from the u8 symbols and a shared-memory copy of the
// (2, 256) metric table, and a lane that finishes stops. One warp per block
// spreads the lanes of a launch over as many SMs as possible, so lanes that
// time out share an SM with as few others as the launch allows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fano_lane.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void fano_kernel(const uint8_t* __restrict__ symbols,
                            const uint8_t* __restrict__ active,
                            const int32_t* __restrict__ mettab, int L,
                            int delta, int32_t budget,
                            uint8_t* __restrict__ success,
                            uint8_t* __restrict__ data,
                            int32_t* __restrict__ metric,
                            int32_t* __restrict__ cycles,
                            int32_t* __restrict__ maxnp) {
  __shared__ int32_t smet[512];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) smet[i] = mettab[i];
  __syncthreads();
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  uint8_t bytes[uwspr::kNbytes];
  const uwspr::FanoLaneResult r = uwspr::fano_lane(
      symbols + static_cast<size_t>(l) * 2 * uwspr::kNbits, smet, delta,
      budget, active[l] != 0, bytes);
  success[l] = static_cast<uint8_t>(r.success);
  for (int b = 0; b < uwspr::kNbytes; ++b)
    data[static_cast<size_t>(l) * uwspr::kNbytes + b] = bytes[b];
  metric[l] = r.metric;
  cycles[l] = r.cycles;
  maxnp[l] = r.maxnp;
}

}  // namespace

extern "C" {

// symbols: (L, 162) u8 deinterleaved soft symbols; active: (L,) u8 0/1;
// mettab: (2, 256) int32. Outputs (all written): success (L,) u8 0/1,
// data (L, 10) u8, metric / cycles / maxnp (L,) int32.
// Launches on `stream`; returns cudaGetLastError() after the launch.
int uwspr_fano_decode(const uint8_t* symbols, const uint8_t* active,
                      const int32_t* mettab, int L, int delta, int budget,
                      uint8_t* success, uint8_t* data, int32_t* metric,
                      int32_t* cycles, int32_t* maxnp, void* stream) {
  if (L > 0) {
    const dim3 blocks((L + kThreads - 1) / kThreads);
    fano_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        symbols, active, mettab, L, delta, budget, success, data, metric,
        cycles, maxnp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
