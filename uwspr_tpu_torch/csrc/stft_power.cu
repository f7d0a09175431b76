// Fused STFT power: frame build + half-sine window + DFT (bf16 products, f32
// sums) + |.|^2, frames kept out of device memory.
//
// Replaces: uwspr_tpu/ops/stft_pallas.py::stft_power_pallas (kernel
// `_kernel`, stft_pallas.py:56-77) and keeps the numerics of its plain twin
// ops/stft.py impl "matmul_bf16" (stft.py:74-93):
//
//   fr[i, j] = bf16(Re z[i*hop + j] * w[j]),  fi likewise (product in f32),
//   re[i, c] = sum_j fr*C[j, c] - sum_j fi*S[j, c],
//   im[i, c] = sum_j fr*S[j, c] + sum_j fi*C[j, c],
//   out[i, c] = re^2 + im^2,
//
// with C, S the cos/sin DFT matrices (fftshift folded in) rounded to bf16
// and restricted to the caller's column window, so only the columns the
// caller reads are computed. Samples at or past fl read as zero. A bf16 x
// bf16 product is exact in f32, so kernel and plain version differ only in
// the order of the f32 sums.
//
// What bounds it on the card: the DFT's multiply-adds (4 * 512 per output
// column and frame) on the CUDA cores; the input is read once (360 KB per
// window) and the output written once. At the device decoder's 48-column
// window that is 4.4 GFLOP for a 128-window batch.
//
// What the design does about it: a block owns kFrames consecutive frames of
// one window and kCols output columns. Frames overlap by size - hop samples,
// so the block stages (kFrames - 1) * hop + size samples once in shared
// memory; then, 64 DFT rows at a time, it builds the windowed bf16 frame
// chunk and the matching cos/sin rows in shared memory (padded rows, no bank
// conflicts) and each thread accumulates four columns of one frame in
// registers. The product is computed here, not by cuBLAS.
//
// Build: nvcc without --use_fast_math; the window products and bf16
// roundings are explicit round-to-nearest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 16;            // frames per block
constexpr int kCols = 32;              // output columns per block
constexpr int kColsPerThread = 4;
constexpr int kThreads = kFrames * kCols / kColsPerThread;   // 128
constexpr int kChunk = 64;             // DFT rows per shared-memory chunk
constexpr int kRow = kChunk + 1;       // padded frame-chunk row stride
constexpr size_t kStaticSmem =
    sizeof(float) * (2 * kFrames * kRow + 2 * kChunk * kCols);

__global__ void __launch_bounds__(kThreads)
stft_power_kernel(const float2* __restrict__ z, int fl, int n_ffts,
                  int size, int hop, const float* __restrict__ window,
                  const __nv_bfloat16* __restrict__ cosm,
                  const __nv_bfloat16* __restrict__ sinm, int ncols,
                  float* __restrict__ out) {
  extern __shared__ float2 samples[];    // (kFrames - 1) * hop + size
  __shared__ float fre[kFrames * kRow];
  __shared__ float fim[kFrames * kRow];
  __shared__ __align__(16) float cs_c[kChunk * kCols];
  __shared__ __align__(16) float cs_s[kChunk * kCols];

  const int frame0 = blockIdx.x * kFrames;
  const int col0 = blockIdx.y * kCols;
  const int w = blockIdx.z;
  const int tid = threadIdx.x;
  const int f = tid / (kCols / kColsPerThread);
  const int g = tid - f * (kCols / kColsPerThread);
  const float2* zw = z + static_cast<size_t>(w) * fl;

  const int span = (kFrames - 1) * hop + size;
  const int s0 = frame0 * hop;
  for (int e = tid; e < span; e += kThreads) {
    const int n = s0 + e;
    samples[e] = n < fl ? zw[n] : make_float2(0.f, 0.f);
  }

  float a[kColsPerThread] = {}, bs[kColsPerThread] = {};
  float c[kColsPerThread] = {}, d[kColsPerThread] = {};
  for (int j0 = 0; j0 < size; j0 += kChunk) {
    __syncthreads();   // samples staged / previous chunk consumed
    for (int e = tid; e < kFrames * kChunk; e += kThreads) {
      const int ff = e / kChunk;
      const int jj = e - ff * kChunk;
      const int j = j0 + jj;
      float xr = 0.f, xi = 0.f;
      if (j < size) {
        const float2 x = samples[ff * hop + j];
        const float wj = window[j];
        xr = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x.x, wj)));
        xi = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x.y, wj)));
      }
      fre[ff * kRow + jj] = xr;
      fim[ff * kRow + jj] = xi;
    }
    for (int e = tid; e < kChunk * kCols; e += kThreads) {
      const int jj = e / kCols;
      const int cc = e - jj * kCols;
      const int j = j0 + jj;
      const int col = col0 + cc;
      float vc = 0.f, vs = 0.f;
      if (j < size && col < ncols) {
        vc = __bfloat162float(cosm[static_cast<size_t>(j) * ncols + col]);
        vs = __bfloat162float(sinm[static_cast<size_t>(j) * ncols + col]);
      }
      cs_c[e] = vc;
      cs_s[e] = vs;
    }
    __syncthreads();
    const float* fr_row = fre + f * kRow;
    const float* fi_row = fim + f * kRow;
#pragma unroll 4
    for (int jj = 0; jj < kChunk; ++jj) {
      const float xr = fr_row[jj];
      const float xi = fi_row[jj];
      const float4 cv = *reinterpret_cast<const float4*>(
          cs_c + jj * kCols + g * kColsPerThread);
      const float4 sv = *reinterpret_cast<const float4*>(
          cs_s + jj * kCols + g * kColsPerThread);
      const float cvs[4] = {cv.x, cv.y, cv.z, cv.w};
      const float svs[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        a[q] += xr * cvs[q];
        bs[q] += xi * svs[q];
        c[q] += xr * svs[q];
        d[q] += xi * cvs[q];
      }
    }
  }
  const int frame = frame0 + f;
  if (frame >= n_ffts) return;
  float* orow = out + (static_cast<size_t>(w) * n_ffts + frame) * ncols;
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) {
    const int col = col0 + g * kColsPerThread + q;
    if (col < ncols) {
      const float re = a[q] - bs[q];
      const float im = c[q] + d[q];
      orow[col] = re * re + im * im;
    }
  }
}

}  // namespace

extern "C" {

// z: (B, fl) complex64 as interleaved (re, im) f32 pairs; window: (size,)
// f32; cosm, sinm: (size, ncols) bf16, the caller's column window of the
// shifted DFT matrices; out: (B, n_ffts, ncols) f32, written. Launches on
// `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue without launching when the staged span does not
// fit in shared memory).
int uwspr_stft_power(const float* z, int B, int fl, int n_ffts, int size,
                     int hop, const float* window, const uint16_t* cosm,
                     const uint16_t* sinm, int ncols, float* out,
                     void* stream) {
  const size_t dyn = sizeof(float2) *
                     static_cast<size_t>((kFrames - 1) * hop + size);
  if (size < 1 || hop < 1 || ncols < 1 || dyn + kStaticSmem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && n_ffts > 0) {
    const dim3 blocks((n_ffts + kFrames - 1) / kFrames,
                      (ncols + kCols - 1) / kCols, B);
    stft_power_kernel<<<blocks, kThreads, dyn,
                        static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(z), fl, n_ffts, size, hop, window,
        reinterpret_cast<const __nv_bfloat16*>(cosm),
        reinterpret_cast<const __nv_bfloat16*>(sinm), ncols, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
