// The coarse sync grid as a gather-sum over the 162 one-hot taps:
//
//   ss[b, s, w, m] = sum_{k<162} sign[k] * A[b, 2k + w, x_s + offs[m, k]],
//   pw[b, s, w, m] = sum_{k<162}           B[b, 2k + w, x_s + offs[m, k]],
//   out[b, s, w, m] = ss / pw,
//
// for each window b, candidate slot s = (candidate, freq -2..2) at window
// column x_s = ifr[b, s], lag w < 26 and drift model m. A and B are the
// powersum planes of coarse/search.py::powersum_planes, taken over the
// spectrum's columns [lo, lo + width) and zero outside them, rounded to
// bf16 (and back) when asked.
//
// Replaces no Pallas kernel: the JAX package leaves this grid to XLA's
// dilated convolution and im2col einsum (uwspr_tpu/coarse/search.py:
// 259-339), and the port ran it as cuDNN's convolution (narrowband) and an
// f32 SGEMM on im2col copies (wideband), whose one-hot weights are zero at
// 12 of every 13 shifts.
//
// Exact arithmetic, held bit for bit by coarse/search.py::sync_grid_plain:
// the planes are built here from the power spectrum with the adds of
// powersum_planes in its order (sqrtf and the bf16 rounding are IEEE
// round-to-nearest, as torch's); each output sums its 162 terms in
// ascending k, starting from 0, with one rounding a term (fmaf of +-1 is
// an exact add or subtract); the quotient is an IEEE division. The order
// does not depend on the tiling, so two models with equal offset rows
// give equal scores.
//
// What bounds it on the card: the adds, 2 x 162 x 26 a (window, column,
// model), 543 M a wideband window (0.016 ms at 128 f32 adds a clock an SM,
// 132 SMs, 1980 MHz), and the shared-memory reads that feed them: every
// add reads one plane value, 0.065 ms a window at 32 words a clock an SM.
// The grid written for the selection (13.1 MB a wideband window) and the
// spectrum read are far below either.
//
// What the design does about it: a block owns one window and a tile of
// kTile window columns. It stages the two planes of every row over the
// tile's columns and its +-6 shift halo in shared memory as (A, B) pairs,
// so a lag's two terms come in one 8-byte load, and the per-symbol shifts
// of every model as bytes. Its threads are models (a warp holds 32 models
// of one column), each summing the 26 lags of both planes in 52 registers:
// at a symbol the warp reads one row at shifts that lie within 13
// neighbouring pairs, which no two banks share, and where models share a
// shift the read is a broadcast. A column that no candidate slot reads is
// skipped, and a tile with none exits before staging (a narrowband window
// reads about 31 of its 42 columns). The epilogue divides and writes each
// slot of the column: the models are the fastest dimension of the grid,
// so a warp writes 128 contiguous bytes a lag.
//
// Build: nvcc without --use_fast_math (IEEE sqrtf, division, denormals).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSym = 162;                   // symbols a frame
constexpr int kLags = 26;                   // half-symbol lags
constexpr int kRows = 2 * (kSym - 1) + kLags;  // spectrum rows read: 348
constexpr int kDMin = -6;                   // drift-model shifts, bins
constexpr int kDMax = 6;
constexpr int kTile = 4;                    // window columns a block owns
constexpr int kCols = kTile + kDMax - kDMin;    // staged columns: 16
constexpr int kModels = 128;                // models a column group holds
constexpr int kGroups = 2;                  // column groups a block runs
constexpr int kThreads = kModels * kGroups;
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// dynamic shared memory: planes, signs, shifts, the tile's slot list
__host__ __device__ size_t smem_bytes(int n_slots, int M) {
  return align16(sizeof(float2) * kRows * kCols) +
         align16(sizeof(float) * kSym) +
         align16(static_cast<size_t>(kSym) * M) +
         sizeof(int) * static_cast<size_t>(n_slots);
}

__device__ __forceinline__ float root(const float* row, int c, int size) {
  return (c >= 0 && c < size) ? sqrtf(row[c]) : 0.f;
}

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads, 2)
sync_grid_kernel(const float* __restrict__ ps, int n, int size, int lo,
                 int width, const int32_t* __restrict__ ifr, int n_slots,
                 const uint8_t* __restrict__ offT, int M,
                 const float* __restrict__ sign, int bf16,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* planes = reinterpret_cast<float2*>(smem);        // [kRows][kCols]
  float* sgn = reinterpret_cast<float*>(
      smem + align16(sizeof(float2) * kRows * kCols));      // [kSym]
  uint8_t* shift = reinterpret_cast<uint8_t*>(sgn) +
                   align16(sizeof(float) * kSym);           // [kSym][M]
  int* slots = reinterpret_cast<int*>(
      shift + align16(static_cast<size_t>(kSym) * M));      // by column
  __shared__ int count[kTile], start[kTile], fill[kTile];
  __shared__ int total;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;
  const int b = blockIdx.y;
  const int32_t* cols = ifr + static_cast<size_t>(b) * n_slots;

  // the candidate slots whose column lies in this tile, grouped by column
  if (tid < kTile) {
    count[tid] = 0;
    fill[tid] = 0;
  }
  __syncthreads();
  for (int s = tid; s < n_slots; s += kThreads) {
    const int x = cols[s] - t0;
    if (x >= 0 && x < kTile) atomicAdd(&count[x], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int x = 0; x < kTile; ++x) {
      start[x] = acc;
      acc += count[x];
    }
    total = acc;
  }
  __syncthreads();
  if (total == 0) return;               // no slot reads these columns
  for (int s = tid; s < n_slots; s += kThreads) {
    const int x = cols[s] - t0;
    if (x >= 0 && x < kTile) slots[start[x] + atomicAdd(&fill[x], 1)] = s;
  }

  // signs, shifts and the (A, B) planes of rows [0, kRows) at window
  // columns t0 - 6 .. t0 + kTile + 5, zero outside [0, width)
  for (int i = tid; i < kSym; i += kThreads) sgn[i] = sign[i];
  for (int i = tid; i < kSym * M; i += kThreads) shift[i] = offT[i];
  const float* win = ps + static_cast<size_t>(b) * n * size;
  for (int e = tid; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols;
    const int x = t0 + kDMin + (e - r * kCols);
    float a = 0.f, p = 0.f;
    if (x >= 0 && x < width) {
      const float* row = win + static_cast<size_t>(r) * size;
      const int c = lo + x;
      const float m3 = root(row, c - 3, size);
      const float m1 = root(row, c - 1, size);
      const float p1 = root(row, c + 1, size);
      const float p3 = root(row, c + 3, size);
      a = __fsub_rn(__fadd_rn(m1, p3), __fadd_rn(m3, p1));
      p = __fadd_rn(__fadd_rn(__fadd_rn(m3, m1), p1), p3);
      if (bf16) {
        a = to_bf16(a);
        p = to_bf16(p);
      }
    }
    planes[e] = make_float2(a, p);
  }
  __syncthreads();

  const int m = tid % kModels;
  if (m >= M) return;                   // no later barrier
  const uint8_t* my_shift = shift + m;
  for (int x = tid / kModels; x < kTile; x += kGroups) {
    const int n_here = count[x];
    if (n_here == 0) continue;
    float ss[kLags], pw[kLags];
#pragma unroll
    for (int w = 0; w < kLags; ++w) {
      ss[w] = 0.f;
      pw[w] = 0.f;
    }
    // staged column of window column t0 + x + d is x + (d - kDMin)
    const float2* base = planes + x;
#pragma unroll 2
    for (int k = 0; k < kSym; ++k) {
      const float g = sgn[k];
      const float2* q = base + 2 * k * kCols + my_shift[k * M];
#pragma unroll
      for (int w = 0; w < kLags; ++w) {
        const float2 v = q[w * kCols];
        ss[w] = __fmaf_rn(g, v.x, ss[w]);
        pw[w] = __fadd_rn(pw[w], v.y);
      }
    }
#pragma unroll
    for (int w = 0; w < kLags; ++w) ss[w] = __fdiv_rn(ss[w], pw[w]);
    for (int i = 0; i < n_here; ++i) {
      const size_t slot = static_cast<size_t>(b) * n_slots +
                          slots[start[x] + i];
      float* o = out + slot * kLags * M + m;
#pragma unroll
      for (int w = 0; w < kLags; ++w) o[w * M] = ss[w];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block at n_slots candidate slots a window
// and M models, in bytes.
int uwspr_sync_grid_smem(int n_slots, int M) {
  return static_cast<int>(smem_bytes(n_slots, M));
}

// ps: (W, n, size) f32 power spectra, n >= 348; ifr: (W, n_slots) int32
// window columns in [0, width), n_slots = 5 C; offT: (162, M) u8 shifts
// offs[m, k] - (-6), each in [0, 12]; sign: (162,) f32 +-1; out: (W,
// n_slots, 26, M) f32, written. The window's columns are the spectrum's
// [lo, lo + width); bf16 != 0 rounds the planes to bf16. Launches on
// `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue without launching for shapes it does not take).
int uwspr_sync_grid(const float* ps, int W, int n, int size, int lo,
                    int width, const int32_t* ifr, int n_slots,
                    const uint8_t* offT, int M, const float* sign, int bf16,
                    float* out, void* stream) {
  const size_t smem = smem_bytes(n_slots, M);
  if (n < kRows || M < 1 || M > kModels || width < 1 || lo < 0 ||
      lo + width > size || W > 65535 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 48 * 1024;   // the attribute is set once per size
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        sync_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  if (W > 0 && n_slots > 0) {
    const dim3 blocks((width + kTile - 1) / kTile, W);
    sync_grid_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        ps, n, size, lo, width, ifr, n_slots, offT, M, sign, bf16, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
