// Fused STFT power on the tensor cores: frame build + half-sine window +
// DFT as one bf16 GEMM with f32 sums (mma.sync m16n8k16) + |.|^2 in
// registers; frames never reach device memory.
//
// Replaces: uwspr_tpu/ops/stft_pallas.py::stft_power_pallas (kernel
// `_kernel`, stft_pallas.py:56-77) and keeps the numerics of its plain twin
// ops/stft.py impl "matmul_bf16":
//
//   fr[i, j] = bf16(Re z[i*hop + j] * w[j]),  fi likewise (product in f32),
//   re[i, c] = sum_j fr*C[j, c] - sum_j fi*S[j, c],
//   im[i, c] = sum_j fr*S[j, c] + sum_j fi*C[j, c],
//   out[i, c] = re^2 + im^2,
//
// with C, S the cos/sin DFT matrices (fftshift folded in) rounded to bf16
// and restricted to the caller's column window. Samples at or past fl read
// as zero. A bf16 x bf16 product is exact in f32, so kernel and plain
// version differ only in the order of the f32 sums.
//
// The GEMM: D = A . B with A = [fr | fi] (rows are frames, K = 2*size) and
// B = [[C, S], [-S, C]], its columns interleaved as (re, im) pairs of each
// output column, so that the two accumulators c0, c1 (and c2, c3) that an
// mma fragment gives a thread are re and im of one output column and the
// power is formed in registers and written once. K is taken in k16 steps of
// 8 samples each: k 0..7 are the real parts of samples 8s..8s+7, k 8..15
// their imaginary parts (a permutation of K that changes no product). Then
// one 16-byte shared-memory load of two complex samples gives a thread both
// its real (a0/a1) and its imaginary (a2/a3) A-fragment registers.
//
// B is built once per decoder (ops/stft.py::dft_fragments) directly in the
// fragment order [n-block][k16 step][n8 tile][lane] of uint2 (b0, b1), so a
// warp reads each fragment as one coalesced 256-byte row.
//
// What bounds it on the card: at the device decoder's 48-column window the
// input (46 MB for 128 windows) on HBM and 8.8 GFLOP of bf16 products; at
// full width 93 GFLOP on the tensor cores.
//
// What the design does about it: a block owns kFrames = 64 consecutive
// frames of one window and NT n8 tiles (up to 128 GEMM columns). It stages
// the frames' (64 - 1) * hop + size samples once in shared memory, with 8
// float2 of padding after every 128 samples so the A-fragment loads of a
// warp hit distinct banks. Its 8 warps form a 4 x 2 grid: each owns 16
// frames and half of the block's n8 tiles, and builds its A fragments in
// registers from the staged samples (window product and bf16 rounding as
// in the plain version). B streams through shared memory in stages of
// kChunkSteps k16 steps with cp.async, double-buffered. Two warps per 16
// frames, each with half the columns, give 8 warps per block, twice the
// warps per SM of one warp per 16 frames at the same shared memory.
//
// Build: nvcc without --use_fast_math; the window products and bf16
// roundings are explicit round-to-nearest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 64;            // frames (GEMM rows) per block
constexpr int kWarpsM = kFrames / 16;  // warps along the frames (one m16 each)
constexpr int kWarpsN = 2;             // warps sharing each m16 row tile
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kChunkSteps = 4;         // k16 steps per B stage
constexpr int kGroup = 128;            // samples between padding gaps
constexpr int kGap = 8;                // float2 of padding per group
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ __forceinline__ int padded(int e) {
  return e + (e / kGroup) * kGap;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one block: padded samples, then two B stages.
__host__ __device__ __forceinline__ int sample_slots(int size, int hop) {
  const int span = (kFrames - 1) * hop + size;
  return (padded(span - 1) + 2) & ~1;     // float2, rounded to 16 bytes
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
stft_power_mma(const float2* __restrict__ z, int fl, int n_ffts, int size,
               int hop, const float* __restrict__ window,
               const uint2* __restrict__ bfrag, int ncols,
               float* __restrict__ out) {
  constexpr int kStage = kChunkSteps * NT * 32;     // uint2 per B stage
  constexpr int kTiles = NT / kWarpsN;              // n8 tiles per warp
  extern __shared__ __align__(16) float2 samples[];
  uint2* bbuf = reinterpret_cast<uint2*>(samples + sample_slots(size, hop));

  const int frame0 = blockIdx.x * kFrames;
  const int nb = blockIdx.y;
  const int w = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) % kWarpsM;   // m16 row tile
  const int nw = (tid >> 5) / kWarpsM;     // this warp's kTiles n8 tiles
  const int lane = tid & 31;
  const int g = lane >> 2;           // fragment row (and B column) in tile
  const int t = lane & 3;            // fragment k pair / accumulator pair
  const int steps = size / 8;
  const uint2* bsrc = bfrag + static_cast<size_t>(nb) * steps * NT * 32;

  auto load_stage = [&](int chunk, int buf) {
    const uint2* src = bsrc + static_cast<size_t>(chunk) * kStage;
    uint2* dst = bbuf + buf * kStage;
    for (int e = 2 * tid; e < kStage; e += 2 * kThreads)
      cp_async16(dst + e, src + e);
    cp_async_commit();
  };
  load_stage(0, 0);

  const float2* zw = z + static_cast<size_t>(w) * fl;
  const int span = (kFrames - 1) * hop + size;
  const int s0 = frame0 * hop;
  for (int e = tid; e < span; e += kThreads) {
    const int n = s0 + e;
    samples[padded(e)] = n < fl ? zw[n] : make_float2(0.f, 0.f);
  }

  float acc[kTiles][4];
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int row = warp * 16 + g;     // block-local frame of c0/c1
  const int e0 = row * hop;          // its first sample; row + 8: c2/c3
  const int e1 = (row + 8) * hop;
  const int nchunks = steps / kChunkSteps;
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      load_stage(ch + 1, (ch + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                 // stage ch (and the samples) visible
    const uint2* bs = bbuf + (ch & 1) * kStage;
#pragma unroll
    for (int ks = 0; ks < kChunkSteps; ++ks) {
      const int j = (ch * kChunkSteps + ks) * 8 + 2 * t;
      const float w0 = __ldg(window + j);
      const float w1 = __ldg(window + j + 1);
      const float4 x0 =
          *reinterpret_cast<const float4*>(samples + padded(e0 + j));
      const float4 x1 =
          *reinterpret_cast<const float4*>(samples + padded(e1 + j));
      uint32_t a[4];
      a[0] = pack_bf16(__fmul_rn(x0.x, w0), __fmul_rn(x0.z, w1));  // re, g
      a[1] = pack_bf16(__fmul_rn(x1.x, w0), __fmul_rn(x1.z, w1));  // re, g+8
      a[2] = pack_bf16(__fmul_rn(x0.y, w0), __fmul_rn(x0.w, w1));  // im, g
      a[3] = pack_bf16(__fmul_rn(x1.y, w0), __fmul_rn(x1.w, w1));  // im, g+8
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const uint2 b = bs[(ks * NT + nw * kTiles + nt) * 32 + lane];
        mma_bf16(acc[nt], a, b.x, b.y);
      }
    }
    __syncthreads();                 // stage ch consumed before reuse
  }

  const int fa = frame0 + row;
  const int fb = fa + 8;
  float* ow = out + static_cast<size_t>(w) * n_ffts * ncols;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    const int col = (nb * NT + nw * kTiles + nt) * 4 + t;
    if (col < ncols) {
      if (fa < n_ffts)
        ow[static_cast<size_t>(fa) * ncols + col] =
            acc[nt][0] * acc[nt][0] + acc[nt][1] * acc[nt][1];
      if (fb < n_ffts)
        ow[static_cast<size_t>(fb) * ncols + col] =
            acc[nt][2] * acc[nt][2] + acc[nt][3] * acc[nt][3];
    }
  }
}

size_t smem_bytes(int size, int hop, int nt) {
  return sizeof(float2) * sample_slots(size, hop) +
         sizeof(uint2) * 2 * kChunkSteps * nt * 32;
}

template <int NT>
int launch(const float* z, int B, int fl, int n_ffts, int size, int hop,
           const float* window, const uint16_t* bfrag, int n_blocks,
           int ncols, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(size, hop, NT);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 0;      // the attribute is set once per size
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        stft_power_mma<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const dim3 blocks((n_ffts + kFrames - 1) / kFrames, n_blocks, B);
  stft_power_mma<NT><<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const float2*>(z), fl, n_ffts, size, hop, window,
      reinterpret_cast<const uint2*>(bfrag), ncols, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int uwspr_stft_power_smem(int size, int hop, int nt) {
  return static_cast<int>(smem_bytes(size, hop, nt));
}

// z: (B, fl) complex64 as interleaved (re, im) f32 pairs; window: (size,)
// f32; bfrag: the B fragments (n_blocks, size/8, nt, 32, 4) bf16 of
// ops/stft.py::dft_fragments for the caller's column window; out:
// (B, n_ffts, ncols) f32, written. nt, the n8 tiles per block, is 4, 8, 12
// or 16. Launches on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue without launching for shapes the kernel does not
// take: size not a multiple of 32, odd hop, or too much shared memory).
int uwspr_stft_power(const float* z, int B, int fl, int n_ffts, int size,
                     int hop, const float* window, const uint16_t* bfrag,
                     int nt, int n_blocks, int ncols, float* out,
                     void* stream) {
  if (size < 32 || size % (8 * kChunkSteps) != 0 || hop < 2 || hop % 2 ||
      ncols < 1 || ncols > n_blocks * nt * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || n_ffts <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 4:
      return launch<4>(z, B, fl, n_ffts, size, hop, window, bfrag, n_blocks,
                       ncols, out, s);
    case 8:
      return launch<8>(z, B, fl, n_ffts, size, hop, window, bfrag, n_blocks,
                       ncols, out, s);
    case 12:
      return launch<12>(z, B, fl, n_ffts, size, hop, window, bfrag,
                        n_blocks, ncols, out, s);
    case 16:
      return launch<16>(z, B, fl, n_ffts, size, hop, window, bfrag,
                        n_blocks, ncols, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
