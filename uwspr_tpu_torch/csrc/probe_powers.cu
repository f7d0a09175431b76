// Probe tone powers |corr| for every (candidate, freq, lag, symbol, tone),
// with the derotated window and the tone bank shared by all lags.
//
// Replaces: uwspr_tpu/ops/probe_pallas.py::probe_powers_pallas (kernel
// `_probe_kernel`, probe_pallas.py:48-119), with the semantics of its XLA
// twin demod/finesync.py::_probe_powers_xla (finesync.py:103-154):
//
//   p[c, f, l, i, t] = | sum_{k<256} zd[c, i, b[c, l] + k]
//                                    * T[c, f, t, b[c, l] + k] |,
//   zd[c, i, j'] = zp(o[c] + 256*i + j') * e^{i a_d},   (0 outside
//                  1 <= n < N, the reference's 0 < n < N guard)
//   T[c, f, t, j'] = e^{i a_b},
//   a_d = (phase * drift[c, i]) * j',
//   a_b = (phase * (freq[c, f] + tone_t)) * j',   phase = -2*pi/fs in f32,
//
// where o[c] = base[c] - PAD, base[c] is the candidate's 256-aligned window
// start and b[c, l] each lag's offset into that window, clipped as the JAX
// wrapper clips them (ops/probe.py::lag_offsets, finesync.py:127-130); the
// block computes them from the lags itself, so a call is one launch.
// Neither the derotated window zd nor the bank T depends on the lag, and T
// not on the symbol: both are built once per block and every lag reads its
// 256-wide slice [b, b + 256) of them. Every angle is the same f32 product
// as in the plain version, so the two differ only in the order of the
// 256-term sums and in sincosf against torch's cos/sin.
//
// What bounds it on the card: the complex multiply-adds, 256 per output
// (2.3 G f32 FMA on the host engine's 17-jiggle call), on the CUDA cores;
// reads are the window (0.36 MB) and small tables, the output is written
// once.
//
// What the design does about it: a block owns one candidate and a tile of
// S symbols, all L lags and all F freqs. It walks the span of window
// indices its lags reach, [min b, max b + 256), in chunks of kWc: for each
// chunk it builds the derotated samples of its S symbols and the 4F-tone
// bank in shared memory (one sincosf each; the lag-independent angles are
// no longer recomputed per lag), then every thread adds the chunk's part of
// its lag's slice to 8 accumulators: 2 symbols x 4 tones of one (lag,
// freq), so each derotated sample loaded from shared memory feeds 4
// complex products and each bank value (the same address across a warp
// that shares the lag) 2; the bank keeps a sample's 4 tones together, so
// they come in two 16-byte loads. Threads are ordered (lag, freq, symbol) with the
// symbol fastest, so a warp mostly shares one lag's loop bounds. Rows are
// padded by one element against bank conflicts. The wrapper picks S and
// the block size (ops/probe.py::kernel_tiling).
//
// Build: nvcc without --use_fast_math, so sincosf keeps full range reduction.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSym = 256;          // samples per symbol
constexpr int kNSym = 162;         // symbols per frame
constexpr int kWc = 128;           // window indices per shared-memory chunk
constexpr int kRow = kWc + 1;      // padded row stride (float2 elements)
constexpr int kMaxF = 16;          // probe freqs per candidate, at most
constexpr int kPad = 4096;         // zeros in front of the window
constexpr int kWin = 1024;         // aligned window covering every lag
constexpr int kMaxSmem = 227 * 1024;

// tone offsets in Hz: (t - 1.5) * 375/256, exact in f32
__device__ __forceinline__ float tone_hz(int t) {
  return (static_cast<float>(t) - 1.5f) * 1.46484375f;
}

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 w) {
  acc.x += a.x * w.x - a.y * w.y;
  acc.y += a.x * w.y + a.y * w.x;
}

// lag + PAD clipped to the padded window, as ops/probe.py::lag_offsets
__device__ __forceinline__ long long lag_start(int32_t lag, int N) {
  return min(max(static_cast<long long>(lag) + kPad, 0LL),
             static_cast<long long>(kPad) + N);
}

__device__ __forceinline__ int lag_offset(long long start, long long base) {
  return static_cast<int>(min(max(start - base, 0LL),
                              static_cast<long long>(kWin - kSym)));
}

__global__ void probe_powers_kernel(const float* __restrict__ z, int N,
                                    const int32_t* __restrict__ lags,
                                    const float* __restrict__ freqs,
                                    const float* __restrict__ drift,
                                    int L, int F, int S, float phase,
                                    float* __restrict__ out) {
  extern __shared__ __align__(16) float2 smem[];
  float2* zd = smem;                 // [S][kRow] derotated samples
  float2* bank = smem + S * kRow;    // [F][kRow][4] tone bank, tones last
  __shared__ long long base;
  __shared__ int span_lo, span_hi;
  const int c = blockIdx.x;
  const int i0 = blockIdx.y * S;
  const int tid = threadIdx.x;
  const int nm = 4 * F;
  const int half = S / 2;
  const int32_t* lc = lags + static_cast<size_t>(c) * L;
  if (tid == 0) {
    long long first = LLONG_MAX;
    for (int l = 0; l < L; ++l) first = min(first, lag_start(lc[l], N));
    const long long n_padded = static_cast<long long>(N) + 2 * kPad + kWin;
    const long long bs = min(first / kSym * kSym,
                             n_padded - (kNSym * kSym + kWin));
    int lo = INT_MAX, hi = INT_MIN;
    for (int l = 0; l < L; ++l) {
      const int b = lag_offset(lag_start(lc[l], N), bs);
      lo = min(lo, b);
      hi = max(hi, b);
    }
    base = bs;
    span_lo = lo;
    span_hi = hi + kSym;
  }
  // this thread's outputs: lag l, freq f, symbols s and s + half, 4 tones
  const bool active = tid < L * F * half;
  const int s = tid % half;
  const int lf = tid / half;
  const int f = active ? lf % F : 0;
  const int l = lf / F;
  float2 acc[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[q][t] = make_float2(0.f, 0.f);
  __syncthreads();
  const int b = active ? lag_offset(lag_start(lc[l], N), base) : 0;
  const int o = static_cast<int>(base - kPad);
  const int lo = span_lo;
  const int hi = span_hi;
  for (int jlo = lo; jlo < hi; jlo += kWc) {
    for (int e = tid; e < S * kWc; e += blockDim.x) {
      const int ss = e / kWc;
      const int jj = e - ss * kWc;
      const int ii = i0 + ss;
      const int j = jlo + jj;
      float2 v = make_float2(0.f, 0.f);
      if (ii < kNSym) {
        const int n = o + kSym * ii + j;
        if (n >= 1 && n < N) {
          const float zr = z[n];
          const float zi = z[N + n];
          const float ang = __fmul_rn(__fmul_rn(phase, drift[c * kNSym + ii]),
                                      static_cast<float>(j));
          float sn, cs;
          sincosf(ang, &sn, &cs);
          v.x = __fsub_rn(__fmul_rn(zr, cs), __fmul_rn(zi, sn));
          v.y = __fadd_rn(__fmul_rn(zr, sn), __fmul_rn(zi, cs));
        }
      }
      zd[ss * kRow + jj] = v;
    }
    for (int e = tid; e < nm * kWc; e += blockDim.x) {
      const int mm = e / kWc;
      const int jj = e - mm * kWc;
      const float ft = __fadd_rn(freqs[c * F + (mm >> 2)], tone_hz(mm & 3));
      const float ang = __fmul_rn(__fmul_rn(phase, ft),
                                  static_cast<float>(jlo + jj));
      float sn, cs;
      sincosf(ang, &sn, &cs);
      bank[((mm >> 2) * kRow + jj) * 4 + (mm & 3)] = make_float2(cs, sn);
    }
    __syncthreads();
    if (active) {
      const int k0 = max(b, jlo) - jlo;
      const int k1 = min(b + kSym, jlo + kWc) - jlo;
      const float2* z0 = zd + s * kRow;
      const float2* z1 = zd + (s + half) * kRow;
      const float4* bk = reinterpret_cast<const float4*>(bank) +
                         2 * f * kRow;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float2 a0 = z0[k];
        const float2 a1 = z1[k];
        const float4 w01 = bk[2 * k];          // tones 0 and 1
        const float4 w23 = bk[2 * k + 1];      // tones 2 and 3
        const float2 w[4] = {make_float2(w01.x, w01.y),
                             make_float2(w01.z, w01.w),
                             make_float2(w23.x, w23.y),
                             make_float2(w23.z, w23.w)};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          cmac(acc[0][t], a0, w[t]);
          cmac(acc[1][t], a1, w[t]);
        }
      }
    }
    __syncthreads();                 // chunk consumed before the next fill
  }
  if (!active) return;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = i0 + s + q * half;
    if (i < kNSym) {
      float4 v;
      v.x = sqrtf(acc[q][0].x * acc[q][0].x + acc[q][0].y * acc[q][0].y);
      v.y = sqrtf(acc[q][1].x * acc[q][1].x + acc[q][1].y * acc[q][1].y);
      v.z = sqrtf(acc[q][2].x * acc[q][2].x + acc[q][2].y * acc[q][2].y);
      v.w = sqrtf(acc[q][3].x * acc[q][3].x + acc[q][3].y * acc[q][3].y);
      *reinterpret_cast<float4*>(
          out + ((static_cast<size_t>(c * F + f) * L + l) * kNSym + i) * 4) =
          v;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of S symbols and F freqs, in bytes.
int uwspr_probe_powers_smem(int S, int F) {
  return static_cast<int>(sizeof(float2) * static_cast<size_t>(S + 4 * F) *
                          kRow);
}

// z: (2, N) f32 real/imag planes; lags: (C, L) int32 window-relative
// lags; freqs: (C, F) f32;
// drift: (C, 162) f32; out: (C, F, L, 162, 4) f32, 16-byte aligned,
// written. S (even, symbols per block) and threads come from
// ops/probe.py::kernel_tiling; threads must cover L * F * S / 2. Launches
// on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue without launching for a tiling it does not take).
int uwspr_probe_powers(const float* z, int N, const int32_t* lags,
                       const float* freqs,
                       const float* drift, int C, int L, int F, int S,
                       int threads, float phase, float* out, void* stream) {
  const size_t smem = uwspr_probe_powers_smem(S, F);
  if (F < 1 || F > kMaxF || L < 1 || S < 2 || S % 2 || threads > 1024 ||
      threads < L * F * (S / 2) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 48 * 1024;   // the attribute is set once per size
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_powers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  if (C > 0) {
    const dim3 blocks(C, (kNSym + S - 1) / S);
    probe_powers_kernel<<<blocks, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        z, N, lags, freqs, drift, L, F, S, phase, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
