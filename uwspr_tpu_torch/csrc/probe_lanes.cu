// The served probe evaluation of the device engine's refinement, one
// launch a probe call for every lane:
//
//   p[d, l, i, g, m] = | sum_{k<256} z[d, l, i, b[l, g] + k]
//                                    * T[l, m, b[l, g] + k] |,
//
// for drift set d, lane l, symbol i, lag g and tone row m = 4 * freq + tone,
// where z is lane l's window, read at padded sample base[l] + off + 256 * i
// + j (0 <= j < width) of batch window widx[l] and derotated by the drift
// dsym[d, l, i], T the lane's tone bank (complex64, rounded to bf16 here)
// and b[l, g] = clamp(lags[l, g] + PAD - base[l] - off, 0, width - 256)
// the lag's offset into the window. The arithmetic is that of the plain
// chain at probe dtype "bf16" (demod/finesync.py: make_shared_probe_lanes,
// the slice, probe_derotate, shared_probe_eval's masked bank and four
// f32 products), rounding for rounding; probe_lane.cuh says where.
//
// Replaces no Pallas kernel: the JAX package runs these probes as XLA
// einsums (uwspr_tpu/demod/finesync.py:394-459), and the port ran them as
// a chain of library operators that materialised each lane's (2, 162,
// width) window, its derotated copy and a masked f32 bank over the whole
// width, then four f32 GEMMs of which 60% multiply by the mask's zeros.
//
// What bounds it on the card: the multiply-adds, 4 a sample of each of the
// 256 samples of a probe (1,024 a tone power), 45.8 M a lane over a decode's
// four calls, on the CUDA cores (f32 FMA). The reads are each lane's window
// once a block and its bank; nothing but p is written.
//
// What the design does about it: a block owns one lane and a tile of S
// symbols (24, 27 or 28: 6 or 7 tiles cover the 162), for every drift set
// of the call. It stages in shared memory, as packed bf16 pairs, the lane's
// bank and the tile's derotated samples over the columns its lags reach:
// each window sample is read once from the batch (kU samples in flight a
// thread), rounded, and derotated once a drift set on packed bf16 pairs,
// the phasor factors from a per-row table of 64 + width/64 values. A
// thread owns one lag, one freq, all four tones and kSt rows (a drift
// set's symbol), and keeps their 16 * kSt sums in registers: each pair it
// loads from shared memory feeds 4 * kSt or 16 multiply-adds. Every probe
// sums exactly its 256 live samples, from its own offset b, in ascending
// order. The threads of a lag are padded to a power of two, so a warp
// shares one lag's offset (or, at one freq, holds two lags), and rows
// padded to 1 mod 32 words spread a warp's loads over the banks. The
// tiling is picked here (tiling()), the shared memory sized from `span`,
// the largest spread of one lane's lags that the caller promises.
//
// Build: nvcc without --use_fast_math (cosf/sinf with full range
// reduction, as torch.cos and torch.sin on the card; IEEE square roots).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "probe_lane.cuh"

namespace {

using namespace uwspr_probe;

constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxLags = 32;
constexpr int kMaxF = 8;
constexpr int kMinThreads = 128;
constexpr int kU = 4;              // staged loads in flight a thread
constexpr int kMaxD = 2;           // drift sets a call, at most
constexpr int kMaxRows = 64;       // rows (drift sets x symbols) a tile

struct Tiling {
  int st;       // rows a thread (kStMany, or 1 for one probe a symbol)
  int groups;   // row groups a block: D * S = groups * st
  int tpl;      // threads a lag, a power of two
  int threads;
  int tiles;    // symbol tiles a lane
  int row;      // shared row stride, words (1 mod 32)
  int smem;     // dynamic shared memory, bytes
};

__host__ __device__ int next_pow2(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

constexpr int kStMany = 4;         // symbols a thread, many probes a symbol

// S symbols a tile (every drift set's), groups = D * S / st row groups a
// block (a row is a drift set's symbol)
Tiling tiling(int NL, int F, int D, int width, int span) {
  Tiling t;
  t.st = (NL * F == 1) ? 1 : kStMany;
  const int S = t.st == 1 ? 27 : (F > 1 ? 24 : 28);  // 6 or 7 tiles
  t.groups = D * S / t.st;
  t.tpl = next_pow2(t.groups * F);
  t.threads = NL * t.tpl < kMinThreads ? kMinThreads : NL * t.tpl;
  t.tiles = (kNSym + S - 1) / S;
  const int cols = span + kSym < width ? span + kSym : width;
  t.row = (cols + 31) / 32 * 32 + 1;
  const int nv = width / 64;
  t.smem = static_cast<int>(sizeof(uint32_t)) *
           ((D * S + kTones * F) * t.row + D * S * (64 + nv));
  return t;
}

struct Args {
  const float* ri;          // (W, 2, N) f32
  int N;
  const long long* widx;    // (L,)
  const long long* base;    // (L,) padded start of the width-640 window
  int off;                  // the call's first column of it
  int width;                // its width, a multiple of 64
  const float* dsym;        // (D, L, 162) Hz
  int D;
  float phase;              // -2 pi / fs, f32
  int L;
  const float2* bank;       // (L, 4F, width) complex64
  int F;
  const long long* lags;    // (L, NL)
  int NL;
  float* out;               // (D, L, 162, NL, 4F)
};

template <int kSt>
__global__ void probe_lanes_kernel(Args a, int groups, int tpl, int row) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int l = blockIdx.x;
  const int R = groups * kSt;           // rows: D drift sets x S symbols
  const int S = R / a.D;
  const int i0 = blockIdx.y * S;
  const int M = kTones * a.F;
  const int nv = a.width / 64;
  const int T = blockDim.x;
  uint32_t* zs = smem;                  // [R][row] derotated (zr, zi)
  uint32_t* bs = zs + R * row;          // [M][row] bank (br, bi)
  uint32_t* ut = bs + M * row;          // [R][64] factors (ur, ui)
  uint32_t* vt = ut + R * 64;           // [R][nv] factors (vr, vi)
  __shared__ int offs[kMaxLags];        // each lag's offset b
  __shared__ float theta[kMaxRows];     // each row's phase step
  const int tid = threadIdx.x;
  const long long base = a.base[l] + a.off;
  if (tid < a.NL)
    offs[tid] = lag_offset(a.lags[static_cast<size_t>(l) * a.NL + tid],
                           base, a.width);
  if (tid < R) {
    const int d = tid / S;
    const int i = i0 + tid - d * S;
    theta[tid] = i < kNSym
        ? __fmul_rn(a.phase,
                    a.dsym[(static_cast<size_t>(d) * a.L + l) * kNSym + i])
        : 0.f;
  }
  __syncthreads();

  // the columns the lags reach: [lo, hi)
  int lo = a.width, hi = 0;
  for (int g = 0; g < a.NL; ++g) {
    lo = min(lo, offs[g]);
    hi = max(hi, offs[g] + kSym);
  }
  hi = min(hi, lo + row - 1);           // a spread beyond `span`: see below
  const int cols = hi - lo;

  // per-row factor tables (_phasor_ramp_ri)
  for (int e = tid; e < R * (64 + nv); e += T) {
    const int r = e / (64 + nv);
    const int c = e - r * (64 + nv);
    const float ang = __fmul_rn(theta[r], c < 64 ? static_cast<float>(c)
                                                 : 64.f * (c - 64));
    const uint32_t w = pack_bf16x2(cosf(ang), sinf(ang));
    if (c < 64)
      ut[r * 64 + c] = w;
    else
      vt[r * nv + c - 64] = w;
  }
  // the bank over [lo, hi), kU rows at a time
  const float2* __restrict__ bk =
      a.bank + static_cast<size_t>(l) * M * a.width + lo;
  for (int m0 = 0; m0 < M; m0 += kU)
    for (int jj = tid; jj < cols; jj += T) {
      float2 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) v[u] = __ldg(bk + (m0 + u) * a.width + jj);
#pragma unroll
      for (int u = 0; u < kU; ++u)
        bs[(m0 + u) * row + jj] = pack_bf16x2(v[u].x, v[u].y);
    }
  __syncthreads();
  // the tile's samples over [lo, hi), kU symbols at a time, each read once
  // and derotated once a drift set
  const float* __restrict__ zre =
      a.ri + static_cast<size_t>(a.widx[l]) * 2 * a.N;
  const float* __restrict__ zim = zre + a.N;
  const long long o = base - kPad + static_cast<long long>(kSym) * i0 + lo;
  for (int s0 = 0; s0 < S; s0 += kU)
    for (int jj = tid; jj < cols; jj += T) {
      uint32_t av[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int s = s0 + u;
        const long long n = o + static_cast<long long>(kSym) * s + jj;
        const bool in = s < S && i0 + s < kNSym && n >= 1 && n < a.N;
        const long long nc = in ? n : 0;          // every load in bounds
        const float re = __ldg(zre + nc);
        const float im = __ldg(zim + nc);
        av[u] = in ? pack_bf16x2(re, im) : 0u;
      }
      const int j = lo + jj;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (s0 + u >= S) break;
        for (int r = s0 + u; r < R; r += S)
          zs[r * row + jj] = derotate(av[u], ut[r * 64 + (j & 63)],
                                      vt[r * nv + (j >> 6)]);
      }
    }
  __syncthreads();

  // this thread's probes: lag g, freq f, rows q0 + groups * q
  const int g = tid / tpl;
  const int rem = tid - g * tpl;
  if (g >= a.NL || rem >= groups * a.F) return;
  const int f = rem / groups;
  const int q0 = rem - f * groups;
  const int b = offs[g];
  // a lane whose lags spread wider than the caller's span: its far lags
  // were not staged, and read NaN rather than another lag's samples
  const bool staged = b + kSym <= hi;
  const uint32_t* zp = zs + q0 * row + (b - lo);
  const uint32_t* bp = bs + (kTones * f) * row + (b - lo);
  const int zq = groups * row;
  float acc[kSt][kTones][4];
#pragma unroll
  for (int q = 0; q < kSt; ++q)
#pragma unroll
    for (int t = 0; t < kTones; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][t][c] = 0.f;
  if (staged) {
#pragma unroll 2
    for (int k = 0; k < kSym; ++k) {
      float zr[kSt], zi[kSt], br[kTones], bi[kTones];
#pragma unroll
      for (int q = 0; q < kSt; ++q) {
        const uint32_t w = zp[q * zq + k];
        zr[q] = lo_of(w);
        zi[q] = hi_of(w);
      }
#pragma unroll
      for (int t = 0; t < kTones; ++t) {
        const uint32_t w = bp[t * row + k];
        br[t] = lo_of(w);
        bi[t] = hi_of(w);
      }
#pragma unroll
      for (int q = 0; q < kSt; ++q)
#pragma unroll
        for (int t = 0; t < kTones; ++t) {
          acc[q][t][0] = mac(acc[q][t][0], zr[q], br[t]);
          acc[q][t][1] = mac(acc[q][t][1], zi[q], bi[t]);
          acc[q][t][2] = mac(acc[q][t][2], zr[q], bi[t]);
          acc[q][t][3] = mac(acc[q][t][3], zi[q], br[t]);
        }
    }
  }
#pragma unroll
  for (int q = 0; q < kSt; ++q) {
    const int r = q0 + groups * q;
    const int d = r / S;
    const int i = i0 + r - d * S;
    if (i >= kNSym) continue;
    float4 v;
    if (staged) {
      v.x = power(acc[q][0][0], acc[q][0][1], acc[q][0][2], acc[q][0][3]);
      v.y = power(acc[q][1][0], acc[q][1][1], acc[q][1][2], acc[q][1][3]);
      v.z = power(acc[q][2][0], acc[q][2][1], acc[q][2][2], acc[q][2][3]);
      v.w = power(acc[q][3][0], acc[q][3][1], acc[q][3][2], acc[q][3][3]);
    } else {
      v.x = v.y = v.z = v.w = __int_as_float(0x7FC00000);
    }
    const size_t lane = static_cast<size_t>(d) * a.L + l;
    *reinterpret_cast<float4*>(
        a.out + ((lane * kNSym + i) * a.NL + g) * M + kTones * f) = v;
  }
}

template <int kSt>
cudaError_t launch(const Args& a, const Tiling& t, cudaStream_t stream) {
  static int granted = 48 * 1024;     // the attribute is set once per size
  if (t.smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_lanes_kernel<kSt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        t.smem);
    if (e != cudaSuccess) return e;
    granted = t.smem;
  }
  if (a.L > 0) {
    const dim3 blocks(a.L, t.tiles);
    probe_lanes_kernel<kSt><<<blocks, t.threads, t.smem, stream>>>(
        a, t.groups, t.tpl, t.row);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiling of a call of NL lags and F freqs over a width-column window
// whose lags spread at most `span` columns: out = {symbols a thread,
// symbol groups a tile, threads a lag, threads a block, tiles a lane,
// shared row stride in words, dynamic shared memory in bytes}; returns 0.
int uwspr_probe_lanes_tiling(int NL, int F, int D, int width, int span,
                             int* out) {
  const Tiling t = tiling(NL, F, D, width, span);
  out[0] = t.st;
  out[1] = t.groups;
  out[2] = t.tpl;
  out[3] = t.threads;
  out[4] = t.tiles;
  out[5] = t.row;
  out[6] = t.smem;
  return 0;
}

// ri: (W, 2, N) f32; widx, base: (L,) int64; dsym: (D, L, 162) f32;
// bank: (L, 4F, width) complex64; lags: (L, NL) int64; out: (D, L, 162,
// NL, 4F) f32, 16-byte aligned, written. width is a multiple of 64 with
// off + width <= 640 + off's window; span >= 0 bounds max - min of every
// lane's lags (a lane beyond it reads NaN at its far lags). Launches on
// `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue without launching for a shape it does not take).
int uwspr_probe_lanes(const float* ri, int N, const long long* widx,
                      const long long* base, int off, int width,
                      const float* dsym, int D, int L, float phase,
                      const void* bank, int F, const long long* lags,
                      int NL, int span, float* out, void* stream) {
  if (NL < 1 || NL > kMaxLags || F < 1 || F > kMaxF || width < kSym ||
      width % 64 || span < 0 || D < 1 || D > kMaxD || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tiling t = tiling(NL, F, D, width, span);
  if (t.smem > kMaxSmem || t.threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.ri = ri;
  a.N = N;
  a.widx = widx;
  a.base = base;
  a.off = off;
  a.width = width;
  a.dsym = dsym;
  a.D = D;
  a.phase = phase;
  a.L = L;
  a.bank = static_cast<const float2*>(bank);
  a.F = F;
  a.lags = lags;
  a.NL = NL;
  a.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = t.st == 1 ? launch<1>(a, t, s)
                                  : launch<kStMany>(a, t, s);
  return static_cast<int>(e);
}

}  // extern "C"
