// Exact order-dependent drift-model selection, one block per candidate lane.
//
// Replaces: uwspr_tpu/ops/select_pallas.py::select_best_pallas (kernel
// `_kernel`, select_pallas.py:42-116), the reference's sequential best-model
// walk (FDR_impl.cc:344-405): over the (freq, lag, model) grid in order, a
// linear model accepts when v > best, a nonlinear one when v / best > thr
// (IEEE f32 division), NaN never accepts; best starts at -1e30.
//
// What bounds it on the card: reading the grid. Each lane owns a
// (G = 130, M = 126) f32 block (65.5 KB); at the device engine's 1,664
// lanes the launch reads 109 MB once, so the floor is the HBM read (about
// 33 us at 3.35 TB/s). The ordered walk itself is short: a lane accepts in
// a few of its 130 groups, but each accept depends on the one before.
//
// What the design does about it, in two phases per lane, run at once by
// different warps of the lane's block:
//  1. Extremes at the HBM rate. Four warps stream the lane's groups, warp
//     w taking every fourth group, four groups' rows loaded ahead of their
//     reductions, and build a per-group table in shared memory: linear max,
//     nonlinear max and min (NaN excluded by fmaxf/fminf; the group holds a
//     nonlinear value iff min <= max). Each entry is published with a
//     ready flag; the groups fill in order, 16 per round. The model bank
//     is a register bitmask (thread t owns models t + 32c). Four streaming
//     warps beat eight on the device engine's grid, where the fewer warps
//     let more lanes share an SM (PERF.md).
//  2. The walk, by one more warp, which follows phase 1 through the table
//     instead of waiting for it, and reads the rows while they are still
//     in L2. f32 division is monotone in the numerator for a fixed
//     denominator, so a group whose extremes cannot accept against the
//     running best holds no accept at all. One ballot tests 32 groups
//     against the current best and __ffs gives the next group that can
//     accept; skipped rows are never read again. A walked group is resolved
//     32 models at a time: every model of a chunk at or after the scan
//     position is tested against the current best, and the ballot's first
//     set bit is exactly the scan's next accept (every model before it was
//     tested against the same best). Its value reaches the warp by shuffle,
//     the scan resumes after it, and no set bit moves to the next chunk. So
//     the result is the literal scan of search.py:360-390 by construction,
//     for any model order, and a walked group costs (chunks + accepts)
//     ballot rounds. The ballot that finds a group also prefetches into L1
//     the rows of the other groups that can accept under the current best.
//
// The nonlinear test needs no division: for each best the walk holds the
// exact bounds of the v that pass (nl_bounds below), so every test is one
// or two float compares.
//
// Build: nvcc without --use_fast_math: subnormals, the directed double to
// float conversions and IEEE compares must stay.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNW = 4;     // streaming warps per lane; the walk has one more
constexpr int kNC = 4;     // chunks of 32 models: M <= 128
constexpr int kAhead = 4;  // groups whose rows a warp loads before reducing
// the walk prefetches the rows of the groups that can accept when at most
// this many of a ballot's 32 can (at the start every group can)
constexpr int kPrefetchMax = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The nonlinear test fl(v / best) > T without a division. With `mid` the
// midpoint between T and the next float above it, rounding is monotone, so
// fl(x) > T iff x > mid, or x == mid and the tie rounds up (T's bit
// pattern odd: `tie_up`). For finite nonzero best, d = mid * best is exact
// in double (25 x 24 significant bits), and x > mid iff v > d (best > 0)
// or v < d (best < 0). So for a given best the accepted v form the set
// {a <= v <= c} or {v <= b}, with a or b the first float past d (or d
// itself on a tie that rounds up); a NaN bound is never met. best = +-0
// (v / best = +-inf or NaN) and best = +-inf (v / best = +-0 or NaN) are
// spelled out. Every lane of the warp holds the same bounds.
struct NlBounds {
  float a, b, c;
};

__device__ __forceinline__ bool nl_accepts(const NlBounds& n, float v) {
  return (v >= n.a && v <= n.c) || v <= n.b;
}

__device__ NlBounds nl_bounds(float best, double mid, bool tie_up) {
  NlBounds n{NAN, NAN, INFINITY};
  if (isnan(best)) return n;
  if (isinf(best)) {  // v / best = +-0 for finite v: above T iff T < 0
    if (mid < 0) {
      n.a = -FLT_MAX;
      n.c = FLT_MAX;
    }
    return n;
  }
  if (best == 0.0f) {  // v / best = +inf for v of best's sign, v != 0
    if (signbit(best))
      n.b = -__int_as_float(1);
    else
      n.a = __int_as_float(1);
    return n;
  }
  // d is finite and nonzero; a float f == d is finite and nonzero too, so
  // its neighbour is one step of its bit pattern
  const double d = mid * static_cast<double>(best);
  if (best > 0.0f) {
    float f = __double2float_ru(d);  // the least float >= d
    if (static_cast<double>(f) == d && !tie_up)
      f = __int_as_float(__float_as_int(f) + (f > 0.0f ? 1 : -1));
    n.a = f;
  } else {
    float f = __double2float_rd(d);  // the greatest float <= d
    if (static_cast<double>(f) == d && !tie_up)
      f = __int_as_float(__float_as_int(f) + (f > 0.0f ? -1 : 1));
    n.b = f;
  }
  return n;
}

// kNW streaming warps and one walking warp per lane.
__global__ void __launch_bounds__((kNW + 1) * kWarp)
select_best_kernel(const float* __restrict__ grid,
                   const uint8_t* __restrict__ is_nl, int G, int M,
                   double mid, int tie_up, float* __restrict__ best_out,
                   int32_t* __restrict__ idx_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [lmax G] [nmax G] [nmin G] [ready G ints]
  float* s_lmax = reinterpret_cast<float*>(smem);
  float* s_nmax = s_lmax + G;
  float* s_nmin = s_nmax + G;
  volatile int* s_ready = reinterpret_cast<volatile int*>(s_nmin + G);
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int l = blockIdx.x;
  const float* src = grid + static_cast<size_t>(l) * G * M;
  for (int g = threadIdx.x; g < G; g += blockDim.x) s_ready[g] = 0;
  __syncthreads();

  uint32_t nlbits = 0;  // bit c: model lane + 32c is nonlinear
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    const int m = lane + kWarp * c;
    if (m < M && is_nl[m]) nlbits |= 1u << c;
  }

  if (warp < kNW) {
    // Phase 1: the per-group extremes table, group g published by
    // s_ready[g]. Iteration i of the block covers groups
    // [i * kNW * kAhead, (i + 1) * kNW * kAhead), so they fill in order.
    for (int g0 = warp; g0 < G; g0 += kNW * kAhead) {
      float v[kAhead][kNC];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int g = g0 + u * kNW;
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const int m = lane + kWarp * c;
          v[u][c] = (g < G && m < M) ? src[static_cast<size_t>(g) * M + m]
                                     : NAN;
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        float lmax = -INFINITY, nmax = -INFINITY, nmin = INFINITY;
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const bool nl = (nlbits >> c) & 1u;
          lmax = fmaxf(lmax, nl ? -INFINITY : v[u][c]);
          nmax = fmaxf(nmax, nl ? v[u][c] : -INFINITY);
          nmin = fminf(nmin, nl ? v[u][c] : INFINITY);
        }
        lmax = warp_max(lmax);
        nmax = warp_max(nmax);
        nmin = warp_min(nmin);
        const int g = g0 + u * kNW;
        if (lane == 0 && g < G) {
          s_lmax[g] = lmax;
          s_nmax[g] = nmax;
          s_nmin[g] = nmin;
          __threadfence_block();
          s_ready[g] = 1;
        }
      }
    }
    return;
  }

  // Phase 2, by the last warp while phase 1 runs: the ordered walk over
  // the groups that can accept, each window of 32 groups once its table
  // entries are published.
  const volatile float* t_lmax = s_lmax;
  const volatile float* t_nmax = s_nmax;
  const volatile float* t_nmin = s_nmin;
  float best = -1e30f;
  NlBounds nb = nl_bounds(best, mid, tie_up != 0);
  int32_t bidx = 0;
  int g = 0;
  for (;;) {
    // the next group at or after g that can accept, 32 groups a ballot
    int next = G;
    for (int g0 = g; g0 < G; g0 += kWarp) {
      const int gg = g0 + lane;
      bool can = false;
      if (gg < G) {
        while (!s_ready[gg]) {
        }
        __threadfence_block();
        const float nmax = t_nmax[gg], nmin = t_nmin[gg];
        can = (t_lmax[gg] > best) ||
              (nmin <= nmax &&
               (nl_accepts(nb, nmax) || nl_accepts(nb, nmin)));
      }
      const unsigned hit = __ballot_sync(kFull, can);
      if (can && __popc(hit) <= kPrefetchMax) {
        // the rows the walk may read next, into L1 while it walks this one
        const char* r = reinterpret_cast<const char*>(
            src + static_cast<size_t>(gg) * M);
        for (int off = 0; off < M * 4; off += 128) prefetch_l1(r + off);
        prefetch_l1(r + M * 4 - 4);
      }
      if (hit) {
        next = g0 + __ffs(hit) - 1;
        break;
      }
    }
    if (next >= G) break;
    g = next;
    const float* row = src + static_cast<size_t>(g) * M;
    float v[kNC];
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int m = lane + kWarp * c;
      v[c] = m < M ? row[m] : NAN;
    }
    int pos = 0;  // the first model the scan has not passed
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const bool nl = (nlbits >> c) & 1u;
      const int m = lane + kWarp * c;
      for (;;) {
        const bool acc =
            m >= pos && (nl ? nl_accepts(nb, v[c]) : (v[c] > best));
        const unsigned hit = __ballot_sync(kFull, acc);
        if (!hit) break;
        const int t = __ffs(hit) - 1;
        best = __shfl_sync(kFull, v[c], t);
        nb = nl_bounds(best, mid, tie_up != 0);
        pos = kWarp * c + t + 1;
        bidx = g * M + pos - 1;
      }
    }
    ++g;
  }
  if (lane == 0) {
    best_out[l] = best;
    idx_out[l] = bidx;
  }
}

}  // namespace

extern "C" {

// grid: (L, G, M) f32 contiguous; is_nl: (M,) u8 (or bool) 0/1;
// best: (L,) f32 and idx: (L,) int32 (flat g*M + m), both written.
// The threshold T (finite f32) comes as `mid`, the midpoint between T and
// the next float above it, exact in double, and `tie_up`, 1 when T's bit
// pattern is odd (a quotient of exactly `mid` rounds up, above T);
// ops/select.py::threshold_midpoint computes both. M <= 128, G * 16 bytes
// of shared memory (G <= 3072). Launches on `stream`; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.
int uwspr_select_best(const float* grid, const uint8_t* is_nl, int L, int G,
                      int M, double mid, int tie_up, float* best,
                      int32_t* idx, void* stream) {
  if (L < 0 || G < 1 || G > 3072 || M < 1 || M > kNC * kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = 4 * static_cast<size_t>(G) * 4;
  select_best_kernel<<<L, (kNW + 1) * kWarp, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      grid, is_nl, G, M, mid, tie_up, best, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
