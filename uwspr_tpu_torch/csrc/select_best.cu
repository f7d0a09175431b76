// Exact order-dependent drift-model selection, one warp per candidate lane.
//
// Replaces: uwspr_tpu/ops/select_pallas.py::select_best_pallas (kernel
// `_kernel`, select_pallas.py:42-116), the reference's sequential best-model
// walk (FDR_impl.cc:344-405): over the (freq, lag, model) grid in order, a
// linear model accepts when v > best, a nonlinear one when v / best > thr
// (IEEE f32 division), NaN never accepts; best starts at -1e30.
//
// What bounds it on the card: reading the grid. Each lane owns a
// (G=130, M=126) f32 block (65.5 KB); at the serving shape of 1,664 lanes
// the launch reads 109 MB once, so the floor is the HBM read (about 33 us at
// 3.35 TB/s). The ordered walk itself is short: a lane accepts in ~5 of its
// 130 groups.
//
// What the design does about it: each warp streams its lane's groups with
// coalesced 32-wide row reads and computes the exact skip test of
// search.py:404-418 (linear max, nonlinear max and min, NaN excluded) with
// warp shuffles. f32 division is monotone in the numerator for a fixed
// denominator, so a group whose extremes cannot accept against the running
// best holds no accept at all and is skipped. A group that can accept is
// walked model by model in order, every lane of the warp computing the same
// update from the same (L1-resident) row, so the result is the literal scan
// of search.py:360-390 by construction. There is no lane padding and no
// linear-first requirement; the nonlinear jump is gated on the group holding
// a non-NaN nonlinear value, so all-linear banks and NaN rows skip cleanly.
//
// Build: nvcc without --use_fast_math: __fdiv_rn and IEEE compares must stay.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void select_best_kernel(const float* __restrict__ grid,
                                   const int32_t* __restrict__ is_nl,
                                   int L, int G, int M, float thr,
                                   float* __restrict__ best_out,
                                   int32_t* __restrict__ idx_out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int l = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (l >= L) return;  // whole warps only: l is uniform across a warp
  const float* g3 = grid + static_cast<size_t>(l) * G * M;
  float best = -1e30f;
  int32_t bidx = 0;
  for (int g = 0; g < G; ++g) {
    const float* row = g3 + static_cast<size_t>(g) * M;
    float lmax = -INFINITY, nmax = -INFINITY, nmin = INFINITY;
    int has_nl = 0;
    for (int m = lane; m < M; m += kWarp) {
      const float v = row[m];
      if (isnan(v)) continue;
      if (is_nl[m]) {
        nmax = fmaxf(nmax, v);
        nmin = fminf(nmin, v);
        has_nl = 1;
      } else {
        lmax = fmaxf(lmax, v);
      }
    }
    lmax = warp_max(lmax);
    nmax = warp_max(nmax);
    nmin = warp_min(nmin);
    has_nl = __any_sync(kFull, has_nl);
    const bool can = (lmax > best) ||
                     (has_nl && ((__fdiv_rn(nmax, best) > thr) ||
                                 (__fdiv_rn(nmin, best) > thr)));
    if (!can) continue;  // warp-uniform: every lane holds the same extremes
    for (int m = 0; m < M; ++m) {
      const float v = row[m];
      const bool acc = is_nl[m] ? (__fdiv_rn(v, best) > thr) : (v > best);
      if (acc) {
        best = v;
        bidx = g * M + m;
      }
    }
  }
  if (lane == 0) {
    best_out[l] = best;
    idx_out[l] = bidx;
  }
}

}  // namespace

extern "C" {

// grid: (L, G, M) f32 contiguous; is_nl: (M,) int32 0/1;
// best: (L,) f32 and idx: (L,) int32 (flat g*M + m), both written.
// Launches on `stream`; returns cudaGetLastError() after the launch.
int uwspr_select_best(const float* grid, const int32_t* is_nl, int L, int G,
                      int M, float thr, float* best, int32_t* idx,
                      void* stream) {
  if (L > 0) {
    const dim3 block(kWarp * kWarpsPerBlock);
    const dim3 blocks((L + kWarpsPerBlock - 1) / kWarpsPerBlock);
    select_best_kernel<<<blocks, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        grid, is_nl, L, G, M, thr, best, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
