// Ordered-statistics decoding (order 1 to 4), one lane per block.
//
// Replaces: XLA's program for uwspr_tpu/fec/osd_jax.py::osd2_decode_jax
// under jax.vmap in uwspr_tpu/pipeline/jit_decoder.py::_osd_rescue
// (jit_decoder.py:1096-1097). It is not a Pallas kernel: the JAX package
// leaves this function to XLA. The lane's logic is osd_lane.cuh, which
// also states why each result equals the JAX function's.
//
// What bounds it on the card: integer and popc issue in the flip search.
// A lane has 1 + 50 + 1,225 + 19,600 + 230,300 = 251,176 candidates at
// order 4; a candidate costs 4 XORs, then 32 AND + 32 POPC over the 112
// parity positions (4 words x 8 bit-planes of r) and the adds that weigh
// them. POPC issues at 16 a clock on an SM, a quarter of the integer
// rate, so order 4 is 251,176 x 32 = 8.04 M POPC a lane, ~502,000 SM
// clocks or ~0.25 ms on one SM at 1.98 GHz. A block serves one lane, so
// the 40 to 64 lanes of a rescue batch use as many of the card's 132 SMs
// and the batch takes one lane's time: 0.375 ms on an H100 SXM at 700 W
// (chip_smoke.py phase 12), the scan at ~2.7 SM clocks a candidate and
// the prologue ~0.03 ms. Bytes are nothing: 162 symbols and the 32 KB
// generator in, 212 bytes out a lane.
//
// What the design does about it. The score of a flip set is an integer
// split in two: the 50 information positions add the flipped positions'
// r (their mismatch is the flip itself), so only the 112 parity positions
// need a popcount, 4 words where the whole codeword needs 6. r's 8
// bit-planes stay in registers with m0. A pair table in shared memory
// holds, for each pair (a, b) of information positions in lexicographic
// order, D[a] ^ D[b] and the pair's weight, so an order-4 candidate is a
// leading pair XOR a following pair: one 16-byte load, 4 XORs and the
// weighted popcount. The block's 8 warps take leading pairs in turn and
// the 32 lanes of a warp the pairs that follow, so every lane runs the
// same loop (contiguous lexicographic ranges per thread, where inner
// loops differ in length by lane, ran at a fifth of the popcount rate).
// Each thread keeps the least (score, key) and the two smallest scores of
// its candidates, in any order, and a block reduction ends the search.
// The sort, the information set and the inverse are item-parallel phases
// with one barrier per pivot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "osd_lane.cuh"

namespace {

using uwspr::osd::OsdBest;
using uwspr::osd::OsdScratch;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ OsdBest shfl_down(const OsdBest& b, int off) {
  OsdBest o;
  o.m1 = __shfl_down_sync(0xFFFFFFFFu, b.m1, off);
  o.m2 = __shfl_down_sync(0xFFFFFFFFu, b.m2, off);
  o.key = __shfl_down_sync(0xFFFFFFFFu, b.key, off);
  return o;
}

__global__ void __launch_bounds__(kThreads, 1)
osd_kernel(const uint8_t* __restrict__ soft,
           const uint8_t* __restrict__ active, const float* __restrict__ G,
           int order, int32_t* __restrict__ bits,
           float* __restrict__ quality, float* __restrict__ margin,
           int32_t* __restrict__ flips) {
  using namespace uwspr::osd;
  __shared__ OsdScratch s;
  __shared__ OsdBest warp_best[kWarps];
  __shared__ OsdBest best;
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  int32_t* out_bits = bits + static_cast<size_t>(l) * kK;
  if (active != nullptr && active[l] == 0) {   // starts done
    if (tid < kK) out_bits[tid] = 0;
    if (tid == 0) {
      quality[l] = 0.0f;
      margin[l] = 0.0f;
      flips[l] = 0;
    }
    return;
  }
  osd_load(s, soft + static_cast<size_t>(l) * kN, G, tid, kThreads);
  __syncthreads();
  osd_rank(s, tid, kThreads);
  __syncthreads();
  osd_permute(s, tid, kThreads);
  __syncthreads();
  osd_eliminate(s, tid, kThreads);
  __syncthreads();
  osd_columns(s, tid, kThreads);
  __syncthreads();
  osd_pack(s, tid, kThreads);
  __syncthreads();
  osd_pairs(s, tid, kThreads);
  __syncthreads();

  OsdBest b = osd_scan(s, order, tid >> 5, kWarps, tid & 31, 32);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) b = osd_merge(b, shfl_down(b, off));
  if ((tid & 31) == 0) warp_best[tid >> 5] = b;
  __syncthreads();
  if (tid == 0) {
    OsdBest m = warp_best[0];
    for (int w = 1; w < kWarps; ++w) m = osd_merge(m, warp_best[w]);
    best = m;
    osd_scalars(s, m, quality + l, margin + l, flips + l);
  }
  __syncthreads();
  if (tid < kK) out_bits[tid] = osd_bit(s, osd_bit_columns(s, best.key), tid);
}

}  // namespace

extern "C" {

// soft: (L, 162) u8 soft symbols; active: (L,) u8 (or bool) 0/1, or null
// for all lanes; G: (162, 50) float32 0/1; order 1 to 4. Outputs (all
// written): bits (L, 50) int32, quality / margin (L,) float32, flips (L,)
// int32. Launches on `stream`; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
int uwspr_osd_decode(const uint8_t* soft, const uint8_t* active,
                     const float* G, int L, int order, int32_t* bits,
                     float* quality, float* margin, int32_t* flips,
                     void* stream) {
  if (L < 0 || order < 1 || order > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return static_cast<int>(cudaGetLastError());
  osd_kernel<<<L, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      soft, active, G, order, bits, quality, margin, flips);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
