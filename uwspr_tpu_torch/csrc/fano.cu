// Batched Fano sequential decoder: each lane's trellis in shared memory.
//
// Replaces: uwspr_tpu/fec/fano_pallas.py::fano_decode_batch_pallas (kernel
// built by `_make_kernel`, fano_pallas.py:73-237). The per-lane walk is
// fano_lane.cuh, which follows uwspr_tpu/fec/native/fano_native.cc:45-132.
//
// What bounds it on the card: the longest lane. A lane is a data-dependent
// walk of up to maxcycles * 81 forward looks (810,000 at maxcycles 10,000)
// plus the backward steps between them, each depending on the one before.
// Bytes and operations are tiny (162 symbols in, 26 bytes out); the latency
// of one step is everything, and a chunk waits for its slowest lane.
//
// What the design does about it. A block is one warp and serves one lane,
// so lanes never wait on each other's divergent steps (one lane per warp
// beat 8 and 32 lanes per warp on every shape timed, PERF.md). A prologue,
// run by all 32 threads, reads the lane's symbol row with coalesced 2-byte
// loads (consecutive threads, consecutive nodes) and builds every node's
// four branch metrics into shared memory, as the TPU kernel receives them
// precomputed (fano_pallas.py:260-263), already sorted within each
// complementary pair (NodeMetrics), so that entering a node costs two
// parities and two selects. The node state (gamma, enc, tm0, tm1 as one
// 16-byte record, and branch) lives in shared memory too. The walk keeps
// the current node, the one before it and the next two nodes' metrics in
// registers: a forward look touches no memory, and every shared-memory
// read is issued a step before it is needed. It loads nothing from global
// memory and does no metric-table lookup.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fano_lane.cuh"

namespace {

constexpr int kThreads = 32;  // one warp per block, one lane per block

__global__ void __launch_bounds__(kThreads)
fano_kernel(const uint8_t* __restrict__ symbols,
            const uint8_t* __restrict__ active,
            const int32_t* __restrict__ mettab, int delta, int32_t budget,
            uint8_t* __restrict__ success, uint8_t* __restrict__ data,
            int32_t* __restrict__ metric, int32_t* __restrict__ cycles,
            int32_t* __restrict__ maxnp) {
  using uwspr::kNbits;
  using uwspr::kNodes;
  __shared__ uwspr::NodeMetrics met[kNbits];
  __shared__ uwspr::NodeRec rec[kNodes];
  __shared__ int32_t branch[kNodes];
  __shared__ int32_t smet[512];

  const int l = blockIdx.x;
  // node k's two symbols are the 2-byte word k of the lane's row; the
  // pairs are read before the metric table is copied, so that the two
  // reads from device memory overlap
  const uint16_t* pairs = reinterpret_cast<const uint16_t*>(
      symbols + static_cast<size_t>(l) * 2 * kNbits);
  constexpr int kPer = (kNbits + kThreads - 1) / kThreads;  // 3
  uint16_t p[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = threadIdx.x + i * kThreads;
    p[i] = k < kNbits ? pairs[k] : 0;
  }
  for (int i = threadIdx.x; i < 512; i += kThreads) smet[i] = mettab[i];
  for (int k = threadIdx.x; k < kNodes; k += kThreads) rec[k].enc = 0u;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = threadIdx.x + i * kThreads;
    if (k < kNbits) met[k] = uwspr::node_metrics(smet, p[i] & 0xFF, p[i] >> 8);
  }
  __syncthreads();

  if (threadIdx.x != 0) return;
  const uwspr::LaneNodes nd{rec, branch, met};
  uint8_t bytes[uwspr::kNbytes];
  const uwspr::FanoLaneResult r = uwspr::fano_walk(
      nd, delta, budget, active == nullptr || active[l] != 0, bytes);
  success[l] = static_cast<uint8_t>(r.success);
  for (int b = 0; b < uwspr::kNbytes; ++b)
    data[static_cast<size_t>(l) * uwspr::kNbytes + b] = bytes[b];
  metric[l] = r.metric;
  cycles[l] = r.cycles;
  maxnp[l] = r.maxnp;
}

}  // namespace

extern "C" {

// symbols: (L, 162) u8 deinterleaved soft symbols (2-byte aligned);
// active: (L,) u8 (or bool) 0/1, or null for all lanes; mettab: (2, 256)
// int32. Outputs (all written): success (L,) u8 (or bool) 0/1, data
// (L, 10) u8, metric / cycles / maxnp (L,) int32. Launches on `stream`;
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments it does not take.
int uwspr_fano_decode(const uint8_t* symbols, const uint8_t* active,
                      const int32_t* mettab, int L, int delta, int budget,
                      uint8_t* success, uint8_t* data, int32_t* metric,
                      int32_t* cycles, int32_t* maxnp, void* stream) {
  if (L < 0 || reinterpret_cast<uintptr_t>(symbols) % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return static_cast<int>(cudaGetLastError());
  fano_kernel<<<L, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      symbols, active, mettab, delta, budget, success, data, metric, cycles,
      maxnp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
