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
//
// The jiggle kernel (`fano_kernel_jiggles`, uwspr_fano_decode_jiggles)
// walks every gated (candidate, jiggle) lane of a batch in one launch,
// where the JAX program walks jiggle 0 of every candidate, then the other
// jiggles of the candidates whose jiggle 0 failed (jit_decoder.py:928-1022).
// The decoder keeps only a candidate's first decoded jiggle, so a lane
// matters only while no lower jiggle of its candidate has decoded: a lane
// that decodes lowers its candidate's word first_ok (atomicMin), and a
// lane of jiggle j >= 1 polls that word through the walk's abort hook and
// stops once it is below j. No lane waits on another. Blocks take the
// lanes in jiggle-major order (all jiggle-0 lanes first), so lower jiggles
// tend to start first, and the gated lanes before every other (`order`,
// fec/fano.py::gated_first). The block scheduler deals a launch's first
// blocks out to the SMs in turn, so the few gated lanes of a batch spread
// evenly over the SMs; scattered through the grid, they land wherever a
// slot frees, and lanes that share an SM slow each other's walk (on an
// H100, a ring-like batch of 342 gated lanes of 28,288 took 157 to 248 ms
// in the natural order and 125.6 ms gated first). The result never
// depends on the order: the lowest jiggle that decodes is never stopped,
// and a stopped lane reports no success. A lane that is not gated writes
// the inactive lane's fields and returns before the prologue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fano_lane.cuh"

namespace {

constexpr int kThreads = 32;  // one warp per block, one lane per block

// The prologue, run by the block's 32 threads: lane row `row`'s node
// metrics into `met` and enc = 0 in every node of `rec`.
__device__ __forceinline__ void lane_prologue(
    const uint8_t* __restrict__ row, const int32_t* __restrict__ mettab,
    uwspr::NodeMetrics* met, uwspr::NodeRec* rec, int32_t* smet) {
  using uwspr::kNbits;
  using uwspr::kNodes;
  // node k's two symbols are the 2-byte word k of the lane's row; the
  // pairs are read before the metric table is copied, so that the two
  // reads from device memory overlap
  const uint16_t* pairs = reinterpret_cast<const uint16_t*>(row);
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
}

__device__ __forceinline__ void store_lane(
    size_t l, const uwspr::FanoLaneResult& r, const uint8_t* bytes,
    uint8_t* success, uint8_t* data, int32_t* metric, int32_t* cycles,
    int32_t* maxnp) {
  success[l] = static_cast<uint8_t>(r.success);
  for (int b = 0; b < uwspr::kNbytes; ++b)
    data[l * uwspr::kNbytes + b] = bytes[b];
  metric[l] = r.metric;
  cycles[l] = r.cycles;
  maxnp[l] = r.maxnp;
}

__global__ void __launch_bounds__(kThreads)
fano_kernel(const uint8_t* __restrict__ symbols,
            const uint8_t* __restrict__ active,
            const int32_t* __restrict__ mettab, int delta, int32_t budget,
            uint8_t* __restrict__ success, uint8_t* __restrict__ data,
            int32_t* __restrict__ metric, int32_t* __restrict__ cycles,
            int32_t* __restrict__ maxnp) {
  __shared__ uwspr::NodeMetrics met[uwspr::kNbits];
  __shared__ uwspr::NodeRec rec[uwspr::kNodes];
  __shared__ int32_t branch[uwspr::kNodes];
  __shared__ int32_t smet[512];

  const int l = blockIdx.x;
  lane_prologue(symbols + static_cast<size_t>(l) * 2 * uwspr::kNbits, mettab,
                met, rec, smet);

  if (threadIdx.x != 0) return;
  const uwspr::LaneNodes nd{rec, branch, met};
  uint8_t bytes[uwspr::kNbytes];
  const uwspr::FanoLaneResult r = uwspr::fano_walk(
      nd, delta, budget, active == nullptr || active[l] != 0, bytes);
  store_lane(l, r, bytes, success, data, metric, cycles, maxnp);
}

// The abort hook of a jiggle-j lane (j >= 1): a read of its candidate's
// first_ok word, which fires once the word is below j.
struct FirstOkPoll {
  static constexpr bool kPolls = true;
  const int32_t* word;
  int32_t j;
  int32_t seen;
  __host__ __device__ void issue(int32_t) {
    seen = *static_cast<const volatile int32_t*>(word);
  }
  __host__ __device__ bool fired() const { return seen < j; }
};

__global__ void __launch_bounds__(kThreads)
fano_kernel_jiggles(const uint8_t* __restrict__ symbols,
                    const uint8_t* __restrict__ gate,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ mettab, int N, int J,
                    int delta, int32_t budget, int32_t* first_ok,
                    uint8_t* __restrict__ success,
                    uint8_t* __restrict__ data,
                    int32_t* __restrict__ metric,
                    int32_t* __restrict__ cycles,
                    int32_t* __restrict__ maxnp,
                    uint8_t* __restrict__ aborted) {
  __shared__ uwspr::NodeMetrics met[uwspr::kNbits];
  __shared__ uwspr::NodeRec rec[uwspr::kNodes];
  __shared__ int32_t branch[uwspr::kNodes];
  __shared__ int32_t smet[512];

  // block x walks lane b = order[x] = j N + wc: jiggle j of candidate wc
  const int b = order[blockIdx.x];
  const int j = b / N;
  const int wc = b - j * N;
  const size_t l = static_cast<size_t>(wc) * J + j;
  uint8_t bytes[uwspr::kNbytes];
  if (gate[l] == 0) {
    if (threadIdx.x != 0) return;
    const uwspr::LaneNodes none{rec, branch, met};
    const uwspr::FanoLaneResult r =
        uwspr::fano_walk(none, delta, budget, false, bytes);
    store_lane(l, r, bytes, success, data, metric, cycles, maxnp);
    aborted[l] = 0;
    return;
  }
  // the poll before the walk: read here, tested after the prologue
  FirstOkPoll poll{first_ok + wc, j, 0};
  if (threadIdx.x == 0 && j > 0) poll.issue(0);
  lane_prologue(symbols + l * 2 * uwspr::kNbits, mettab, met, rec, smet);

  if (threadIdx.x != 0) return;
  const uwspr::LaneNodes nd{rec, branch, met};
  // jiggle 0 is never stopped, and never polls
  const uwspr::FanoLaneResult r =
      j == 0 ? uwspr::fano_walk(nd, delta, budget, true, bytes)
             : uwspr::fano_walk(nd, delta, budget, true, bytes, poll);
  if (r.success) atomicMin(first_ok + wc, j);
  store_lane(l, r, bytes, success, data, metric, cycles, maxnp);
  aborted[l] = static_cast<uint8_t>(r.aborted);
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

// symbols: (N, J, 162) u8 deinterleaved soft symbols (2-byte aligned);
// gate: (N, J) u8 (or bool) 0/1, the lanes to walk; order: (J N,) int32,
// a permutation of the lanes b = j N + n (jiggle j of candidate n), block
// x walking lane order[x]; mettab: (2, 256) int32; first_ok: (N,) int32
// scratch, which this call sets (a memset, so that a graph capture
// records it) to a value above every jiggle before the launch. Outputs
// (all written, (N, J) lanes): success u8 (or bool), data (N, J, 10) u8,
// metric / cycles / maxnp int32, aborted u8 (or bool): the walk stopped
// because a lower jiggle of its candidate decoded. Launches on `stream`;
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments it does not take.
int uwspr_fano_decode_jiggles(const uint8_t* symbols, const uint8_t* gate,
                              const int32_t* order, const int32_t* mettab,
                              int N, int J, int delta, int budget,
                              int32_t* first_ok, uint8_t* success,
                              uint8_t* data, int32_t* metric, int32_t* cycles,
                              int32_t* maxnp, uint8_t* aborted,
                              void* stream) {
  if (N < 0 || J < 0 || (N > 0 && J > 0x7FFFFFFF / N))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || J == 0) return static_cast<int>(cudaGetLastError());
  if (order == nullptr || reinterpret_cast<uintptr_t>(symbols) % 2 != 0 ||
      budget > 0x7FFFFFFF - 2 * uwspr::kPollLooks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 0x7F7F7F7F: no jiggle of the candidate has decoded
  const cudaError_t e =
      cudaMemsetAsync(first_ok, 0x7F, sizeof(int32_t) * N, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  fano_kernel_jiggles<<<N * J, kThreads, 0, s>>>(
      symbols, gate, order, mettab, N, J, delta, budget, first_ok, success,
      data, metric, cycles, maxnp, aborted);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
