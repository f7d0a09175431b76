// One lane of the Fano sequential decoder for the WSPR K=32 r=1/2 code.
//
// Shared by the CUDA kernel (fano.cu, node state in shared memory) and by
// host C++ (a plain g++ build of this header, node state in local arrays,
// used by the CPU tests), so both run the same walk. The algorithm is that
// of uwspr_tpu/fec/native/fano_native.cc:45-132 (`fano_lane`):
//   - per-node branch metrics from the (2, 256) metric table, all four
//     built and sorted before the walk (`node_metrics`), as the TPU kernel
//     receives them precomputed (fano_pallas.py:260-263);
//   - best-first branch order (complementary branch symbols);
//   - threshold tighten / relax in `delta` steps;
//   - an all-zero 31-step tail, 0-branch only;
//   - a budget of maxcycles * nbits forward looks, where a decode that
//     finishes on the last allowed cycle still reports timeout (the
//     reference quirk, Fano.cc:250 / fano_pallas.py:189).
// An inactive lane starts done, as fano_pallas.py:131-140 does: success 0,
// data all zero, metric 0, cycles 1, maxnp 0.
//
// The walk may take an abort hook (`fano_walk` with an `Abort` argument),
// which the batched jiggle kernel uses to stop a lane whose result can no
// longer be kept. Without one (`NoAbort`) the walk is the one above, bit
// for bit, and never polls.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define UWSPR_HD __host__ __device__ __forceinline__
#else
#define UWSPR_HD inline
#endif

namespace uwspr {

constexpr int kNbits = 81;               // trellis steps (50 info + 31 tail)
constexpr int kTail = kNbits - 31;       // first tail node
constexpr int kNodes = kNbits + 1;
constexpr int kNbytes = kNbits >> 3;     // 10 harvested bytes
constexpr uint32_t kPoly1 = 0xF2D05351u;
constexpr uint32_t kPoly2 = 0xE4613C47u;

struct FanoLaneResult {
  int32_t success;
  int32_t metric;
  int32_t cycles;
  int32_t maxnp;
  int32_t aborted;  // 1: the abort hook stopped the walk (success 0)
};

// The abort hook's schedule: the walk tests the hook every kPollLooks
// forward looks, and issues each test's read kPollLead looks before it, so
// that the read's latency never sits on the walk's chain of dependent
// steps.
constexpr int32_t kPollLooks = 64;
constexpr int32_t kPollLead = 16;

// An abort hook: `issue(looks)` starts a read of the abort flag after
// `looks` forward looks and `fired()` tests the value the last issue read.
// kPolls false: the walk never calls either and compiles as without one.
struct NoAbort {
  static constexpr bool kPolls = false;
  UWSPR_HD void issue(int32_t) {}
  UWSPR_HD bool fired() const { return false; }
};

UWSPR_HD int parity32(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __popc(v) & 1;
#else
  return __builtin_popcount(v) & 1;
#endif
}

// A node's branch metrics, sorted ahead of the walk. Metric j (j =
// (poly1 bit << 1) | poly2 bit) pairs with its complement 3 ^ j, the other
// branch's symbol: pair 0 is {0, 3}, pair 1 is {1, 2}. hi / lo are the
// larger / smaller metric of each pair, and bit j of `swap` says that
// metric j is not larger than metric 3 ^ j, i.e. that the node entered
// with branch symbol j takes its 1-branch first.
struct alignas(16) NodeMetrics {
  int32_t hi[2];
  int32_t lo[2];
  uint32_t swap;
  int32_t pad[3];
};

// Node k's NodeMetrics from its two soft symbols s0 = sym[2k] and
// s1 = sym[2k + 1]: metric j is mettab[j >> 1][s0] + mettab[j & 1][s1]
// (fano_native.cc:52-62; fec/fano.py::branch_metrics).
UWSPR_HD NodeMetrics node_metrics(const int32_t* mettab, int s0, int s1) {
  const int32_t a0 = mettab[s0], a1 = mettab[256 + s0];
  const int32_t b0 = mettab[s1], b1 = mettab[256 + s1];
  const int32_t m0 = a0 + b0, m1 = a0 + b1, m2 = a1 + b0, m3 = a1 + b1;
  NodeMetrics n;
  n.hi[0] = m0 > m3 ? m0 : m3;
  n.lo[0] = m0 > m3 ? m3 : m0;
  n.hi[1] = m1 > m2 ? m1 : m2;
  n.lo[1] = m1 > m2 ? m2 : m1;
  n.swap = (m0 <= m3 ? 1u : 0u) | (m1 <= m2 ? 2u : 0u) |
           (m2 <= m1 ? 4u : 0u) | (m3 <= m0 ? 8u : 0u);
  n.pad[0] = n.pad[1] = n.pad[2] = 0;
  return n;
}

// A node's state: path metric, encoder state, sorted branch metrics.
struct alignas(16) NodeRec {
  int32_t gamma;
  uint32_t enc;
  int32_t tm0, tm1;
};

// Where one lane's walk keeps its nodes: shared memory in the kernel,
// local arrays on the host. `met` holds the kNbits nodes' metrics, `rec`
// and `branch` the kNodes nodes' state.
struct LaneNodes {
  NodeRec* rec;
  int32_t* branch;
  const NodeMetrics* met;
};

// One node in registers: the current node and the one before it.
struct Node {
  NodeRec r;
  int32_t branch;
};

UWSPR_HD Node load_node(const LaneNodes& nd, int k) {
  Node n;
  n.r = nd.rec[k];
  n.branch = nd.branch[k];
  return n;
}

UWSPR_HD NodeMetrics load_metrics(const LaneNodes& nd, int k) {
  return nd.met[k < kNbits ? k : kNbits - 1];
}

// Node k entered from the node before it (encoder state `parent`) with
// path metric `gamma`: the node's state is parent << 1, its branch symbol
// the parities of that state under the two polynomials, and the branch
// metrics sorted best first; the state gains its low bit when the 1-branch
// is the better one (fano_native.cc:68-84). Tail nodes take the 0-branch
// only and never read tm1. Registers only: the walk computes the child of
// the current node before it knows whether it moves there.
UWSPR_HD Node enter(int k, int32_t gamma, uint32_t parent,
                    const NodeMetrics& m) {
  // parity((parent << 1) & P) == parity(parent & (P >> 1))
  const int p1 = parity32(parent & (kPoly1 >> 1));
  const int p2 = parity32(parent & (kPoly2 >> 1));
  const int pair = p1 ^ p2;
  const uint32_t sw = (m.swap >> ((p1 << 1) | p2)) & 1u;
  const int32_t hi = pair ? m.hi[1] : m.hi[0];
  const int32_t lo = pair ? m.lo[1] : m.lo[0];
  const bool tail = k >= kTail;
  Node n;
  n.r.gamma = gamma;
  n.r.enc = (parent << 1) | (tail ? 0u : sw);
  n.r.tm0 = tail && sw ? lo : hi;  // a tail node: its branch symbol's own
  n.r.tm1 = lo;
  n.branch = 0;
  return n;
}

UWSPR_HD void store_node(const LaneNodes& nd, int k, const Node& n) {
  nd.rec[k] = n.r;
  nd.branch[k] = n.branch;
}

// Decode one lane. `nd` must hold the lane's metrics and enc = 0 in every
// node; `budget` is maxcycles * kNbits. Writes kNbytes harvested bytes
// (enc[7 + 8b] & 0xFF) to out_bytes.
//
// With an abort hook that polls, the caller issues the hook's first read
// before the walk; the walk tests it before its first look (a lane stopped
// there reports the inactive lane's fields), then after every kPollLooks
// looks tests the read it issued kPollLead looks earlier. A flag raised
// from look n on is seen by the first read issued at or after n, so the
// walk stops after at most n + kPollLooks + kPollLead - 1 looks, at a test,
// with success 0, aborted 1 and cycles = looks + 1. Until it fires the walk
// is the hookless one: the polls only split its loop at the test and issue
// points.
//
// The current node and the one before it live in registers, with the
// metrics of the nodes at and after the current one, so a forward look
// reads nothing, a move forward reads one metric entry a step ahead, and
// a step back reads the node two behind, one step ahead of its use. The
// child a forward move would enter is computed before the threshold test,
// beside it rather than after it. Every change to a node is written
// through to `nd`.
template <class Abort>
UWSPR_HD FanoLaneResult fano_walk(const LaneNodes& nd, int delta,
                                  int32_t budget, bool active,
                                  uint8_t* out_bytes, Abort& abort) {
  FanoLaneResult r;
  r.success = 0;
  r.metric = 0;
  r.cycles = 1;
  r.maxnp = 0;
  r.aborted = 0;
  if (!active || (Abort::kPolls && abort.fired())) {
    for (int b = 0; b < kNbytes; ++b) out_bytes[b] = 0;
    r.aborted = active ? 1 : 0;
    return r;
  }

  NodeMetrics mhere = load_metrics(nd, 0);
  NodeMetrics mnext = load_metrics(nd, 1);
  int k = 0;
  Node cur = enter(0, 0, 0u, mhere);
  store_node(nd, 0, cur);
  Node prev = cur;  // node k - 1; unused while k == 0
  int32_t t = 0;
  int32_t maxnp = 0;
  int32_t i = 1;
  bool complete = false;
  int32_t stop = kPollLooks - kPollLead;  // looks done at the next poll point
  bool reads = true;                      // that point reads (else tests)
  for (;;) {
    const int32_t lim = Abort::kPolls && stop < budget ? stop : budget;
    for (; i <= lim; ++i) {
      if (k > maxnp) maxnp = k;
      const int32_t ngamma =
          cur.r.gamma + (cur.branch ? cur.r.tm1 : cur.r.tm0);
      const Node child = enter(k + 1, ngamma, cur.r.enc, mnext);
      if (ngamma >= t) {
        if (cur.r.gamma < t + delta) {
          while (ngamma >= t + delta) t += delta;
        }
        ++k;
        if (k == kNbits) {  // complete
          cur.r.gamma = ngamma;
          complete = true;
          break;
        }
        prev = cur;
        cur = child;
        store_node(nd, k, cur);
        mhere = mnext;
        mnext = load_metrics(nd, k + 1);
      } else {
        for (;;) {
          if (k == 0 || prev.r.gamma < t) {
            t -= delta;
            if (cur.branch != 0) {
              cur.branch = 0;
              cur.r.enc ^= 1u;
              nd.branch[k] = 0;
              nd.rec[k].enc = cur.r.enc;
            }
            break;
          }
          --k;
          cur = prev;
          mnext = mhere;
          mhere = load_metrics(nd, k);
          if (k > 0) prev = load_node(nd, k - 1);
          if (k < kTail && cur.branch != 1) {
            cur.branch += 1;
            cur.r.enc ^= 1u;
            nd.branch[k] = cur.branch;
            nd.rec[k].enc = cur.r.enc;
            break;
          }
        }
      }
    }
    if (complete || i > budget) break;
    // a poll point: i - 1 == stop looks done
    if (reads) {
      abort.issue(stop);
      stop += kPollLead;
    } else if (abort.fired()) {
      r.aborted = 1;
      break;
    } else {
      stop += kPollLooks - kPollLead;
    }
    reads = !reads;
  }

  for (int b = 0; b < kNbytes; ++b)
    out_bytes[b] = static_cast<uint8_t>(nd.rec[7 + 8 * b].enc & 0xFFu);
  r.success = (!r.aborted && i < budget) ? 1 : 0;
  r.metric = cur.r.gamma;
  r.cycles = r.aborted ? i : i + 1;
  r.maxnp = maxnp;
  return r;
}

// The walk without an abort hook.
UWSPR_HD FanoLaneResult fano_walk(const LaneNodes& nd, int delta,
                                  int32_t budget, bool active,
                                  uint8_t* out_bytes) {
  NoAbort never;
  return fano_walk(nd, delta, budget, active, out_bytes, never);
}

}  // namespace uwspr
