// One lane of the Fano sequential decoder for the WSPR K=32 r=1/2 code.
//
// Shared by the CUDA kernel (fano.cu, one thread per lane) and by host C++
// (a plain g++ build of this header, used by the CPU tests), so both run
// the same lane logic. The algorithm is that of
// uwspr_tpu/fec/native/fano_native.cc:45-132 (`fano_lane`):
//   - branch metrics from the (2, 256) metric table, per node, on demand;
//   - best-first branch order (complementary branch symbols);
//   - threshold tighten / relax in `delta` steps;
//   - an all-zero 31-step tail, 0-branch only;
//   - a budget of maxcycles * nbits forward looks, where a decode that
//     finishes on the last allowed cycle still reports timeout (the
//     reference quirk, Fano.cc:250 / fano_pallas.py:189).
// An inactive lane starts done, as fano_pallas.py:131-140 does: success 0,
// data all zero, metric 0, cycles 1, maxnp 0.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define UWSPR_HD __host__ __device__
#else
#define UWSPR_HD
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
};

UWSPR_HD inline int parity32(uint32_t v) {
  v ^= v >> 16;
  v ^= v >> 8;
  v ^= v >> 4;
  v ^= v >> 2;
  v ^= v >> 1;
  return static_cast<int>(v & 1u);
}

// 2-bit branch symbol: POLY1 parity in the 2s place, POLY2 parity in the 1s.
UWSPR_HD inline int branch_symbol(uint32_t state) {
  return (parity32(state & kPoly1) << 1) | parity32(state & kPoly2);
}

// Metric of branch symbol j at node k: row (j >> 1) scores symbol 2k,
// row (j & 1) scores symbol 2k + 1 (fano_native.cc:52-62).
UWSPR_HD inline int32_t branch_metric(const uint8_t* sym,
                                      const int32_t* mettab, int k, int j) {
  return mettab[(j >> 1) * 256 + sym[2 * k]] +
         mettab[(j & 1) * 256 + sym[2 * k + 1]];
}

// Sorted branch metrics of node k; enc[k] gains its low bit when the
// 1-branch is the better one (fano_native.cc:68-84).
UWSPR_HD inline void expand_node(const uint8_t* sym, const int32_t* mettab,
                                 int k, uint32_t* enc, int32_t* tm0,
                                 int32_t* tm1, int8_t* branch) {
  const int lsym = branch_symbol(enc[k]);
  if (k >= kTail) {
    tm0[k] = branch_metric(sym, mettab, k, lsym);
  } else {
    const int32_t a = branch_metric(sym, mettab, k, lsym);
    const int32_t b = branch_metric(sym, mettab, k, 3 ^ lsym);
    if (a > b) {
      tm0[k] = a;
      tm1[k] = b;
    } else {
      tm0[k] = b;
      tm1[k] = a;
      enc[k] += 1u;
    }
  }
  branch[k] = 0;
}

// Decode one lane of 2 * kNbits deinterleaved soft symbols. `mettab` is the
// flattened (2, 256) table; `budget` is maxcycles * kNbits. Writes kNbytes
// harvested bytes (enc[7 + 8b] & 0xFF) to out_bytes.
UWSPR_HD inline FanoLaneResult fano_lane(const uint8_t* sym,
                                         const int32_t* mettab, int delta,
                                         int32_t budget, bool active,
                                         uint8_t* out_bytes) {
  FanoLaneResult r;
  r.success = 0;
  r.metric = 0;
  r.cycles = 1;
  r.maxnp = 0;
  for (int b = 0; b < kNbytes; ++b) out_bytes[b] = 0;
  if (!active) return r;

  int32_t gamma[kNodes];
  uint32_t enc[kNodes];
  int32_t tm0[kNodes], tm1[kNodes];
  int8_t branch[kNodes];
  for (int n = 0; n < kNodes; ++n) {
    gamma[n] = 0;
    enc[n] = 0;
    tm0[n] = 0;
    tm1[n] = 0;
    branch[n] = 0;
  }

  int k = 0;
  expand_node(sym, mettab, 0, enc, tm0, tm1, branch);
  int32_t t = 0;
  int32_t maxnp = 0;
  int32_t i = 1;
  for (; i <= budget; ++i) {
    if (k > maxnp) maxnp = k;
    const int32_t ngamma = gamma[k] + (branch[k] ? tm1[k] : tm0[k]);
    if (ngamma >= t) {
      if (gamma[k] < t + delta) {
        while (ngamma >= t + delta) t += delta;
      }
      gamma[k + 1] = ngamma;
      enc[k + 1] = enc[k] << 1;
      ++k;
      if (k == kNbits) break;  // complete
      expand_node(sym, mettab, k, enc, tm0, tm1, branch);
    } else {
      for (;;) {
        if (k == 0 || gamma[k - 1] < t) {
          t -= delta;
          if (branch[k] != 0) {
            branch[k] = 0;
            enc[k] ^= 1u;
          }
          break;
        }
        --k;
        if (k < kTail && branch[k] != 1) {
          branch[k] += 1;
          enc[k] ^= 1u;
          break;
        }
      }
    }
  }

  for (int b = 0; b < kNbytes; ++b)
    out_bytes[b] = static_cast<uint8_t>(enc[7 + 8 * b] & 0xFFu);
  r.success = (i < budget) ? 1 : 0;
  r.metric = gamma[k];
  r.cycles = i + 1;
  r.maxnp = maxnp;
  return r;
}

}  // namespace uwspr
