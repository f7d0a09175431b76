// Native batched Fano sequential decoder for the WSPR K=32 r=1/2 code.
//
// The port's own copy of uwspr_tpu/fec/native/fano_native.cc, kept
// bit-exact with it (tests/test_torch_copies.py), built by fec/host.py.
//
// Host-side runtime component of the uwspr_tpu framework: decodes many
// independent soft-symbol lanes in parallel (OpenMP), one classic Fano
// threshold search per lane.  Semantics are matched to the reference
// decoder (see the reference's lib/Fano.cc:110-252 for the behavioral
// spec; this is a fresh array-based implementation, not a copy):
//   - per-step branch metrics from a (2,256) metric table
//   - best-first branch ordering (complementary branch symbols)
//   - threshold tighten/relax in `delta` steps
//   - all-zero 31-step tail, 0-branch only
//   - budget of maxcycles*nbits forward looks; finishing exactly on the
//     last allowed cycle still reports timeout (reference quirk).
//
// Build (fec/host.py): g++ -O3 -fopenmp -shared -fPIC fano_native.cc

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr uint32_t kPoly1 = 0xF2D05351u;
constexpr uint32_t kPoly2 = 0xE4613C47u;

inline int branch_symbol(uint32_t state) {
  uint32_t a = state & kPoly1;
  uint32_t b = state & kPoly2;
  // 2-bit symbol: POLY1 parity in the 2s place, POLY2 parity in the 1s.
  return (__builtin_parity(a) << 1) | __builtin_parity(b);
}

struct LaneResult {
  int success;
  int32_t metric;
  uint32_t cycles;
  uint32_t maxnp;
};

// Decode one lane of 2*nbits soft symbols (coded-bit order).
LaneResult fano_lane(const uint8_t* symbols, int nbits,
                     const int32_t* mettab,  // [2][256] flattened
                     int delta, long maxcycles, uint8_t* out_bytes) {
  const int tail = nbits - 31;
  // Precompute the 4 branch metrics per trellis step.
  std::vector<int32_t> metrics(static_cast<size_t>(nbits) * 4);
  for (int k = 0; k < nbits; ++k) {
    const int y0 = symbols[2 * k];
    const int y1 = symbols[2 * k + 1];
    const int32_t a0 = mettab[y0], a1 = mettab[256 + y0];
    const int32_t b0 = mettab[y1], b1 = mettab[256 + y1];
    metrics[4 * k + 0] = a0 + b0;
    metrics[4 * k + 1] = a0 + b1;
    metrics[4 * k + 2] = a1 + b0;
    metrics[4 * k + 3] = a1 + b1;
  }

  std::vector<int64_t> gamma(nbits + 1, 0);
  std::vector<uint32_t> enc(nbits + 1, 0);
  std::vector<int32_t> tm0(nbits + 1, 0), tm1(nbits + 1, 0);
  std::vector<int8_t> branch(nbits + 1, 0);

  auto expand = [&](int k) {
    const int lsym = branch_symbol(enc[k]);
    if (k >= tail) {
      tm0[k] = metrics[4 * k + lsym];
    } else {
      const int32_t a = metrics[4 * k + lsym];
      const int32_t b = metrics[4 * k + (3 ^ lsym)];
      if (a > b) {
        tm0[k] = a;
        tm1[k] = b;
      } else {
        tm0[k] = b;
        tm1[k] = a;
        enc[k] += 1;  // 1-branch is better
      }
    }
    branch[k] = 0;
  };

  int k = 0;
  expand(0);
  int64_t t = 0;
  const long budget = maxcycles * nbits;
  uint32_t maxnp = 0;
  long i = 1;
  for (; i <= budget; ++i) {
    if (static_cast<uint32_t>(k) > maxnp) maxnp = k;
    const int64_t ngamma = gamma[k] + (branch[k] ? tm1[k] : tm0[k]);
    if (ngamma >= t) {
      if (gamma[k] < t + delta) {
        while (ngamma >= t + delta) t += delta;
      }
      gamma[k + 1] = ngamma;
      enc[k + 1] = enc[k] << 1;
      ++k;
      if (k == nbits) break;  // complete
      expand(k);
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
        if (k < tail && branch[k] != 1) {
          branch[k] += 1;
          enc[k] ^= 1u;
          break;
        }
      }
    }
  }

  const int nbytes = nbits >> 3;
  for (int b = 0; b < nbytes; ++b) out_bytes[b] = enc[7 + 8 * b] & 0xFF;
  LaneResult r;
  r.success = (i < budget) ? 1 : 0;
  r.metric = static_cast<int32_t>(gamma[k]);
  r.cycles = static_cast<uint32_t>(i + 1);
  r.maxnp = maxnp;
  return r;
}

}  // namespace

extern "C" {

// symbols: (n_lanes, 2*nbits) uint8, coded-bit order (deinterleaved)
// mettab: (2, 256) int32
// out_data: (n_lanes, nbits>>3) uint8
// out_success/metric/cycles/maxnp: (n_lanes,) int32/uint32
void uwspr_fano_decode_batch(const uint8_t* symbols, int n_lanes, int nbits,
                             const int32_t* mettab, int delta, int maxcycles,
                             uint8_t* out_data, int32_t* out_success,
                             int32_t* out_metric, uint32_t* out_cycles,
                             uint32_t* out_maxnp) {
  const int nbytes = nbits >> 3;
#pragma omp parallel for schedule(dynamic, 1)
  for (int lane = 0; lane < n_lanes; ++lane) {
    LaneResult r =
        fano_lane(symbols + static_cast<size_t>(lane) * 2 * nbits, nbits,
                  mettab, delta, maxcycles,
                  out_data + static_cast<size_t>(lane) * nbytes);
    out_success[lane] = r.success;
    out_metric[lane] = r.metric;
    out_cycles[lane] = r.cycles;
    out_maxnp[lane] = r.maxnp;
  }
}

int uwspr_fano_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
