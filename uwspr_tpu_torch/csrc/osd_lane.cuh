// One lane of the ordered-statistics decoder (order <= 4) for the WSPR
// K=32 r=1/2 code: 162 soft symbols in, 50 information bits out.
//
// Shared by the CUDA kernel (osd.cu: one block per lane, the scratch in
// shared memory, the block's threads splitting each phase's items) and by
// host C++ (a plain g++ build of this header, one thread, used by the CPU
// tests), so both run the same arithmetic. Every result equals that of
// uwspr_tpu/fec/osd_jax.py::osd2_decode_jax on the lane:
//   - reliability order: the stable argsort of -r, r = |soft - 128| an
//     integer in 0..128, h = soft >= 128; here a counting rank
//     (`osd_rank`), which gives the same order;
//   - the information set: the greedy independent rows of G in that order
//     (`_basis_select`), ascending in it. `osd_eliminate` finds them by
//     column operations on the rank-ordered G (64-bit row masks; a row of
//     G is 50 bits): row k is independent of the rows before it iff it has
//     a 1 in a column not yet pivoted, and pivoting there (XOR of that
//     column into every other column with a 1 in row k) leaves M = G T
//     with M[sel_j] = e_{pc_j}. So D = G Ainv is M's columns pc_0..pc_49
//     and Ainv is T's; the inverse is unique, so any elimination serves;
//   - scores are integers: flipping the set F of information positions
//     scores sum_k r_k (m0_k ^ d_k), d the XOR of D's columns in F, m0 =
//     (G u0) != h. At an information position m0 is 0 and d is [j in F],
//     so the score is sum_{j in F} r_{sel_j} plus a weighted popcount over
//     the 112 other (parity) positions, packed in 4 words and weighted by
//     r's 8 bit-planes. With u8 soft symbols every JAX score is this
//     integer, exact in float32;
//   - the winner is the minimum of (score, order, lexicographic index):
//     JAX's argmins take the first minimum, in lexicographic order at
//     every order (order 4 chunk by chunk with strict < across chunks),
//     and a stage replaces the best only when strictly smaller. The key
//     order << 24 | p << 18 | q << 12 | r << 6 | t orders candidates so;
//   - the margin takes the two smallest of the multiset of every
//     candidate's score (score0 and orders 1 to `order`; a tie counts
//     twice), quality = (total - 2 best) / total and margin = (second -
//     first) / total with total = max(sum r, 1e-9), float32 operations on
//     the exact integers, as in the JAX function;
//   - bits: u = u0 ^ (XOR of Ainv's columns in F), u_x = parity(T[x] &
//     (hcol ^ fcol)) with hcol / fcol the pivot columns of the
//     information positions where h is 1 / in F.
// An inactive lane starts done (osd.cu): bits 0, quality 0, margin 0,
// flips 0.
//
// Every phase function takes (tid, nth) and handles items tid, tid + nth,
// ...; the kernel runs them with a barrier between phases, host code with
// (0, 1). `osd_eliminate` holds one barrier per pivot (UWSPR_OSD_SYNC,
// nothing on the host). The flip search (`osd_scan`) takes the thread's
// group (a warp in the kernel) and lane; host code runs every (group,
// lane) of the kernel's split in turn and merges, which gives the
// kernel's result whatever the order.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define UWSPR_OSD_HD __host__ __device__ __forceinline__
#else
#define UWSPR_OSD_HD inline
#endif

#ifdef __CUDA_ARCH__
#define UWSPR_OSD_SYNC() __syncthreads()
#else
#define UWSPR_OSD_SYNC() ((void)0)
#endif

namespace uwspr {
namespace osd {

constexpr int kN = 162;            // coded symbols
constexpr int kK = 50;             // information bits
constexpr int kPar = kN - kK;      // parity positions, 112
constexpr int kWords = 4;          // 32-bit words of the parity positions
constexpr int kSlots = 32 * kWords;
constexpr int kPlanes = 8;         // bit-planes of r (0..128)
constexpr int kPairs = kK * (kK - 1) / 2;   // 1,225
constexpr uint32_t kNone = 0xFFFFFFFFu;

struct alignas(16) Word4 {
  uint32_t w[kWords];
};

// A lane's scratch: shared memory in the kernel, a local in host code.
struct OsdScratch {
  Word4 pd[kPairs];              // pair i = (a, b) in lexicographic order:
  uint32_t pw[kPairs];           //   D[a] ^ D[b], wsel[a] + wsel[b],
  uint16_t pk[kPairs];           //   a << 6 | b
  Word4 d[kK];                   // D's column j over the parity slots
  Word4 planes[kPlanes];         // bit b of r over the parity slots
  Word4 m0;                      // m0 over the parity slots
  uint64_t grow[kN];             // row i of G: bit c = G[i][c]
  uint64_t m[kN];                // rank-ordered G T (rows of info positions
                                 // are left stale once pivoted)
  uint64_t t[kK];                // T: row x = info bit x, bit c = column c
  uint64_t hcol;                 // pivot columns of info positions with h 1
  int32_t r[kN];                 // reliability by position
  int32_t wsel[kK];              // r at info position j
  int32_t total;                 // sum of r
  int16_t idx[kN];               // position of rank k
  int16_t sel[kK];               // rank of info position j
  int16_t slot[kSlots];          // rank of parity slot q, -1 past kPar
  int8_t pc[kK];                 // pivot column of info position j
  uint8_t h[kN];                 // hard decision by position
  uint8_t info[kN];              // rank k is an info position
};

// The best candidate and the two smallest scores of a set of candidates.
struct OsdBest {
  uint32_t m1;    // smallest score (kNone: empty set)
  uint32_t m2;    // second smallest of the multiset
  uint32_t key;   // the winner: order << 24 | indices, 6 bits each
};

UWSPR_OSD_HD int popc32(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}

UWSPR_OSD_HD int popc64(uint64_t v) {
#ifdef __CUDA_ARCH__
  return __popcll(v);
#else
  return __builtin_popcountll(v);
#endif
}

UWSPR_OSD_HD int ctz64(uint64_t v) {
#ifdef __CUDA_ARCH__
  return __ffsll(static_cast<long long>(v)) - 1;
#else
  return __builtin_ctzll(v);
#endif
}

UWSPR_OSD_HD OsdBest osd_empty() { return OsdBest{kNone, kNone, kNone}; }

// Add a candidate, in any order: the winner is the least (score, key),
// and a tie counts twice in the multiset.
UWSPR_OSD_HD void osd_take(OsdBest& b, uint32_t score, uint32_t key) {
  if (score < b.m1 || (score == b.m1 && key < b.key)) {
    b.m2 = b.m1;
    b.m1 = score;
    b.key = key;
  } else if (score < b.m2) {
    b.m2 = score;
  }
}

// The union of two candidate sets (commutative and associative).
UWSPR_OSD_HD OsdBest osd_merge(const OsdBest& a, const OsdBest& b) {
  const bool bf = b.m1 < a.m1 || (b.m1 == a.m1 && b.key < a.key);
  const OsdBest& lo = bf ? b : a;
  const OsdBest& hi = bf ? a : b;
  OsdBest o;
  o.m1 = lo.m1;
  o.key = lo.key;
  o.m2 = lo.m2 < hi.m1 ? lo.m2 : hi.m1;
  return o;
}

// ---- phases -------------------------------------------------------------

// r, h and G's row masks by position. soft: (162,) u8; G: (162, 50) 0/1.
UWSPR_OSD_HD void osd_load(OsdScratch& s, const uint8_t* soft, const float* G,
                           int tid, int nth) {
  for (int i = tid; i < kN; i += nth) {
    const int v = soft[i];
    s.r[i] = v >= 128 ? v - 128 : 128 - v;
    s.h[i] = v >= 128 ? 1 : 0;
    s.info[i] = 0;
    uint64_t row = 0;
    const float* g = G + i * kK;
#pragma unroll
    for (int c = 0; c < kK; ++c)
      if (g[c] > 0.5f) row |= 1ull << c;
    s.grow[i] = row;
  }
}

// rank_i = #{j: r_j > r_i} + #{j < i: r_j == r_i}: the stable descending
// order of r; idx[rank_i] = i.
UWSPR_OSD_HD void osd_rank(OsdScratch& s, int tid, int nth) {
  for (int i = tid; i < kN; i += nth) {
    const int ri = s.r[i];
    int rank = 0;
    for (int j = 0; j < kN; ++j) {
      const int rj = s.r[j];
      rank += (rj > ri) || (rj == ri && j < i);
    }
    s.idx[rank] = static_cast<int16_t>(i);
  }
}

// M = G in rank order, T = I.
UWSPR_OSD_HD void osd_permute(OsdScratch& s, int tid, int nth) {
  for (int k = tid; k < kN; k += nth) s.m[k] = s.grow[s.idx[k]];
  for (int x = tid; x < kK; x += nth) s.t[x] = 1ull << x;
}

// The greedy information set and its column operations (see the head).
// Thread 0 records sel, pc and info; a row is updated by the thread that
// owns it, never during its own row's step, which every thread reads.
UWSPR_OSD_HD void osd_eliminate(OsdScratch& s, int tid, int nth) {
  uint64_t piv = 0;
  int j = 0;
  for (int k = 0; k < kN && j < kK; ++k) {
    const uint64_t row = s.m[k];
    const uint64_t open = row & ~piv;
    if (open == 0) continue;        // dependent on the rows before it
    const int c = ctz64(open);
    const uint64_t bit = 1ull << c;
    const uint64_t other = row & ~bit;
    for (int x = tid; x < kN; x += nth)
      if (x != k && (s.m[x] & bit)) s.m[x] ^= other;
    for (int x = tid; x < kK; x += nth)
      if (s.t[x] & bit) s.t[x] ^= other;
    if (tid == 0) {
      s.sel[j] = static_cast<int16_t>(k);
      s.pc[j] = static_cast<int8_t>(c);
      s.info[k] = 1;
    }
    piv |= bit;
    ++j;
    UWSPR_OSD_SYNC();
  }
}

// Info weights, hcol and total (thread 0), the parity slots in rank order.
UWSPR_OSD_HD void osd_columns(OsdScratch& s, int tid, int nth) {
  for (int j = tid; j < kK; j += nth) s.wsel[j] = s.r[s.idx[s.sel[j]]];
  if (tid == 0) {
    uint64_t hc = 0;
    for (int j = 0; j < kK; ++j)
      if (s.h[s.idx[s.sel[j]]]) hc |= 1ull << s.pc[j];
    s.hcol = hc;
    int total = 0;
    for (int i = 0; i < kN; ++i) total += s.r[i];
    s.total = total;
  }
  for (int k = tid; k < kN; k += nth) {
    if (s.info[k]) continue;
    int before = 0;
    for (int j = 0; j < kK; ++j) before += s.sel[j] < k;
    s.slot[k - before] = static_cast<int16_t>(k);
  }
  for (int q = kPar + tid; q < kSlots; q += nth) s.slot[q] = -1;
}

// D's columns, r's bit-planes and m0 over the parity slots: one word per
// item, 50 x 4 + 8 x 4 + 4 items.
UWSPR_OSD_HD void osd_pack(OsdScratch& s, int tid, int nth) {
  constexpr int kD = kK * kWords, kP = kPlanes * kWords;
  for (int it = tid; it < kD + kP + kWords; it += nth) {
    const int w = it % kWords;
    uint32_t word = 0;
    for (int i = 0; i < 32; ++i) {
      const int k = s.slot[32 * w + i];
      if (k < 0) break;               // the slots past kPar are at the end
      uint32_t b;
      if (it < kD)
        b = static_cast<uint32_t>(s.m[k] >> s.pc[it / kWords]) & 1u;
      else if (it < kD + kP)
        b = static_cast<uint32_t>(s.r[s.idx[k]] >> ((it - kD) / kWords)) & 1u;
      else
        b = static_cast<uint32_t>(popc64(s.m[k] & s.hcol) & 1) ^ s.h[s.idx[k]];
      word |= b << i;
    }
    if (it < kD)
      s.d[it / kWords].w[w] = word;
    else if (it < kD + kP)
      s.planes[(it - kD) / kWords].w[w] = word;
    else
      s.m0.w[w] = word;
  }
}

// Pairs with first element below a: sum_{x < a} (kK - 1 - x).
UWSPR_OSD_HD int osd_pair_start(int a) { return a * (2 * kK - 1 - a) / 2; }

// The pair table: every pair (a, b), a < b, of information positions in
// lexicographic order, with the XOR of their D columns and their weights.
UWSPR_OSD_HD void osd_pairs(OsdScratch& s, int tid, int nth) {
  for (int i = tid; i < kPairs; i += nth) {
    int a = 0;
    while (osd_pair_start(a + 1) <= i) ++a;
    const int b = a + 1 + i - osd_pair_start(a);
    Word4 x;
#pragma unroll
    for (int w = 0; w < kWords; ++w) x.w[w] = s.d[a].w[w] ^ s.d[b].w[w];
    s.pd[i] = x;
    s.pw[i] = static_cast<uint32_t>(s.wsel[a] + s.wsel[b]);
    s.pk[i] = static_cast<uint16_t>((a << 6) | b);
  }
}

// ---- the flip search ----------------------------------------------------

// The parity positions' score of the codeword whose parity mismatch with
// h is y: sum over slots of r * y, by bit-planes.
UWSPR_OSD_HD uint32_t osd_wpop(const uint32_t (&R)[kPlanes][kWords],
                               const Word4& y) {
  uint32_t sum = 0;
#pragma unroll
  for (int b = 0; b < kPlanes; ++b) {
    uint32_t c = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) c += popc32(R[b][w] & y.w[w]);
    sum += c << b;
  }
  return sum;
}

UWSPR_OSD_HD Word4 osd_xor(const Word4& a, const Word4& b) {
  Word4 o;
#pragma unroll
  for (int w = 0; w < kWords; ++w) o.w[w] = a.w[w] ^ b.w[w];
  return o;
}

// One thread's share of every candidate of orders 0 to `order`. The
// threads form `ngroups` groups of `width` lanes (the kernel: 8 warps of
// 32). Orders 1 and 2 split the singles and the pair table over all
// threads. Order 3 deals its leading flip p to the groups, and order 4 its
// leading pair (p, q); within an item the group's lanes split the pairs
// that follow it in the table, so every lane of a warp runs the same
// loop. A candidate's score: its flips' weights plus the weighted
// popcount of m0 ^ its D columns; its key: order << 24 | p << 18 | q << 12
// | r << 6 | t.
UWSPR_OSD_HD OsdBest osd_scan(const OsdScratch& s, int order, int group,
                              int ngroups, int lane, int width) {
  uint32_t R[kPlanes][kWords];
#pragma unroll
  for (int b = 0; b < kPlanes; ++b)
#pragma unroll
    for (int w = 0; w < kWords; ++w) R[b][w] = s.planes[b].w[w];
  const Word4 m0 = s.m0;
  const int tid = group * width + lane, nth = ngroups * width;
  OsdBest best = osd_empty();
  if (tid == 0) osd_take(best, osd_wpop(R, m0), 0u);
  for (int p = tid; p < kK; p += nth)
    osd_take(best, s.wsel[p] + osd_wpop(R, osd_xor(m0, s.d[p])),
             (1u << 24) | (p << 18));
  if (order < 2) return best;
  for (int i = tid; i < kPairs; i += nth)
    osd_take(best, s.pw[i] + osd_wpop(R, osd_xor(m0, s.pd[i])),
             (2u << 24) | (static_cast<uint32_t>(s.pk[i]) << 12));
  if (order < 3) return best;
  for (int p = group; p < kK - 2; p += ngroups) {
    const Word4 xp = osd_xor(m0, s.d[p]);
    const uint32_t wp = s.wsel[p];
    const uint32_t key = (3u << 24) | (p << 18);
    for (int j = osd_pair_start(p + 1) + lane; j < kPairs; j += width)
      osd_take(best, wp + s.pw[j] + osd_wpop(R, osd_xor(xp, s.pd[j])),
               key | (static_cast<uint32_t>(s.pk[j]) << 6));
  }
  if (order < 4) return best;
  for (int i = group; i < kPairs; i += ngroups) {
    const int q = s.pk[i] & 63;
    const Word4 xpq = osd_xor(m0, s.pd[i]);
    const uint32_t wpq = s.pw[i];
    const uint32_t key = (4u << 24) | (static_cast<uint32_t>(s.pk[i]) << 12);
    for (int j = osd_pair_start(q + 1) + lane; j < kPairs; j += width)
      osd_take(best, wpq + s.pw[j] + osd_wpop(R, osd_xor(xpq, s.pd[j])),
               key | s.pk[j]);
  }
  return best;
}

// ---- results ------------------------------------------------------------

// The pivot columns of the winner's flipped info positions XOR hcol: the
// columns whose T entries sum to each info bit.
UWSPR_OSD_HD uint64_t osd_bit_columns(const OsdScratch& s, uint32_t key) {
  uint64_t cols = s.hcol;
  const int n = static_cast<int>(key >> 24);
  for (int i = 0; i < n; ++i)
    cols ^= 1ull << s.pc[(key >> (18 - 6 * i)) & 63];
  return cols;
}

UWSPR_OSD_HD int32_t osd_bit(const OsdScratch& s, uint64_t cols, int x) {
  return popc64(s.t[x] & cols) & 1;
}

UWSPR_OSD_HD void osd_scalars(const OsdScratch& s, const OsdBest& b,
                              float* quality, float* margin,
                              int32_t* flips) {
  const float total = s.total > 0 ? static_cast<float>(s.total) : 1e-9f;
  *quality = (total - 2.0f * static_cast<float>(b.m1)) / total;
  *margin = (static_cast<float>(b.m2) - static_cast<float>(b.m1)) / total;
  *flips = static_cast<int32_t>(b.key >> 24);
}

#ifndef __CUDA_ARCH__
// One lane in host code: the kernel's phases in order on one thread, the
// flip search split over `ngroups` groups of `width` lanes as the kernel's
// threads split it (8 x 32), and merged.
inline void osd_lane_host(OsdScratch& s, const uint8_t* soft, const float* G,
                          int order, int ngroups, int width, int32_t* bits,
                          float* quality, float* margin, int32_t* flips) {
  osd_load(s, soft, G, 0, 1);
  osd_rank(s, 0, 1);
  osd_permute(s, 0, 1);
  osd_eliminate(s, 0, 1);
  osd_columns(s, 0, 1);
  osd_pack(s, 0, 1);
  osd_pairs(s, 0, 1);
  OsdBest best = osd_empty();
  for (int g = 0; g < ngroups; ++g)
    for (int lane = 0; lane < width; ++lane)
      best = osd_merge(best, osd_scan(s, order, g, ngroups, lane, width));
  const uint64_t cols = osd_bit_columns(s, best.key);
  for (int x = 0; x < kK; ++x) bits[x] = osd_bit(s, cols, x);
  osd_scalars(s, best, quality, margin, flips);
}
#endif

}  // namespace osd
}  // namespace uwspr
