"""Ordered-statistics decoding (order <= 4) of the WSPR code, one lane at a
time, in numpy.

The K=32 rate-1/2 convolutional code over 50 information bits and a 31-bit
zero tail, truncated to its 162 coded bits, is a linear (162, 50) block
code; its generator is built here from the two polynomials by encoding
each unit information vector. The decoder follows Fossorier and Lin,
"Soft-decision decoding of linear block codes based on ordered
statistics" (IEEE Trans. Inf. Theory 41(5), 1995):

1. order the 162 positions by reliability |soft - 128|, most reliable
   first;
2. take the most reliable information set: the first 50 positions in that
   order whose rows of the generator are linearly independent (Gaussian
   elimination over GF(2));
3. re-encode the hard decisions on the information set, and then every
   pattern of at most ``order`` flipped information bits; each candidate
   codeword scores the reliability summed over the positions where it
   disagrees with the hard decisions (the correlation discrepancy);
4. the least score wins.

Soft symbols are in the Fano decoder's convention: a u8 value >= 128 is a
coded 1, and |x - 128| its reliability. Every score is then an integer,
and every sum below is exact.

Departures from the published description, each a rule the description
leaves open or a number it does not define:

- ties: the reliability sort is stable (equal reliabilities keep position
  order); the information set is the greedy independent set in that
  order; information bits are indexed by their rank in it; among equal
  scores the fewer flips win, and among patterns of one weight the first
  in lexicographic order of the flipped indices, so an order-4 pattern
  replaces the best only when strictly smaller;
- no early stop and no reprocessing bound: every pattern of weight up to
  ``order`` is scored (the published probabilistic skip rules are left
  out);
- a candidate's score is taken over the 112 positions outside the
  information set plus the flipped information positions' reliabilities,
  since a flip changes exactly its own information position there;
- two numbers the description does not have, for the callers' acceptance
  rule: quality = (total - 2 best) / total and margin = (second - best) /
  total, with best and second the two smallest scores of the multiset of
  every candidate's score (a tie counts twice) and total the summed
  reliability (1e-9 where it is 0), each computed in float32.

It imports numpy alone.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np

from wsprbench.reference.protocol import N_CODED_BITS, POLY1, POLY2

N = 2 * N_CODED_BITS          # 162 coded bits
K = 50                        # information bits


def encode(info: np.ndarray) -> np.ndarray:
    """50 information bits -> the 162 coded bits (parity of the state under
    POLY1, then POLY2, for each of the 81 input bits, the last 31 zero)."""
    state, out = 0, []
    for b in list(info) + [0] * (N_CODED_BITS - K):
        state = ((state << 1) | int(b)) & 0xFFFFFFFF
        out += [(state & POLY1).bit_count() & 1,
                (state & POLY2).bit_count() & 1]
    return np.asarray(out, np.uint8)


def generator() -> np.ndarray:
    """(162, 50) 0/1: column j is the codeword of information bit j."""
    return np.stack([encode(np.eye(K, dtype=np.uint8)[j])
                     for j in range(K)], axis=1)


_G = generator()
_PAIRS = np.array(list(combinations(range(K), 2)))          # (1225, 2)


def _rows(M: np.ndarray) -> list:
    """0/1 rows -> Python integers, bit c = column c."""
    return [int(sum(1 << c for c in np.flatnonzero(row))) for row in M]


def information_set(order_pos: np.ndarray) -> np.ndarray:
    """Positions in reliability order -> the first 50 whose generator rows
    are linearly independent, in that order (row reduction over GF(2))."""
    basis = {}                           # leading bit -> reduced row
    chosen = []
    for pos, row in zip(order_pos, _rows(_G[order_pos])):
        while row:
            lead = row.bit_length() - 1
            if lead not in basis:
                basis[lead] = row
                chosen.append(pos)
                break
            row ^= basis[lead]
        if len(chosen) == K:
            break
    return np.asarray(chosen)


def gf2_inverse(A: np.ndarray) -> np.ndarray:
    """(50, 50) invertible 0/1 -> its inverse over GF(2) (Gauss-Jordan on
    integer rows [A | I])."""
    rows = [r | (1 << (K + i)) for i, r in enumerate(_rows(A))]
    for c in range(K):
        p = next(i for i in range(c, K) if rows[i] >> c & 1)
        rows[c], rows[p] = rows[p], rows[c]
        for i in range(K):
            if i != c and rows[i] >> c & 1:
                rows[i] ^= rows[c]
    return np.array([[r >> (K + j) & 1 for j in range(K)] for r in rows],
                    np.uint8)


def decode(soft: np.ndarray, order: int) -> dict:
    """(162,) u8 soft symbols -> {"bits" (50,) int32, "flips", "quality",
    "margin" (float32)} of the order-``order`` decode."""
    if order not in (1, 2, 3, 4):
        raise ValueError(f"OSD order {order} not in 1..4")
    y = np.asarray(soft).astype(np.int64) - 128
    hard = (y >= 0).astype(np.uint8)
    rel = np.abs(y)
    info = information_set(np.argsort(-rel, kind="stable"))
    Ainv = gf2_inverse(_G[info])
    u0 = Ainv.astype(np.int64) @ hard[info] % 2
    c0 = _G.astype(np.int64) @ u0 % 2
    D = _G.astype(np.int64) @ Ainv % 2              # codeword of each flip
    par = np.setdiff1d(np.arange(N), info)          # the 112 others
    m0 = (c0[par] != hard[par]).astype(np.float32)
    r = rel[par].astype(np.float32)
    wi = rel[info].astype(np.float32)               # a flip's own cost
    Dp = D[par].T.astype(np.float32)                # (50, 112)

    def score(x):
        """Parity-position scores of candidates whose mismatch with the
        hard decisions is m0 ^ x, x (n, 112) 0/1: sum r (m0 + x - 2 m0 x)."""
        return r @ m0 + x @ r - 2.0 * x @ (m0 * r)

    # every weight's scores as a flat array in lexicographic order, and
    # its patterns: weight 0, singles, pairs, (single, following pair),
    # (pair, following pair)
    P2 = (Dp[_PAIRS[:, 0]] + Dp[_PAIRS[:, 1]]) % 2        # (1225, 112)
    w2 = wi[_PAIRS[:, 0]] + wi[_PAIRS[:, 1]]
    stages = [(np.array([r @ m0], np.float32), lambda i: ())]
    stages.append((wi + score(Dp), lambda i: (i,)))
    if order >= 2:
        stages.append((w2 + score(P2), lambda i: tuple(_PAIRS[i])))
    if order >= 3:
        s3 = _cross(Dp, wi, P2, w2, r, m0, _PAIRS[None, :, 0]
                    > np.arange(K)[:, None])
        stages.append((s3, lambda i: (i // len(_PAIRS),)
                       + tuple(_PAIRS[i % len(_PAIRS)])))
    if order >= 4:
        s4 = _cross(P2, w2, P2, w2, r, m0, _PAIRS[None, :, 0]
                    > _PAIRS[:, 1, None])
        stages.append((s4, lambda i: tuple(_PAIRS[i // len(_PAIRS)])
                       + tuple(_PAIRS[i % len(_PAIRS)])))

    best, flips = np.float32(np.inf), ()
    two = []
    for vals, pattern in stages:
        i = int(np.argmin(vals))                    # first minimum
        if vals[i] < best:                          # strictly smaller
            best, flips = vals[i], pattern(i)
        two.extend(np.partition(vals, 1)[:2] if vals.size > 1 else vals)
    lo = np.sort(np.asarray(two, np.float32))[:2]
    e = np.zeros(K, np.int64)
    e[list(flips)] = 1
    bits = Ainv.astype(np.int64) @ ((hard[info] + e) % 2) % 2
    total = np.float32(rel.sum()) if rel.sum() > 0 else np.float32(1e-9)
    return {"bits": bits.astype(np.int32), "flips": len(flips),
            "quality": np.float32((total - np.float32(2.0) * lo[0]) / total),
            "margin": np.float32((lo[1] - lo[0]) / total)}


def _cross(X, wx, Y, wy, r, m0, keep):
    """Scores of every (row of X, row of Y) pair whose flips are disjoint
    and in order (``keep``), the rest +inf, flattened row-major: the
    candidate's mismatch is m0 ^ x ^ y, and with a = m0 ^ x,
    sum r (a ^ y) = r.a + r.y - 2 (a r).y."""
    A = (m0[None, :] + X) % 2
    S = (wx[:, None] + wy[None, :] + (A @ r)[:, None] + (Y @ r)[None, :]
         - 2.0 * (A * r) @ Y.T)
    return np.where(keep, S, np.inf).astype(np.float32).reshape(-1)


def decode_lanes(soft: np.ndarray, order: int) -> dict:
    """(L, 162) u8 -> {"bits" (L, 50), "flips" (L,), "quality" (L,),
    "margin" (L,)}."""
    outs = [decode(s, order) for s in np.asarray(soft)]
    return {k: np.asarray([o[k] for o in outs]) for k in
            ("bits", "flips", "quality", "margin")}


def payload(bits: np.ndarray) -> np.ndarray:
    """(..., 50) information bits -> (..., 7) u8: MSB first in each byte,
    the last 6 bits zero."""
    pad = np.zeros(bits.shape[:-1] + (6,), np.uint8)
    return np.packbits(np.concatenate([bits.astype(np.uint8), pad], -1),
                       axis=-1)
