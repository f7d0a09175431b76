"""Ordered-statistics decoding (OSD) of the WSPR code — the Fano fallback.

The K=32 r=1/2 convolutional encoding of 50 info bits with a 31-bit zero
tail (protocol.fec_encode.encode_frame_bits) is a LINEAR map GF(2)^50 ->
GF(2)^162, i.e. a (162, 50) block code. Sequential (Fano) decoding has a
sharp computational cutoff around -30 dB: the per-bit metrics get too
noisy for the threshold walk regardless of cycle budget. OSD attacks the
same received word differently: pick the 50 most-reliable linearly
independent code positions, invert the code on them, and re-encode the
hard decisions plus low-order reliability-sorted bit flips; the candidate
codeword closest to the received soft values (reliability-weighted) wins.

This is the technique modern wsprd (K9AN, WSJT-X) added on top of the
1994 Fano decoder to reach below -30 dB; the reference
(michelbarbeau/gr-uwspr, lib/Fano.cc) has no equivalent.

Order-2 OSD here evaluates 1 + 50 + 1225 candidates with three small
dense matrix products — microseconds on the host per failed lane.

Acceptance: OSD ALWAYS returns some codeword, so callers must gate false
decodes. ``OsdResult.quality`` is the reliability-weighted correlation
described at :func:`osd_decode`; noise-only lanes score ~0.65-0.72 at
order 2 (the flip search optimizes the correlation, so even noise looks
correlated), marginal true rescues start ~0.69 and confident ones exceed
0.9 (calibrated in tests/test_osd.py) — quality alone cannot separate
the boundary region. The discriminating screens (:func:`accept_osd`,
calibrated in scripts/osd_calibrate.py -> OSD_CALIB.json on -29..-32 dB
Fano-failed lanes) are:

- ``OsdResult.margin`` — the LIST-DECODING margin, (2nd-best candidate
  score - best) / total reliability. Wrong decodes sit in a flat
  landscape (measured max 0.0175); true rescues usually separate.
- CROSS-JIGGLE AGREEMENT — decode the candidate's two best gated jiggle
  lanes independently; wrong codewords fit one noisy demodulation but
  not two (0/31 wrong decodes agreed vs 11/13 correct).

accept = quality >= osd_min_quality AND (margin >= osd_min_margin OR
(agreement AND margin >= osd_margin_agree)), then protocol unpacking of
the 50-bit payload at egress. The agreement-path margin floor exists
because deeper searches (order 4+) can replicate the SAME wrong
codeword on two correlated lanes, but only where the landscape is flat:
the 5 wrong agreements across OSD_CALIB*.json (orders 3-4, -29..-32 dB)
had margins 0.0013-0.0105, so the floor (0.011, r5) sits above every
measured one. A floor only dominates the events in its calibration
sample — SWEEP_OSD_* artifacts quantify residual false-valid rates
empirically at each SNR.

The port's own copy of uwspr_tpu/fec/osd.py (imports pointed inside
uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from uwspr_tpu_torch.protocol.fec_encode import encode_frame_bits

_G = None            # (162, 50) generator, built lazily


def generator_matrix() -> np.ndarray:
    global _G
    if _G is None:
        G = np.zeros((162, 50), np.uint8)
        for j in range(50):
            e = np.zeros(50, np.uint8)
            e[j] = 1
            G[:, j] = encode_frame_bits(e)
        _G = G
    return _G


def _gf2_basis(Gp: np.ndarray) -> np.ndarray:
    """First 50 linearly independent rows of Gp (162, 50), in row order.

    Returns the selected row indices (50,). Gp's rows are already sorted
    by reliability, so this picks the most-reliable information set."""
    R = Gp.astype(np.uint8).copy()
    n, k = R.shape
    pivots = np.full(k, -1, np.int64)     # pivot row per leading column
    sel = []
    for i in range(n):
        row = R[i].copy()
        while True:
            nz = np.flatnonzero(row)
            if len(nz) == 0:              # dependent on earlier rows
                break
            c = int(nz[0])
            p = pivots[c]
            if p < 0:                     # new pivot: row is independent
                pivots[c] = i
                sel.append(i)
                R[i] = row                # stored reduced, leading col c
                break
            row ^= R[p]                   # eliminate the leading column
        if len(sel) == k:
            break
    assert len(sel) == k, "generator not full rank on these positions"
    return np.asarray(sel)


def _gf2_inv(A: np.ndarray) -> np.ndarray:
    """Inverse of a (k, k) GF(2) matrix by Gauss-Jordan."""
    k = A.shape[0]
    M = np.concatenate([A.astype(np.uint8), np.eye(k, dtype=np.uint8)],
                       axis=1)
    for col in range(k):
        piv = col + int(np.argmax(M[col:, col]))
        assert M[piv, col], "singular"
        if piv != col:
            M[[col, piv]] = M[[piv, col]]
        rows = np.flatnonzero(M[:, col])
        rows = rows[rows != col]
        M[rows] ^= M[col]
    return M[:, k:]


@dataclass
class OsdResult:
    info_bits: np.ndarray     # (50,) uint8
    codeword: np.ndarray      # (162,) uint8
    quality: float            # acceptance margin, see osd_decode
    flips: int                # how many basis-bit flips the winner used
    margin: float = 0.0       # (2nd-best candidate score - best score) /
                              # total reliability: the list-decoding gap.
                              # Near 0 on noise (the candidate landscape
                              # is flat); large when one codeword fits.


def osd_decode(soft: np.ndarray, order: int = 2) -> OsdResult:
    """Soft symbols (162,) in the Fano convention (uint8, >=128 means coded
    bit 1, |x-128| is the reliability) -> the best order-<=2 OSD codeword.

    quality = (sum of reliabilities agreeing with the winner minus the sum
    disagreeing) / total reliability, in [-1, 1] — the correlation of the
    winning codeword with the received word. Noise-only lanes concentrate
    near sqrt(50/162) * sqrt(2/pi)-ish values well below 0.3; true
    codewords at decodable SNR sit far above (tests/test_osd.py).
    """
    soft = np.asarray(soft)
    y = soft.astype(np.float64) - 128.0
    h = (y >= 0).astype(np.uint8)
    r = np.abs(y)

    G = generator_matrix()
    idx = np.argsort(-r, kind="stable")
    sel_sorted = _gf2_basis(G[idx])
    sel = idx[sel_sorted]                 # positions of the information set

    A = G[sel]                            # (50, 50), invertible
    Ainv = _gf2_inv(A)
    u0 = (Ainv @ h[sel]) % 2              # hard-decision info estimate
    c0 = (G @ u0) % 2

    # candidate deltas: flipping basis bit p changes the info word by
    # Ainv[:, p] and the codeword by D[:, p]
    D = (G @ Ainv) % 2                    # (162, 50)
    m0 = (c0 != h)
    s = r * (1.0 - 2.0 * m0)              # cost delta of flipping position i
    score0 = float(r[m0].sum())
    w = s @ D                             # (50,) order-1 score deltas

    best_score = score0
    best_flips: tuple = ()
    # top-2 candidate scores across the whole search, for the
    # list-decoding margin (candidate codewords are all distinct: flip
    # vectors map injectively through the invertible Ainv)
    runner_up = [score0]

    def _track(vals: np.ndarray) -> None:
        k = min(2, len(vals))
        runner_up.extend(np.partition(vals, k - 1)[:k].tolist())

    if order >= 1:
        vals1 = score0 + w
        _track(vals1)
        p = int(np.argmin(vals1))
        if vals1[p] < best_score:
            best_score = float(vals1[p])
            best_flips = (p,)
    if order >= 2:
        M = (D * s[:, None]).T @ D        # (50, 50): M[p,q] = sum D_p D_q s
        pair = score0 + w[:, None] + w[None, :] - 2.0 * M
        iu = np.triu_indices(50, k=1)
        vals2 = pair[iu]
        _track(vals2)
        pi = int(np.argmin(vals2))
        p, q = iu[0][pi], iu[1][pi]
        if pair[p, q] < best_score:
            best_score = float(pair[p, q])
            best_flips = (int(p), int(q))
    if order >= 3:
        # delta(S) = sum_i d_i(S) s_i = (T_s - q(S)) / 2 with
        # q(S) = sum_i s_i prod_{p in S} E_ip, E = 1 - 2D in +/-1 —
        # so all C(50,3) triples are one einsum
        E = (1.0 - 2.0 * D).astype(np.float32)
        sE = E * s[:, None].astype(np.float32)
        q3 = np.einsum("ip,iq,ir->pqr", E, E, sE, optimize=True)
        T_s = float(s.sum())
        kk = np.arange(50)
        strict = ((kk[:, None, None] < kk[None, :, None])
                  & (kk[None, :, None] < kk[None, None, :]))
        vals = q3[strict]                 # lexicographic (p, q, r) order
        scores3 = score0 + (T_s - vals) / 2.0
        _track(scores3)
        k = int(np.argmax(vals))          # first max = min score
        if scores3[k] < best_score:
            best_score = float(scores3[k])
            tp, tq, tr = np.nonzero(strict)
            best_flips = (int(tp[k]), int(tq[k]), int(tr[k]))
    if order >= 4:
        from itertools import combinations
        sf = s.astype(np.float32)
        Du = D.astype(np.uint8)
        for wgt in range(4, min(order, 6) + 1):
            combos = np.fromiter(
                (i for c in combinations(range(50), wgt) for i in c),
                np.int32).reshape(-1, wgt)
            for lo in range(0, len(combos), 100_000):
                blk = combos[lo:lo + 100_000]
                d = Du[:, blk[:, 0]]
                for col in range(1, wgt):
                    d = d ^ Du[:, blk[:, col]]
                scores = score0 + sf @ d.astype(np.float32)
                _track(scores)
                k = int(np.argmin(scores))
                if scores[k] < best_score:
                    best_score = float(scores[k])
                    best_flips = tuple(int(x) for x in blk[k])

    u = u0.copy()
    c = c0.copy()
    for p in best_flips:
        u ^= Ainv[:, p]
        c ^= D[:, p].astype(np.uint8)
    total = float(r.sum()) or 1.0
    quality = (total - 2.0 * best_score) / total
    second = np.partition(np.asarray(runner_up), 1)[1]
    margin = float(second - best_score) / total
    return OsdResult(info_bits=u.astype(np.uint8), codeword=c,
                     quality=quality, flips=len(best_flips),
                     margin=margin)


def accept_osd(deint_lanes: np.ndarray, gate: np.ndarray,
               sync2: np.ndarray, dcfg) -> tuple[int, bytes | None]:
    """The calibrated OSD acceptance rule, shared by the host and hybrid
    engines (the device engine implements the same rule in
    pipeline/jit_decoder._osd_rescue).

    deint_lanes (J, 162): the candidate's deinterleaved soft symbols per
    jiggle lane; gate/sync2 (J,). Decodes the best-synced gated lane;
    accepts iff quality >= dcfg.osd_min_quality AND (the best lane's
    list-decoding margin >= dcfg.osd_min_margin, OR an OSD decode of the
    2nd-best gated lane yields the SAME payload AND margin >=
    dcfg.osd_margin_agree). Calibrated on -29..-32 dB Fano-failed lanes
    (scripts/osd_calibrate.py, OSD_CALIB*.json): order-3 wrong decodes
    never agreed cross-jiggle at -29/-30 (0/31) and had margin <=
    0.0175; wrong decodes that DID agree (orders 3-4, -30..-32) had
    margin <= 0.0105, below the 0.011 agreement-path floor.

    Returns (jiggle_index, payload bytes) or (jiggle_index, None)."""
    from uwspr_tpu_torch.protocol.fec_encode import bits_to_bytes

    order = dcfg.osd_depth
    skey = np.where(gate, sync2, -np.inf)
    j = int(np.argmax(skey))
    r = osd_decode(deint_lanes[j], order=order)
    if r.quality < dcfg.osd_min_quality:
        return j, None
    accept = r.margin >= dcfg.osd_min_margin
    if (not accept and r.margin >= dcfg.osd_margin_agree
            and gate.sum() >= 2):
        skey[j] = -np.inf
        j2 = int(np.argmax(skey))
        r2 = osd_decode(deint_lanes[j2], order=order)
        accept = bool(np.array_equal(r2.info_bits, r.info_bits))
    if not accept:
        return j, None
    return j, bytes(bits_to_bytes(r.info_bits)[:7])


__all__ = ["osd_decode", "OsdResult", "accept_osd", "generator_matrix"]
