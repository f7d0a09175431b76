"""Pure-Python Fano sequential decoder — the bit-exact oracle.

A from-scratch implementation of the classic Fano threshold algorithm for
the WSPR K=32 r=1/2 code, with stepping rules matched to the reference
decoder (lib/Fano.cc:110-252):

- branch metrics per trellis step from the (2,256) soft metric table;
- 0/1 branches sorted best-first (polynomials are odd, so the two branch
  symbol pairs are complements);
- threshold tightening in ``delta`` steps on first visit, relax-on-stuck;
- the last 31 steps are the all-zero tail (0-branch only);
- timeout after ``maxcycles * nbits`` forward-look cycles, including the
  reference quirk that finishing on the very last allowed cycle still
  reports timeout (Fano.cc:250).

This is the semantics oracle for the native C++ and batched JAX backends.
It is intentionally simple, not fast.

The port's own copy of uwspr_tpu/fec/fano_ref.py (imports pointed inside
uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from uwspr_tpu_torch.protocol.constants import FANO_METTAB, N_CODED_BITS, POLY1, POLY2


def _encode_sym(state: int) -> int:
    """2-bit branch symbol (POLY1 bit in the 2s place) for a 32-bit state."""
    s1 = bin(state & POLY1).count("1") & 1
    s2 = bin(state & POLY2).count("1") & 1
    return (s1 << 1) | s2


@dataclass
class FanoResult:
    success: bool
    data: np.ndarray          # (nbits//8,) decoded bytes (50 bits + zero pad)
    metric: int
    cycles: int
    maxnp: int


def fano_decode(symbols: np.ndarray, mettab: np.ndarray = FANO_METTAB,
                delta: int = 60, maxcycles: int = 10000,
                nbits: int = N_CODED_BITS) -> FanoResult:
    """Decode 2*nbits soft symbols (deinterleaved, coded-bit order)."""
    symbols = np.asarray(symbols, dtype=np.int64)
    assert symbols.shape == (2 * nbits,)
    m0 = mettab[0]
    m1 = mettab[1]
    s0 = symbols[0::2]
    s1 = symbols[1::2]
    # metrics[k][j]: j = (poly1_bit<<1)|poly2_bit hypothesis at trellis step k
    metrics = np.stack([
        m0[s0] + m0[s1],
        m0[s0] + m1[s1],
        m1[s0] + m0[s1],
        m1[s0] + m1[s1],
    ], axis=1).astype(np.int64)

    tail = nbits - 31          # first node index of the all-zero tail
    gamma = np.zeros(nbits + 1, dtype=np.int64)
    encstate = np.zeros(nbits + 1, dtype=np.uint64)
    tm = np.zeros((nbits + 1, 2), dtype=np.int64)
    branch = np.zeros(nbits + 1, dtype=np.int64)   # np->i
    mask32 = 0xFFFFFFFF

    def expand(k: int) -> None:
        """Compute sorted branch metrics for node k (whose encstate holds the
        0-branch state); sets tm[k], may set the low encstate bit."""
        lsym = _encode_sym(int(encstate[k]) & mask32)
        if k >= tail:
            tm[k][0] = metrics[k][lsym]
        else:
            a = metrics[k][lsym]
            b = metrics[k][3 ^ lsym]
            if a > b:
                tm[k][0], tm[k][1] = a, b
            else:
                tm[k][0], tm[k][1] = b, a
                encstate[k] = np.uint64(int(encstate[k]) + 1)
        branch[k] = 0

    k = 0
    expand(0)
    gamma[0] = 0
    t = 0
    budget = maxcycles * nbits
    maxnp = 0
    i = 1
    while i <= budget:
        maxnp = max(maxnp, k)
        ngamma = gamma[k] + tm[k][branch[k]]
        if ngamma >= t:
            if gamma[k] < t + delta:
                while ngamma >= t + delta:
                    t += delta
            gamma[k + 1] = ngamma
            encstate[k + 1] = np.uint64((int(encstate[k]) << 1) & ((1 << 64) - 1))
            k += 1
            if k == nbits:
                break
            expand(k)
        else:
            while True:
                if k == 0 or gamma[k - 1] < t:
                    t -= delta
                    if branch[k] != 0:
                        branch[k] = 0
                        encstate[k] = np.uint64(int(encstate[k]) ^ 1)
                    break
                k -= 1
                if k < tail and branch[k] != 1:
                    branch[k] += 1
                    encstate[k] = np.uint64(int(encstate[k]) ^ 1)
                    break
        i += 1

    nbytes = nbits >> 3
    data = np.array([int(encstate[7 + 8 * b]) & 0xFF for b in range(nbytes)],
                    dtype=np.uint8)
    return FanoResult(success=i < budget, data=data, metric=int(gamma[k]),
                      cycles=i + 1, maxnp=maxnp)


__all__ = ["fano_decode", "FanoResult"]
