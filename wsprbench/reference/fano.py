"""The Fano sequential decoder, one lane at a time in plain Python, and the
two-phase decode of a batch's gated lanes over a pool of processes.

The walk is the classic Fano threshold algorithm for the WSPR K=32 r=1/2
code as wsprd steps it: branch metrics from the (2, 256) soft-decision
table, the better branch first, the threshold tightened by ``delta`` on a
first visit and relaxed when stuck, the last 31 steps the zero tail, and a
timeout after ``maxcycles * 81`` forward looks, a finish on the very last
allowed look counting as a timeout. This module imports numpy only, so a
worker process starts in a fraction of a second.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

POLY1 = 0xF2D05351
POLY2 = 0xE4613C47
NBITS = 81


def fano_lane(symbols, mettab, delta: int, maxcycles: int):
    """162 soft symbols (deinterleaved) -> (success, 10 data bytes)."""
    s = [int(x) for x in symbols]
    m0 = [int(x) for x in mettab[0]]
    m1 = [int(x) for x in mettab[1]]
    met = []
    for k in range(NBITS):
        a, b = s[2 * k], s[2 * k + 1]
        met.append((m0[a] + m0[b], m0[a] + m1[b], m1[a] + m0[b],
                    m1[a] + m1[b]))
    tail = NBITS - 31
    n = NBITS + 1
    gamma, enc, tm0, tm1, br = [0] * n, [0] * n, [0] * n, [0] * n, [0] * n

    def expand(k):
        e = enc[k]
        lsym = ((((e & POLY1).bit_count() & 1) << 1)
                | ((e & POLY2).bit_count() & 1))
        mk = met[k]
        if k >= tail:
            tm0[k] = mk[lsym]
        else:
            a, b = mk[lsym], mk[3 ^ lsym]
            if a > b:
                tm0[k], tm1[k] = a, b
            else:
                tm0[k], tm1[k] = b, a
                enc[k] = e + 1
        br[k] = 0

    k, t, i = 0, 0, 1
    expand(0)
    budget = maxcycles * NBITS
    while i <= budget:
        ng = gamma[k] + (tm1[k] if br[k] else tm0[k])
        if ng >= t:
            if gamma[k] < t + delta:
                while ng >= t + delta:
                    t += delta
            k += 1
            gamma[k] = ng
            enc[k] = (enc[k - 1] << 1) & 0xFFFFFFFF
            if k == NBITS:
                break
            expand(k)
        else:
            while True:
                if k == 0 or gamma[k - 1] < t:
                    t -= delta
                    if br[k]:
                        br[k] = 0
                        enc[k] ^= 1
                    break
                k -= 1
                if k < tail and br[k] != 1:
                    br[k] += 1
                    enc[k] ^= 1
                    break
        i += 1
    data = bytes(enc[7 + 8 * b] & 0xFF for b in range(NBITS >> 3))
    return i < budget, data


def _lane_job(args):
    return fano_lane(*args)


def workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def decode_gated(gate: np.ndarray, deint: np.ndarray, mettab: np.ndarray,
                 delta: int, maxcycles: int, procs: int | None = None
                 ) -> dict:
    """Two-phase decode of (W, C, J) gated lanes with (W, C, J, 162) u8
    symbols: every gated jiggle-0 lane, then every gated lane of a
    candidate whose jiggle-0 lane did not decode. -> {"success" (W, C, J),
    "data" (W, C, J, 10)}; a lane not run reads as not decoded."""
    W, C, J = gate.shape
    succ = np.zeros((W, C, J), bool)
    data = np.zeros((W, C, J, 10), np.uint8)
    procs = workers() if procs is None else procs
    ctx = multiprocessing.get_context("spawn")
    met = np.asarray(mettab)
    with ProcessPoolExecutor(max_workers=procs, mp_context=ctx) as ex:
        for phase in (0, 1):
            if phase == 0:
                todo = [(w, c, 0) for w, c in zip(*np.nonzero(gate[:, :, 0]))]
            else:
                rest = gate.copy()
                rest[:, :, 0] = False
                rest &= ~succ[:, :, :1]
                todo = list(zip(*np.nonzero(rest)))
            jobs = [(deint[w, c, j], met, delta, maxcycles)
                    for w, c, j in todo]
            for (w, c, j), (ok, d) in zip(todo, ex.map(_lane_job, jobs,
                                                       chunksize=1)):
                succ[w, c, j] = ok
                data[w, c, j] = np.frombuffer(d, np.uint8)
    return {"success": succ, "data": data}
