"""The drift-model selection as the literal sequential scan.

Each lane's (freq, lag, model) grid is walked in order with ``best``
starting at -1e30: a linear model is taken when ``v > best``, a nonlinear
(SLM) model when the float32 quotient ``v / best`` exceeds the threshold;
NaN is never taken. Vectorised over lanes only.
"""

from __future__ import annotations

import numpy as np


def select_literal(grid: np.ndarray, is_nl: np.ndarray, threshold: float
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(L, 5, lags, M) float32 -> (best (L,) float32, flat index (L,)
    int64 into (5, lags, M))."""
    L = grid.shape[0]
    M = grid.shape[-1]
    cols = np.ascontiguousarray(
        grid.reshape(L, -1).astype(np.float32, copy=False).T)  # (G*M, L)
    thr = np.float32(threshold)
    best = np.full(L, -1e30, np.float32)
    idx = np.zeros(L, np.int64)
    nl = np.asarray(is_nl, bool)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for n in range(cols.shape[0]):
            v = cols[n]
            acc = (v / best > thr) if nl[n % M] else (v > best)
            np.copyto(best, v, where=acc)
            idx[acc] = n
    return best, idx
