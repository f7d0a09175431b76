"""Straight-Line Model (SLM): nonlinear underwater Doppler frequency drift.

The port's own copy of the numpy model of uwspr_tpu/models/slm.py (held
equal to it by tests/test_torch_copies.py), plus its float32 torch form for
the device pipelines.

A vehicle moving on a straight-line trajectory q(t) = V*t + p induces a
Doppler shift f_drift(t) = -(V . q(t)) / ||q(t)|| * cf / c with sound speed
c = 1500 m/s (Eq. 16 of the companion paper; reference lib/slm.cc:36-73 —
note the reference's -Sign*|x| construction is algebraically just -x).

The trajectory search grid enumerates 5x5x5 = 125 (V1, V2, p2) triples with
p1 = 0, in the exact order of the reference generator (lib/slm.cc:76-116):
p2 varies fastest (50..850 step 200), then V1 (-2..2 step 1), then V2.
"""

from __future__ import annotations

import numpy as np
import torch

SOUND_SPEED = 1500.0  # m/s

# Generator grid (lib/slm.cc:79-87)
V1_VALUES = np.arange(-2.0, 2.0 + 1e-9, 1.0)       # 5
V2_VALUES = np.arange(-2.0, 2.0 + 1e-9, 1.0)       # 5
P2_VALUES = np.arange(50.0, 850.0 + 1e-9, 200.0)   # 5
N_TRAJECTORIES = len(V1_VALUES) * len(V2_VALUES) * len(P2_VALUES)  # 125


def slm_frequency_drift(v1, v2, p1, p2, cf, t):
    """Doppler drift in Hz. Vectorized over any broadcastable arguments.

    Matches lib/slm.cc:36-73 including the ||q|| == 0 -> 0 special case.
    """
    v1 = np.asarray(v1, dtype=np.float64)
    q1 = v1 * t + p1
    q2 = np.asarray(v2, dtype=np.float64) * t + p2
    num = v1 * q1 + np.asarray(v2, dtype=np.float64) * q2
    den = np.sqrt(q1 * q1 + q2 * q2)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(den == 0.0, 0.0, -num / np.where(den == 0, 1.0, den)
                       * (cf / SOUND_SPEED))
    return out


def slm_frequency_drift_torch(v1: torch.Tensor, v2: torch.Tensor,
                              p1: torch.Tensor, p2: torch.Tensor, cf: float,
                              t: torch.Tensor) -> torch.Tensor:
    """Counterpart of uwspr_tpu.models.slm.slm_frequency_drift_jnp: the same
    float32 operations in the same order, including ||q|| == 0 -> 0."""
    q1 = v1 * t + p1
    q2 = v2 * t + p2
    num = v1 * q1 + v2 * q2
    den = torch.sqrt(q1 * q1 + q2 * q2)
    zero = den == 0.0
    return torch.where(zero, 0.0, -num / torch.where(zero, 1.0, den)
                       * (cf / SOUND_SPEED))


def trajectory_grid() -> np.ndarray:
    """(125, 4) float64 array of (V1, V2, p1, p2) in reference generator order.

    Order: index = iV2 * 25 + iV1 * 5 + ip2 (p2 fastest; lib/slm.cc:89-115).
    """
    out = np.empty((N_TRAJECTORIES, 4), dtype=np.float64)
    i = 0
    for v2 in V2_VALUES:
        for v1 in V1_VALUES:
            for p2 in P2_VALUES:
                out[i] = (v1, v2, 0.0, p2)
                i += 1
    return out


TRAJECTORIES = trajectory_grid()


def drift_table(cf: float, times: np.ndarray) -> np.ndarray:
    """(125, len(times)) drift in Hz for every trajectory at given times."""
    t = np.asarray(times, dtype=np.float64)[None, :]
    v1 = TRAJECTORIES[:, 0:1]
    v2 = TRAJECTORIES[:, 1:2]
    p1 = TRAJECTORIES[:, 2:3]
    p2 = TRAJECTORIES[:, 3:4]
    return slm_frequency_drift(v1, v2, p1, p2, cf, t)


def symbol_times_coarse(n_symbols: int = 162) -> np.ndarray:
    """t = k * 111 // 162 — the coarse search's integer-truncated symbol time.

    The reference maps symbol index to *whole seconds* via C integer division
    (lib/FDR_impl.cc:382: ``t = k * 111 / 162`` with int operands).
    """
    return (np.arange(n_symbols) * 111 // 162).astype(np.float64)


__all__ = [
    "SOUND_SPEED", "N_TRAJECTORIES", "TRAJECTORIES", "slm_frequency_drift",
    "slm_frequency_drift_torch", "trajectory_grid", "drift_table",
    "symbol_times_coarse",
]
