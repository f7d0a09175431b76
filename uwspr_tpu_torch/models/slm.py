"""Straight-Line Model Doppler drift in float32 torch (device pipelines).

The numpy model, its trajectory grid and constants stay in
``uwspr_tpu.models.slm`` and are imported from there.
"""

from __future__ import annotations

import torch

from uwspr_tpu.models.slm import SOUND_SPEED


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


__all__ = ["slm_frequency_drift_torch"]
