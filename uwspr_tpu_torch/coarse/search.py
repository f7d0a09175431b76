"""Coarse candidate search (torch): drift-model bank, smoothed SNR spectrum
and the dense (freq x lag x model) sync grid.

Counterpart of uwspr_tpu/coarse/search.py. ``build_drift_models`` and
``max_peaks`` are numpy; they are carried over because their JAX module
imports jax. The sync grid is the ``conv`` form of ``coarse_score_grid``
(search.py:259-294, the narrowband device path): one dilated 2-D
correlation per A/B powersum plane. The wideband im2col ``einsum`` form is
not ported yet. The drift-model selection lives in ``uwspr_tpu_torch.ops.
select`` (the CUDA kernel and its plain version).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from uwspr_tpu.config import CoarseConfig
from uwspr_tpu.models import slm

MODE_LINEAR = 0
MODE_NONLINEAR = 1

# offsets d in [-4, 4] cover every drift model at the defaults
_D_MIN, _D_MAX = -6, 6
_N_SHIFTS = _D_MAX - _D_MIN + 1


@dataclass
class DriftModelBank:
    """Per-model per-symbol bin offsets + metadata, in reference order."""

    offsets: np.ndarray       # (M, 162) int32 bin offsets (floor of drift/df)
    is_nonlinear: np.ndarray  # (M,) bool
    drift: np.ndarray         # (M,) float32 linear drift value (0 for SLM)
    slm_params: np.ndarray    # (M, 4) float32 (V1, V2, p1, p2); 0 for linear


def build_drift_models(cfg: CoarseConfig) -> DriftModelBank:
    """uwspr_tpu/coarse/search.py:77-107: linear models first, then the 125
    SLM trajectories in generator order."""
    df = cfg.df
    k = np.arange(162)
    rows, nonlin, drifts, params = [], [], [], []
    for drift in range(-cfg.maxdrift, cfg.maxdrift + 1):
        x = (k - 81.0) / 81.0 * drift / (2.0 * df)
        rows.append(np.floor(x).astype(np.int32))
        nonlin.append(False)
        drifts.append(float(drift))
        params.append((0.0, 0.0, 0.0, 0.0))
    if cfg.search_nonlinear:
        t = slm.symbol_times_coarse()
        for v1, v2, p1, p2 in slm.TRAJECTORIES:
            d = slm.slm_frequency_drift(v1, v2, p1, p2, cfg.cf, t)
            x = d.astype(np.float32) / np.float32(df)
            rows.append(np.floor(x).astype(np.int32))
            nonlin.append(True)
            drifts.append(0.0)
            params.append((v1, v2, p1, p2))
    bank = DriftModelBank(
        offsets=np.stack(rows),
        is_nonlinear=np.array(nonlin),
        drift=np.array(drifts, dtype=np.float32),
        slm_params=np.array(params, dtype=np.float32),
    )
    if bank.offsets.min() < _D_MIN or bank.offsets.max() > _D_MAX:
        raise ValueError(f"drift offsets {bank.offsets.min()}.."
                         f"{bank.offsets.max()} exceed [{_D_MIN}, {_D_MAX}]")
    return bank


def max_peaks(cfg: CoarseConfig) -> int:
    """Structural cap on the candidate-lane count: strict local maxima over
    the finpb-2 interior passband bins, never adjacent (search.py:110-119)."""
    return min(cfg.maxfreqs, (2 * cfg.hpbm - 1) // 2)


def smoothed_snr_spectrum(ps: torch.Tensor, *, hpbm: int, m: int,
                          col0: int = 0) -> torch.Tensor:
    """(..., n, ncols) power -> (..., 2*hpbm) SNR-normalized smooth spectrum
    (search.py:145-171). ``col0`` is the absolute column of ps column 0."""
    psavg = ps.sum(dim=-2)
    finpb = 2 * hpbm
    lo = m - hpbm - col0
    pad = F.pad(psavg, (3, 3))
    sm = sum(pad[..., lo + 3 + j: lo + 3 + j + finpb] for j in range(-3, 4))
    srt = torch.sort(sm, dim=-1).values
    noise = srt[..., int(np.floor(0.3 * finpb))]
    snr = sm / noise[..., None] - 1.0
    min_snr = 10.0 ** (-7.0 / 10.0)
    return torch.where(snr < min_snr, 0.1 * min_snr, snr).float()


def powersum_planes(ps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """sqrt-power kernels at every (row, bin): A = sync metric, B = total
    power (powersum(), FDR_impl.cc:188-210), zero outside the spectrum."""
    size = ps.shape[-1]
    pad = F.pad(torch.sqrt(ps), (_D_MAX + 3, _D_MAX + 3))

    def at(d):                      # pad[..., f + d] for f = arange(size)
        return pad[..., _D_MAX + 3 + d: _D_MAX + 3 + d + size]
    A = (at(-1) + at(3)) - (at(-3) + at(1))
    B = at(-3) + at(-1) + at(1) + at(3)
    return A, B


def coarse_score_grid(ps: torch.Tensor, if0: torch.Tensor,
                      offsets: torch.Tensor, sync_sign: torch.Tensor, *,
                      n_lags: int = 26, impl: str = "conv",
                      f_window: tuple[int, int] | None = None,
                      dtype: str = "f32") -> torch.Tensor:
    """Sync correlation over (candidate, freq+/-2, lag, model).

    ps: (B, n, size) power; if0: (B, C) candidate center bins (ps-relative);
    offsets: (M, 162) int bin offsets; sync_sign: (162,) +/-1.
    Returns sync (B, C, 5, n_lags, M) float32 = ss / pow.

    ss[b, m, w, f] = sum_k sign[k] * A[b, w + 2k, f + offs[m, k]], evaluated
    as one correlation with row dilation 2 (the half-symbol lag stride) per
    plane, as search.py:259-294 does with conv_general_dilated. The conv
    runs under ``exact_f32`` on the card (no TF32). ``dtype="bf16"`` rounds
    the A/B planes to bf16 (the one-hot +-1/0 kernels are exact) and still
    accumulates in f32. ``f_window=(lo, hi)`` scores only columns [lo, hi)."""
    if impl != "conv":
        raise NotImplementedError(
            f"coarse grid impl {impl!r} is not ported (only 'conv')")
    size = ps.shape[-1]
    A, B = powersum_planes(ps)
    lo, hi = 0, size
    if f_window is not None:
        lo, hi = max(f_window[0], 0), min(f_window[1], size)
        A, B = A[..., lo:hi], B[..., lo:hi]
    onehot = F.one_hot((offsets - _D_MIN).long(), _N_SHIFTS).float()
    K_ss = (onehot * sync_sign.float()[None, :, None])[:, None]  # (M,1,162,D)
    K_pw = onehot[:, None]
    Ax = F.pad(A, (_D_MAX, -_D_MIN))[:, None]                  # (B,1,n,w+12)
    Bx = F.pad(B, (_D_MAX, -_D_MIN))[:, None]
    if dtype == "bf16":
        Ax = Ax.to(torch.bfloat16).float()
        Bx = Bx.to(torch.bfloat16).float()
    elif dtype != "f32":
        raise ValueError(f"grid dtype {dtype!r}")
    ss = F.conv2d(Ax, K_ss, dilation=(2, 1))[:, :, :n_lags]   # (B,M,w,f)
    pw = F.conv2d(Bx, K_pw, dilation=(2, 1))[:, :, :n_lags]
    # per-candidate frequency gather ifr = if0 + (-2..2), conv-window relative
    ifr = (if0[..., None] + torch.arange(-2, 3, device=ps.device) - lo).long()
    bidx = torch.arange(ps.shape[0], device=ps.device)[:, None, None]
    ss_c = ss[bidx, :, :, ifr]                                 # (B,C,5,M,w)
    pw_c = pw[bidx, :, :, ifr]
    return (ss_c / pw_c).transpose(-1, -2).float()             # (B,C,5,w,M)


__all__ = ["DriftModelBank", "MODE_LINEAR", "MODE_NONLINEAR",
           "build_drift_models", "coarse_score_grid", "max_peaks",
           "powersum_planes", "smoothed_snr_spectrum"]
