"""Coarse candidate search (torch): drift-model bank, smoothed SNR spectrum,
peak pick, the dense (freq x lag x model) sync grid and the host engine's
``CoarseSearch``.

Counterpart of uwspr_tpu/coarse/search.py. ``build_drift_models``,
``max_peaks``, ``Candidates`` and ``detect_peaks`` are numpy; they are
carried over because their JAX module imports jax. The sync grid has both
forms of ``coarse_score_grid``: ``conv`` (search.py:259-294, the narrowband
device path), one dilated 2-D correlation per A/B powersum plane, and the
im2col ``einsum`` (search.py:295-339) that the host ``CoarseSearch`` and
the wideband device engine use. The drift-model selection lives in
``uwspr_tpu_torch.ops.select`` (the CUDA kernel and its plain version).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from uwspr_tpu_torch.config import CoarseConfig
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.models import slm
from uwspr_tpu_torch.ops.select import select_best
from uwspr_tpu_torch.ops.stft import stft_constants, stft_power
from uwspr_tpu_torch.protocol.constants import SYNC_VECTOR

MODE_LINEAR = 0
MODE_NONLINEAR = 1

# offsets d in [-4, 4] cover every drift model at the defaults
_D_MIN, _D_MAX = -6, 6
_N_SHIFTS = _D_MAX - _D_MIN + 1
# bytes of im2col copies per chunk of windows (113 MB per window at full
# width in float32, 3.6 GB per plane at W = 32)
_IM2COL_BYTES = 1 << 30


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


@dataclass
class Candidates:
    """Padded candidate batch (maxfreqs lanes + validity mask),
    search.py:122-137."""

    valid: np.ndarray        # (C,) bool
    freq: np.ndarray         # (C,) float32  baseband Hz (tuned)
    snr: np.ndarray          # (C,) float32  6 Hz SNR, dB
    sync: np.ndarray         # (C,) float32  coarse sync score
    shift: np.ndarray        # (C,) int32    time offset, samples (128*k0)
    mode: np.ndarray         # (C,) int32    MODE_LINEAR / MODE_NONLINEAR
    drift: np.ndarray        # (C,) float32  linear drift (symbols/frame)
    slm_params: np.ndarray   # (C, 4) float32 (V1, V2, p1, p2)

    @property
    def n(self) -> int:
        return int(self.valid.sum())


def detect_peaks(smspec: np.ndarray, cfg: CoarseConfig
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host peak pick (search.py:174-198): (valid (C,), absolute bin if0
    (C,), snr_db (C,)). Strict local maxima in ascending frequency capped
    at maxfreqs, then stably sorted by SNR descending."""
    finpb = 2 * cfg.hpbm
    C = cfg.maxfreqs
    s = np.asarray(smspec)
    j = np.arange(1, finpb - 1)
    is_peak = (s[j] > s[j - 1]) & (s[j] > s[j + 1])
    peaks = j[is_peak][:C]
    snr = 10.0 * np.log10(s[peaks])
    order = np.argsort(-snr, kind="stable")
    peaks, snr = peaks[order], snr[order]
    valid = np.zeros(C, dtype=bool)
    if0 = np.zeros(C, dtype=np.int32)
    out_snr = np.zeros(C, dtype=np.float32)
    npk = len(peaks)
    valid[:npk] = True
    if0[:npk] = peaks - cfg.hpbm + cfg.fft_size // 2
    out_snr[:npk] = snr
    return valid, if0, out_snr


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

    ss[b, m, w, f] = sum_k sign[k] * A[b, w + 2k, f + offs[m, k]]. Two
    forms, equal up to f32 summation order (search.py:220-238):

    - ``impl="conv"``: one correlation with row dilation 2 (the half-symbol
      lag stride) per plane, as search.py:259-294 does with
      conv_general_dilated;
    - ``impl="einsum"``: the im2col gather XA[b, w, k, d, f] = A[b, w + 2k,
      f + d] contracted against the one-hot (symbol, shift) weights
      (search.py:295-339), the host CoarseSearch's form.

    Both run under ``exact_f32`` on the card (no TF32). ``dtype="bf16"``
    rounds the A/B planes to bf16 (the one-hot +-1/0 weights are exact) and
    still accumulates in f32. ``f_window=(lo, hi)`` scores only columns
    [lo, hi). Candidate columns if0 + (-2..2) index as the JAX gather does:
    a negative column wraps once (a padded lane at bin 0 reads the top
    columns) and then every column clamps to the window (at wideband a lane
    at the top bin reaches past it). The einsum builds its im2col copies
    for at most _IM2COL_BYTES of windows at a time."""
    if impl not in ("conv", "einsum"):
        raise ValueError(f"coarse grid impl {impl!r}")
    size = ps.shape[-1]
    A, B = powersum_planes(ps)
    lo, hi = 0, size
    if f_window is not None:
        lo, hi = max(f_window[0], 0), min(f_window[1], size)
        A, B = A[..., lo:hi], B[..., lo:hi]
    if dtype == "bf16":
        A = A.to(torch.bfloat16).float()
        B = B.to(torch.bfloat16).float()
    elif dtype != "f32":
        raise ValueError(f"grid dtype {dtype!r}")
    onehot = F.one_hot((offsets - _D_MIN).long(), _N_SHIFTS).float()
    W_ss = onehot * sync_sign.float()[None, :, None]            # (M,162,D)
    # per-candidate frequency gather ifr = if0 + (-2..2), window relative
    width = hi - lo
    ifr = (if0[..., None] + torch.arange(-2, 3, device=ps.device) - lo).long()
    ifr = torch.where(ifr < 0, ifr + width, ifr).clamp(0, width - 1)
    bidx = torch.arange(ps.shape[0], device=ps.device)[:, None, None]
    if impl == "conv":
        Ax = F.pad(A, (_D_MAX, -_D_MIN))[:, None]              # (B,1,n,w+12)
        Bx = F.pad(B, (_D_MAX, -_D_MIN))[:, None]
        ss = F.conv2d(Ax, W_ss[:, None], dilation=(2, 1))[:, :, :n_lags]
        pw = F.conv2d(Bx, onehot[:, None], dilation=(2, 1))[:, :, :n_lags]
        ss_c = ss[bidx, :, :, ifr]                             # (B,C,5,M,w)
        pw_c = pw[bidx, :, :, ifr]
        return (ss_c / pw_c).transpose(-1, -2).float()         # (B,C,5,w,M)
    n = ps.shape[-2]
    if n < 2 * 162 + n_lags - 2:
        raise ValueError(f"{n} spectrum rows are too few for {n_lags} lags")

    def im2col(X):                  # (b, n, w) -> (b, lags, 162, D, w)
        pad = F.pad(X, (_N_SHIFTS, _N_SHIFTS))
        off0 = _D_MIN + _N_SHIFTS
        S = torch.stack([pad[..., d + off0:d + off0 + width]
                         for d in range(_N_SHIFTS)], dim=-2)   # (b,n,D,w)
        return torch.stack([S[:, k0:k0 + 2 * 162:2] for k0 in range(n_lags)],
                           dim=1)
    step = max(1, _IM2COL_BYTES // (n_lags * 162 * _N_SHIFTS * width * 4))
    out = []
    for b0 in range(0, ps.shape[0], step):
        sl = slice(b0, b0 + step)
        ss = torch.einsum("mkd,bwkdf->bwmf", W_ss, im2col(A[sl]))  # (b,w,M,f)
        pw = torch.einsum("mkd,bwkdf->bwmf", onehot, im2col(B[sl]))
        bi, fi = bidx[:ss.shape[0]], ifr[sl]
        out.append(ss[bi, :, :, fi] / pw[bi, :, :, fi])          # (b,C,5,w,M)
    return torch.cat(out).float()


class CoarseSearch:
    """The host engine's coarse search over one 45000-sample window
    (search.py:607-652) on ``device``: FFT STFT power, smoothed SNR
    spectrum, host peak pick, the f32 einsum sync grid over all maxfreqs
    lanes and the exact selection (the CUDA kernel on the card). ``models``
    is the drift-model bank, by default built from ``cfg``."""

    def __init__(self, cfg: CoarseConfig | None = None, *,
                 device: str | torch.device,
                 models: DriftModelBank | None = None):
        self.cfg = cfg or CoarseConfig()
        if not isinstance(self.cfg, CoarseConfig):
            raise TypeError(f"cfg must be uwspr_tpu_torch.config."
                            f"CoarseConfig, got {type(cfg).__module__}."
                            f"{type(cfg).__name__}")
        if self.cfg.halfbandwidth > self.cfg.fs // 2:
            raise ValueError("halfbandwidth must be below fs/2")
        self.device = resolve_device(device)
        self.models = models if models is not None \
            else build_drift_models(self.cfg)
        sign = 2.0 * SYNC_VECTOR.astype(np.float32) - 1.0
        # constants moved to the device once per search object
        self._offsets = torch.from_numpy(self.models.offsets).to(self.device)
        self._is_nl = torch.from_numpy(self.models.is_nonlinear).to(
            self.device)
        self._sign = torch.from_numpy(sign).to(self.device)
        self._stft = stft_constants(self.cfg.fft_size, None, self.device)

    def power_spectrum(self, z: np.ndarray) -> torch.Tensor:
        cfg = self.cfg
        return stft_power(z, n_ffts=cfg.n_ffts, size=cfg.fft_size,
                          hop=cfg.spb // 2, device=self.device,
                          consts=self._stft)

    def __call__(self, z: np.ndarray) -> Candidates:
        """One window -> candidate batch."""
        cfg = self.cfg
        ps = self.power_spectrum(z)
        sm = smoothed_snr_spectrum(ps, hpbm=cfg.hpbm, m=cfg.fft_size // 2)
        valid, if0, snr = detect_peaks(sm.cpu().numpy(), cfg)
        sync = coarse_score_grid(
            ps[None], torch.from_numpy(if0)[None].to(self.device),
            self._offsets, self._sign, impl="einsum")[0]
        best, best_idx = select_best(sync, self._is_nl,
                                     threshold=float(cfg.threshold))
        best = best.cpu().numpy()
        best_idx = best_idx.cpu().numpy()
        Mdim = self.models.offsets.shape[0]
        fi = best_idx // (26 * Mdim)
        k0 = (best_idx // Mdim) % 26
        mm = best_idx % Mdim
        freq = (if0 + (fi - 2) - cfg.fft_size // 2) * cfg.df
        return Candidates(
            valid=valid,
            freq=freq.astype(np.float32),
            snr=snr,
            sync=best.astype(np.float32),
            shift=(128 * k0).astype(np.int32),
            mode=np.where(self.models.is_nonlinear[mm], MODE_NONLINEAR,
                          MODE_LINEAR).astype(np.int32),
            drift=self.models.drift[mm],
            slm_params=self.models.slm_params[mm],
        )


__all__ = ["Candidates", "CoarseSearch", "DriftModelBank", "MODE_LINEAR",
           "MODE_NONLINEAR", "build_drift_models", "coarse_score_grid",
           "detect_peaks", "max_peaks", "powersum_planes",
           "smoothed_snr_spectrum"]
