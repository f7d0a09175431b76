"""Coarse candidate search (torch): drift-model bank, smoothed SNR spectrum,
peak pick, the dense (freq x lag x model) sync grid and the host engine's
``CoarseSearch``.

Counterpart of uwspr_tpu/coarse/search.py. ``build_drift_models``,
``max_peaks``, ``Candidates`` and ``detect_peaks`` are numpy; they are
carried over because their JAX module imports jax. The sync grid
(``coarse_score_grid``, through ``sync_grid``): on a CUDA tensor one launch
of ``csrc/sync_grid.cu`` (counted in ``KERNEL_LAUNCHES``), which sums the
162 one-hot taps directly; on the CPU ``sync_grid_plain``, which repeats
the kernel's arithmetic (gathers summed in ascending k) and counts its
calls in ``PLAIN_CALLS``. The JAX module's ``conv`` and ``einsum`` forms
(search.py:259-339) sum the same terms in another order. The drift-model
selection lives in ``uwspr_tpu_torch.ops.select`` (the CUDA kernel and its
plain version).
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
from uwspr_tpu_torch.utils import cuda_build

MODE_LINEAR = 0
MODE_NONLINEAR = 1

# offsets d in [-4, 4] cover every drift model at the defaults
_D_MIN, _D_MAX = -6, 6
# PyTorch's intra-op grain: a CPU op on fewer elements runs on the calling
# thread. sync_grid_plain keeps each op of its loop under it, since an op
# that takes the thread pool waits at a barrier, which costs tens of ms an
# op when processes share the cores
_CPU_GRAIN = 32768
# the sync-grid kernel's lags and models (one thread a model)
_KERNEL_LAGS = 26
MAX_MODELS = 128

# launches of the sync-grid kernel onto a stream (a CUDA graph's capture
# only records one) / calls of its plain version, in this process
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counters() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


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


def grid_columns(if0: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """(B, C) candidate bins -> (B, C, 5) window columns if0 + (-2..2) -
    lo, indexed as the JAX gather does: a negative column wraps once (a
    padded lane at bin 0 reads the top columns), then every column clamps
    to [0, width) (at wideband a lane at the top bin reaches past it)."""
    ifr = (if0[..., None] + torch.arange(-2, 3, device=if0.device)
           - lo).long()
    return torch.where(ifr < 0, ifr + width, ifr).clamp(0, width - 1)


def grid_planes(ps: torch.Tensor, lo: int, width: int, dtype: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The A/B powersum planes over spectrum columns [lo, lo + width),
    rounded to bf16 and back for ``dtype="bf16"``."""
    A, B = powersum_planes(ps)
    A, B = A[..., lo:lo + width], B[..., lo:lo + width]
    if dtype == "bf16":
        return A.to(torch.bfloat16).float(), B.to(torch.bfloat16).float()
    return A, B


def grid_window(size: int, f_window: tuple[int, int] | None
                ) -> tuple[int, int]:
    """(lo, width) of the columns [lo, lo + width) that ``f_window`` keeps
    of a ``size``-column spectrum (all of them for None)."""
    if f_window is None:
        return 0, size
    lo, hi = max(f_window[0], 0), min(f_window[1], size)
    return lo, hi - lo


def coarse_score_grid(ps: torch.Tensor, if0: torch.Tensor,
                      offsets: torch.Tensor, sync_sign: torch.Tensor, *,
                      n_lags: int = 26,
                      f_window: tuple[int, int] | None = None,
                      dtype: str = "f32") -> torch.Tensor:
    """Sync correlation over (candidate, freq+/-2, lag, model).

    ps: (B, n, size) power; if0: (B, C) candidate center bins (ps-relative);
    offsets: (M, 162) int bin offsets; sync_sign: (162,) +/-1.
    Returns sync (B, C, 5, n_lags, M) float32 = ss / pow.

    ss[b, m, w, f] = sum_k sign[k] * A[b, w + 2k, f + offs[m, k]], summed
    in ascending k by ``sync_grid``: the kernel on a CUDA tensor, its plain
    version on the CPU. The JAX module's conv and einsum forms
    (search.py:220-238) sum the same terms in another order.

    ``dtype="bf16"`` rounds the A/B planes to bf16 (the +-1 signs are
    exact) and still accumulates in f32. ``f_window=(lo, hi)`` scores only
    columns [lo, hi). Candidate columns index as ``grid_columns`` says."""
    lo, width = grid_window(ps.shape[-1], f_window)
    return sync_grid(ps, grid_columns(if0, lo, width), offsets, sync_sign,
                     lo=lo, width=width, n_lags=n_lags, dtype=dtype)


def _check_grid(ps, ifr, offsets, sync_sign, lo, width, n_lags, dtype):
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"grid dtype {dtype!r}")
    if ps.dim() != 3 or ps.dtype != torch.float32:
        raise ValueError(f"ps must be (B, n, size) float32, got "
                         f"{tuple(ps.shape)} {ps.dtype}")
    W, n, size = ps.shape
    if ifr.dim() != 3 or ifr.shape[0] != W or ifr.shape[2] != 5:
        raise ValueError(f"ifr {tuple(ifr.shape)} is not ({W}, C, 5)")
    if offsets.dim() != 2 or offsets.shape[1] != 162 \
            or sync_sign.shape != (162,):
        raise ValueError(f"offsets {tuple(offsets.shape)} / sign "
                         f"{tuple(sync_sign.shape)} are not (M, 162) / (162,)")
    if not (0 <= lo and 1 <= width and lo + width <= size):
        raise ValueError(f"columns [{lo}, {lo + width}) outside the "
                         f"spectrum's {size}")
    if n < 2 * 161 + n_lags:
        raise ValueError(f"{n} spectrum rows are too few for {n_lags} lags")
    devs = {t.device for t in (ps, ifr, offsets, sync_sign)}
    if len(devs) != 1:
        raise ValueError("sync grid inputs lie on different devices")


def sync_grid(ps: torch.Tensor, ifr: torch.Tensor, offsets: torch.Tensor,
              sync_sign: torch.Tensor, *, lo: int, width: int,
              n_lags: int = 26, dtype: str = "f32") -> torch.Tensor:
    """The (B, C, 5, n_lags, M) f32 grid ss / pw of ``coarse_score_grid``
    from the power spectra ps (B, n, size) at window columns ifr (B, C, 5)
    (``grid_columns``) of the window [lo, lo + width). For a CUDA tensor
    one launch of ``csrc/sync_grid.cu`` on the current stream (26 lags, at
    most MAX_MODELS models, offsets within [-6, 6] as build_drift_models
    guarantees), counted in ``KERNEL_LAUNCHES``; for a CPU tensor
    ``sync_grid_plain``. Both give the same bits."""
    global KERNEL_LAUNCHES
    _check_grid(ps, ifr, offsets, sync_sign, lo, width, n_lags, dtype)
    if ps.device.type == "cpu":
        return sync_grid_plain(ps, ifr, offsets, sync_sign, lo=lo,
                               width=width, n_lags=n_lags, dtype=dtype)
    if ps.device.type != "cuda":
        raise ValueError(f"sync_grid: unsupported device {ps.device}")
    W, n, size = ps.shape
    C = ifr.shape[1]
    M = offsets.shape[0]
    if n_lags != _KERNEL_LAGS or M > MAX_MODELS:
        raise ValueError(f"sync_grid: the kernel takes {_KERNEL_LAGS} lags "
                         f"and at most {MAX_MODELS} models, got {n_lags} "
                         f"and {M}")
    x = ps.contiguous()
    cols = ifr.to(torch.int32).contiguous()
    shifts = (offsets - _D_MIN).to(torch.uint8).t().contiguous()
    sign = sync_sign.float().contiguous()
    out = torch.empty((W, C, 5, n_lags, M), dtype=torch.float32,
                      device=ps.device)
    lib = cuda_build.load_library()
    code = lib.uwspr_sync_grid(
        x.data_ptr(), W, n, size, lo, width, cols.data_ptr(), 5 * C,
        shifts.data_ptr(), M, sign.data_ptr(), int(dtype == "bf16"),
        out.data_ptr(), torch.cuda.current_stream(ps.device).cuda_stream)
    cuda_build.check_launch("uwspr_sync_grid", code)
    if not torch.cuda.is_current_stream_capturing():
        KERNEL_LAUNCHES += 1    # a capture only records it
    return out


def sync_grid_plain(ps: torch.Tensor, ifr: torch.Tensor,
                    offsets: torch.Tensor, sync_sign: torch.Tensor, *,
                    lo: int, width: int, n_lags: int = 26,
                    dtype: str = "f32") -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device: the planes of
    ``grid_planes``, zero outside the window; then for k = 0..161 in turn
    the plane values at rows 2k + w and columns x + offs[:, k], added to
    (pw) or, times sign[k], to (ss) f32 sums that start at 0; then ss / pw.
    As in the kernel, a cell is summed once for each window column x that
    some lane reads, and copied to those lanes. Counted in
    ``PLAIN_CALLS``."""
    global PLAIN_CALLS
    _check_grid(ps, ifr, offsets, sync_sign, lo, width, n_lags, dtype)
    PLAIN_CALLS += 1
    W = ps.shape[0]
    C = ifr.shape[1]
    M = offsets.shape[0]
    dev = ps.device
    A, B = grid_planes(ps, lo, width, dtype)
    planes = F.pad(torch.stack([A, B]), (-_D_MIN, _D_MAX))  # (2, W, n, w+12)
    cols, lane_col = torch.unique(ifr, return_inverse=True)
    # padded plane column of (model, read column) at symbol k: (162, X*M)
    taps = (cols[None, :, None] - _D_MIN
            + offsets.t()[:, None, :]).long().reshape(162, -1)
    # (ss, pw) weights of symbol k: sign[k] and 1
    weights = torch.stack([sync_sign.float(),
                           torch.ones(162, device=dev)], dim=1)
    n = taps.shape[1]
    step = (max(1, _CPU_GRAIN // (2 * W * n_lags)) if dev.type == "cpu"
            else n)
    grid = []
    for c0 in range(0, n, step):
        t = taps[:, c0:c0 + step]
        acc = torch.zeros((2, W, n_lags, t.shape[1]), dtype=torch.float32,
                          device=dev)
        tap = torch.empty_like(acc)
        for k in range(162):
            torch.gather(planes[:, :, 2 * k:2 * k + n_lags], 3,
                         t[k].expand(2, W, n_lags, -1), out=tap)
            acc.addcmul_(tap, weights[k, :, None, None, None])
        grid.append(acc[0] / acc[1])
    grid = torch.cat(grid, dim=-1).reshape(W, n_lags, -1, M)
    # each lane column's cells: (W, 5C, n_lags, M)
    wi = torch.arange(W, device=dev)[:, None]
    grid = grid[wi, :, lane_col.reshape(W, 5 * C)]
    return grid.reshape(W, C, 5, n_lags, M)


class CoarseSearch:
    """The host engine's coarse search over one 45000-sample window
    (search.py:607-652) on ``device``: FFT STFT power, smoothed SNR
    spectrum, host peak pick, the f32 sync grid over all maxfreqs lanes
    and the exact selection (the CUDA kernel on the card). ``models``
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
            self._offsets, self._sign)[0]
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


__all__ = ["Candidates", "CoarseSearch", "DriftModelBank", "KERNEL_LAUNCHES",
           "MAX_MODELS", "MODE_LINEAR", "MODE_NONLINEAR", "PLAIN_CALLS",
           "build_drift_models", "coarse_score_grid", "detect_peaks",
           "grid_columns", "grid_planes",
           "grid_window", "max_peaks", "powersum_planes",
           "reset_counters", "smoothed_snr_spectrum", "sync_grid",
           "sync_grid_plain"]
