"""Fine sync and soft symbols (torch): the host engine's staged refinement
and the device engine's shared-window probe evaluation.

Host engine (uwspr_tpu/demod/finesync.py:68-85, :462-649): ``FineSync``
refines each candidate's (lag, freq, drift) stage by stage and extracts the
soft symbols of every jiggled lag. Each stage's probe powers come from
``ops/probe.py`` (the CUDA kernel on the card) through
``eval_probe_grid_core``; the argmaxes, the drift update and the soft-symbol
scaling stay in numpy, as the JAX engine has them, so only the probe powers
can differ between the packages. The window moves to the device once per
``refine`` / ``soft_symbols`` call.

Device engine (uwspr_tpu/demod/finesync.py:56-65, :206-459): one aligned
window per candidate lane is gathered once
(``make_shared_probe`` / ``make_shared_probe_lanes``), derotated by the
lane's per-symbol drift (``probe_derotate``), and every (freq, lag) probe
of a stage is a masked tone-bank product against it
(``shared_probe_eval``). Phases are evaluated at the window-local index,
which rotates each correlation by a unit phasor; only |corr| is consumed.

Two forms, as in the JAX package: complex64 windows with f32 probes, and
bfloat16 real/imag planes (C, 2, 162, W) with bf16 elementwise math and
bf16 x bf16 products accumulated in f32 (the serving default). The probe
products are plain batched matrix products, as XLA computes them outside
any Pallas kernel; bf16 products are emulated exactly by upcasting the
bf16 operands and multiplying in f32 with TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from uwspr_tpu_torch.coarse.search import MODE_NONLINEAR, Candidates
from uwspr_tpu_torch.config import CoarseConfig, DemodConfig
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.models import slm
from uwspr_tpu_torch.ops.probe import probe_powers
from uwspr_tpu_torch.protocol.constants import (
    SAMPLE_RATE,
    SYNC_VECTOR,
    TONE_OFFSETS,
    TONE_SPACING,
)

_DT = 1.0 / SAMPLE_RATE
_TONES_HZ = (TONE_OFFSETS * TONE_SPACING).astype(np.float32)  # (4,)
_SIGN = (2.0 * SYNC_VECTOR.astype(np.float32) - 1.0).astype(np.float32)

_W = 1024
_PAD = 4096
_FRAME = 162 * 256
_REACH = 224            # max |lag - center| across all stages (128+32+64)


def jiggle_offsets(n_jiggles: int, iifac: int) -> np.ndarray:
    """Retry-shift schedule 0, -iifac, +iifac, -2*iifac, ... in the
    reference's idt order (impl.cc:460-464; finesync.py:56-65)."""
    idt = np.arange(n_jiggles)
    ii = (idt + 1) // 2
    ii = np.where(idt % 2 == 1, -ii, ii)
    return (ii * iifac).astype(np.int32)


def _overlap_blocks(A: torch.Tensor, W: int) -> torch.Tensor:
    """(.., _FRAME+W) gathered span -> (.., 162, W) overlapped symbol rows:
    row i holds A[.., 256*i : 256*i + W] (finesync.py:206-223)."""
    return A.unfold(-1, W, 256)[..., :162, :].contiguous()


def _window_base(center: torch.Tensor, reach: int, W: int, block: int,
                 n_padded: int) -> torch.Tensor:
    start_min = center.to(torch.int64) + _PAD - reach
    return torch.clamp(torch.div(start_min, block, rounding_mode="floor")
                       * block, 0, n_padded - (_FRAME + W))


def _check_window(W: int, reach: int, block: int) -> None:
    if W % 128 or W % block:
        raise ValueError(f"window {W} must be a multiple of 128 and {block}")
    if W < 2 * reach + 256 + (block - 1):
        raise ValueError(f"window {W} too narrow for reach {reach} at "
                         f"block {block}")


def make_shared_probe_lanes(z_all: torch.Tensor, widx: torch.Tensor,
                            center: torch.Tensor, *, reach: int = _REACH,
                            W: int = _W, block: int = 256,
                            dtype: str = "c64"):
    """(B, N) complex64 windows + (L,) window indices + (L,) lag centers ->
    (Amat, base (L,) int64 absolute padded start) (finesync.py:275-317).

    Amat[l, i, j] = zp[widx[l], base[l] + 256*i + j], zp the window padded
    by _PAD zeros in front and _PAD+W behind, with sample 0 zeroed (the
    reference's correlation guard 0 < n < N). dtype "c64": (L, 162, W)
    complex64. dtype "bf16": (L, 2, 162, W) bfloat16 real/imag planes."""
    _check_window(W, reach, block)
    B, N = z_all.shape
    Np = N + 2 * _PAD + W
    base = _window_base(center, reach, W, block, Np)
    span = torch.arange(_FRAME + W, device=z_all.device)
    pos = base[:, None] + span[None, :] - _PAD            # sample index
    inside = (pos >= 1) & (pos < N)                       # z[0] is zeroed
    posc = torch.clamp(pos, 0, N - 1)
    wi = widx.to(torch.int64)[:, None]
    if dtype == "bf16":
        planes = [x.to(torch.bfloat16) for x in (z_all.real, z_all.imag)]
        A = torch.stack([torch.where(inside, p[wi, posc], 0) for p in planes],
                        dim=1)                            # (L, 2, span)
    elif dtype == "c64":
        A = torch.where(inside, z_all[wi, posc], 0)
    else:
        raise ValueError(f"probe dtype {dtype!r}")
    return _overlap_blocks(A, W), base


def make_shared_probe(z: torch.Tensor, center: torch.Tensor, *,
                      reach: int = _REACH, W: int = _W, block: int = 256,
                      dtype: str = "c64"):
    """Single-window form: (N,) complex64 + (C,) lag centers -> (Amat,
    base) with every lane reading ``z`` (finesync.py:226-272)."""
    widx = torch.zeros(center.shape[0], dtype=torch.int64, device=z.device)
    return make_shared_probe_lanes(z[None], widx, center, reach=reach, W=W,
                                   block=block, dtype=dtype)


def _ramp_angles(theta: torch.Tensor, W: int):
    j1 = torch.arange(64, dtype=torch.float32, device=theta.device)
    j2 = torch.arange(W // 64, dtype=torch.float32, device=theta.device) * 64.0
    return theta[..., None] * j1, theta[..., None] * j2


def phasor_ramp(theta: torch.Tensor, W: int) -> torch.Tensor:
    """exp(i * theta * j) for j in [0, W) by the split exponential
    j = j1 + 64*j2 (finesync.py:320-337): theta (...,) -> (..., W) c64."""
    a1, a2 = _ramp_angles(theta, W)
    u = torch.complex(torch.cos(a1), torch.sin(a1))        # (..., 64)
    v = torch.complex(torch.cos(a2), torch.sin(a2))        # (..., W/64)
    return (v[..., :, None] * u[..., None, :]).reshape(theta.shape + (W,))


def _phasor_ramp_ri(theta: torch.Tensor, W: int, dtype: torch.dtype):
    """phasor_ramp as (cos, sin) planes computed in ``dtype``
    (finesync.py:340-363): the small factors are cast before the outer
    products."""
    a1, a2 = _ramp_angles(theta, W)
    ur, ui = torch.cos(a1).to(dtype), torch.sin(a1).to(dtype)
    vr, vi = torch.cos(a2).to(dtype), torch.sin(a2).to(dtype)
    cr = (vr[..., :, None] * ur[..., None, :]
          - vi[..., :, None] * ui[..., None, :])
    ci = (vr[..., :, None] * ui[..., None, :]
          + vi[..., :, None] * ur[..., None, :])
    shp = theta.shape + (W,)
    return cr.reshape(shp), ci.reshape(shp)


def probe_derotate(Amat: torch.Tensor, drift_sym: torch.Tensor
                   ) -> torch.Tensor:
    """Apply the per-symbol drift phasor at the window-local index
    (finesync.py:366-391). Amat is (C, 162, W) complex64 or the
    (C, 2, 162, W) bf16 plane form, whose math stays in bf16."""
    theta = (-2.0 * np.pi * _DT) * drift_sym
    if Amat.is_complex():
        return Amat * phasor_ramp(theta, Amat.shape[-1])
    cr, ci = _phasor_ramp_ri(theta, Amat.shape[-1], Amat.dtype)
    ar = Amat[..., 0, :, :]
    ai = Amat[..., 1, :, :]
    zr = ar * cr - ai * ci
    zi = ar * ci + ai * cr
    return torch.stack([zr, zi], dim=-3)


def _lane_products(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """einsum 'ciw,clmw->clim' as one batched product per lane c."""
    C, L, Mb, W = bank.shape
    out = torch.bmm(x, bank.reshape(C, L * Mb, W).transpose(1, 2))
    return out.reshape(C, 162, L, Mb).permute(0, 2, 1, 3)


def probe_constants(device: torch.device) -> dict[str, torch.Tensor]:
    """Tone offsets (4,) in Hz and the sync sign (162,) on ``device``, for
    callers that evaluate probes repeatedly (each host-to-device copy
    waits for the device to drain)."""
    return {"tones": torch.from_numpy(_TONES_HZ).to(device),
            "sign": torch.from_numpy(_SIGN).to(device)}


def shared_probe_eval(zd: torch.Tensor, base: torch.Tensor,
                      lags: torch.Tensor, freqs: torch.Tensor, *,
                      n_lags: int, want_symbols: bool = False,
                      dtype: str = "f32",
                      consts: dict[str, torch.Tensor] | None = None):
    """Sync (C, F, L) [+ tone powers p (C, F, L, 162, 4)] for probes against
    a shared derotated window (finesync.py:394-459).

    dtype "bf16": the correlation runs as four real bf16 products with f32
    accumulation; zd may be complex64 (rounded to bf16 here) or the bf16
    plane form. dtype "f32": complex64 zd and a complex64 product.
    ``consts`` are probe_constants(zd.device), built here if not given."""
    C, F_ = freqs.shape
    W = zd.shape[-1]
    dev = zd.device
    if consts is None:
        consts = probe_constants(dev)
    jpf = torch.arange(W, dtype=torch.float32, device=dev)
    b = torch.clamp(lags.to(torch.int64) + _PAD - base[:, None], 0, W - 256)
    ft = freqs[..., None] + consts["tones"]                      # (C, F, 4)
    bank = phasor_ramp((-2.0 * np.pi * _DT) * ft, W).reshape(C, 1, 4 * F_, W)
    mask = ((jpf[None, None, :] >= b[..., None])
            & (jpf[None, None, :] < b[..., None] + 256)).float()  # (C, L, W)
    if dtype == "bf16":
        bf = torch.bfloat16
        maskb = mask.to(bf)[:, :, None, :]
        br = (bank.real.to(bf) * maskb).float()                 # (C,L,4F,W)
        bi = (bank.imag.to(bf) * maskb).float()
        if zd.is_complex():
            zr, zi = zd.real.to(bf).float(), zd.imag.to(bf).float()
        else:
            zr, zi = zd[..., 0, :, :].float(), zd[..., 1, :, :].float()
        re = _lane_products(zr, br) - _lane_products(zi, bi)
        im = _lane_products(zr, bi) + _lane_products(zi, br)
        p = torch.sqrt(re * re + im * im)
    elif dtype == "f32":
        if not zd.is_complex():
            raise ValueError("RI-plane zd requires dtype='bf16'")
        bankm = bank * mask[:, :, None, :]                      # (C,L,4F,W)
        p = torch.abs(_lane_products(zd, bankm))
    else:
        raise ValueError(f"probe dtype {dtype!r}")
    p = p.reshape(C, n_lags, 162, F_, 4).permute(0, 3, 1, 2, 4)  # (C,F,L,162,4)
    sync = sync_of_powers(p, consts["sign"])
    if want_symbols:
        return sync, p
    return sync


def sync_of_powers(p: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Tone powers (C, F, L, 162, 4) -> sync (C, F, L): the sync-tone
    correlation over the total power (finesync.py:488-492)."""
    cmet = (p[..., 1] + p[..., 3]) - (p[..., 0] + p[..., 2])
    ss = torch.einsum("cfli,i->cfl", cmet, sign)
    totp = p.sum(dim=(-2, -1))
    return (ss / totp).float()


# ---------------------------------------------------------------------------
# host engine (finesync.py:68-85, :462-649)
# ---------------------------------------------------------------------------

def drift_offsets(cands: Candidates, drift1: np.ndarray, cf: float
                  ) -> np.ndarray:
    """(C, 162) per-symbol frequency offset in Hz for each candidate
    (finesync.py:68-85): linear (drift1/2) * (i-81)/81, nonlinear the SLM
    drift at t = i*111//162 whole seconds."""
    i = np.arange(162, dtype=np.float64)
    lin = (drift1[:, None] / 2.0) * (i[None, :] - 81.0) / 81.0
    t = (np.arange(162) * 111 // 162).astype(np.float64)
    v1, v2, p1, p2 = (cands.slm_params[:, k:k + 1].astype(np.float64)
                      for k in range(4))
    nl = slm.slm_frequency_drift(v1, v2, p1, p2, cf, t[None, :])
    is_nl = (cands.mode == MODE_NONLINEAR)[:, None]
    return np.where(is_nl, nl, lin).astype(np.float32)


def complex_to_ri(z: np.ndarray) -> np.ndarray:
    """(N,) complex -> (2, N) float32 real/imag planes (finesync.py:506)."""
    z = np.asarray(z)
    return np.stack([z.real.astype(np.float32), z.imag.astype(np.float32)])


def eval_probe_grid_core(z_ri: torch.Tensor, lags: torch.Tensor,
                         freqs: torch.Tensor, drift_sym: torch.Tensor, *,
                         n_lags: int, want_symbols: bool = False,
                         consts: dict[str, torch.Tensor] | None = None):
    """Sync (C, F, L) [+ tone powers p (C, F, L, 162, 4)] for every
    (candidate, freq, lag) probe (finesync.py:462-495). z_ri is the (2, N)
    float32 window; the powers come from ``ops.probe.probe_powers``.
    ``consts`` are probe_constants(z_ri.device), built here if not given."""
    if consts is None:
        consts = probe_constants(z_ri.device)
    p = probe_powers(z_ri, lags, freqs, drift_sym, n_lags=n_lags)
    sync = sync_of_powers(p, consts["sign"])
    if want_symbols:
        return sync, p
    return sync


def eval_probe_grid(z, lags, freqs, drift_sym, *, n_lags: int,
                    want_symbols: bool = False,
                    consts: dict[str, torch.Tensor] | None = None):
    """Host entry (finesync.py:513-520): z as numpy complex samples or a
    (2, N) float pair (run on the CPU), or a (2, N) float32 tensor (run on
    its device); lags, freqs and drift_sym as numpy. Returns numpy
    sync [, p]."""
    if isinstance(z, torch.Tensor):
        z_ri = z
    else:
        ri = z if (isinstance(z, np.ndarray) and z.ndim == 2) \
            else complex_to_ri(z)
        z_ri = torch.from_numpy(np.ascontiguousarray(ri, np.float32))
    dev = z_ri.device

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
    out = eval_probe_grid_core(z_ri, put(lags, np.int32),
                               put(freqs, np.float32),
                               put(drift_sym, np.float32), n_lags=n_lags,
                               want_symbols=want_symbols, consts=consts)
    if want_symbols:
        return out[0].cpu().numpy(), out[1].cpu().numpy()
    return out.cpu().numpy()


def _first_argmax(sync: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(C, F, L) -> best (fi, li) per candidate, first-max-wins in C order."""
    C, F_, L = sync.shape
    idx = sync.reshape(C, -1).argmax(axis=1)
    return idx // L, idx % L


@dataclass
class Refined:
    """Per-candidate state after the staged refinement."""

    freq: np.ndarray          # (C,) f1
    shift: np.ndarray         # (C,) shift1
    drift: np.ndarray         # (C,) drift1
    sync: np.ndarray          # (C,) sync1
    worth_a_try: np.ndarray   # (C,) bool


class FineSync:
    """Staged refinement and soft symbols on ``device`` (finesync.py:542).
    ``jiggles`` are the retry lag offsets, by default jiggle_offsets of the
    demod config."""

    def __init__(self, demod_cfg: DemodConfig | None = None,
                 coarse_cfg: CoarseConfig | None = None, *,
                 device: str | torch.device,
                 jiggles: np.ndarray | None = None):
        self.cfg = demod_cfg or DemodConfig()
        self.coarse = coarse_cfg or CoarseConfig()
        for cfg, cls in ((self.cfg, DemodConfig), (self.coarse, CoarseConfig)):
            if not isinstance(cfg, cls):
                raise TypeError(f"expected uwspr_tpu_torch.config."
                                f"{cls.__name__}, got {type(cfg).__module__}."
                                f"{type(cfg).__name__}")
        self.device = resolve_device(device)
        self._jiggles = (jiggle_offsets(self.cfg.n_jiggles, self.cfg.iifac)
                         if jiggles is None
                         else np.asarray(jiggles).astype(np.int32))
        self._consts = probe_constants(self.device)

    def _window(self, z: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(complex_to_ri(z)).to(self.device)

    def _stage(self, z_ri, lag_grid, freq_grid, dsym, want_symbols=False):
        return eval_probe_grid(z_ri, lag_grid, freq_grid, dsym,
                               n_lags=lag_grid.shape[1],
                               want_symbols=want_symbols,
                               consts=self._consts)

    # -- staged refinement (reference impl.cc:389-456) ---------------------

    def refine(self, z: np.ndarray, cands: Candidates) -> Refined:
        """finesync.py:550-617, stage for stage."""
        zj = self._window(z)
        C = len(cands.freq)
        cidx = np.arange(C)
        f1 = cands.freq.astype(np.float32).copy()
        shift1 = cands.shift.astype(np.int32).copy()
        drift1 = cands.drift.astype(np.float32).copy()
        cf = float(self.coarse.cf)
        dsym = drift_offsets(cands, drift1, cf)

        # stage 0: coarse lag search, +/-128 step 64
        lag_grid = shift1[:, None] + np.arange(-128, 129, 64)[None, :]
        sync = self._stage(zj, lag_grid, f1[:, None], dsym)
        fi, li = _first_argmax(sync)
        shift1 = lag_grid[cidx, li].astype(np.int32)
        sync1 = sync[cidx, 0, li]

        # stage 1: coarse freq search, +/-2 * 0.25 Hz
        freq_grid = (f1[:, None] + (np.arange(-2, 3) * 0.25)[None, :]
                     ).astype(np.float32)
        sync = self._stage(zj, shift1[:, None], freq_grid, dsym)
        fi, li = _first_argmax(sync)
        f1 = freq_grid[cidx, fi].astype(np.float32)
        sync1 = sync[cidx, fi, 0]

        # stage 2 (linear only): drift +/- 0.5, applied as if/else-if
        # against the base sync (impl.cc:423-441)
        is_lin = cands.mode != MODE_NONLINEAR
        driftp = drift1 + np.float32(0.5)
        driftm = drift1 - np.float32(0.5)
        syncp = self._stage(zj, shift1[:, None], f1[:, None],
                            drift_offsets(cands, driftp, cf))[:, 0, 0]
        syncm = self._stage(zj, shift1[:, None], f1[:, None],
                            drift_offsets(cands, driftm, cf))[:, 0, 0]
        updp = is_lin & (syncp > sync1)
        updm = is_lin & ~updp & (syncm > sync1)
        drift1 = np.where(updp, driftp,
                          np.where(updm, driftm, drift1)).astype(np.float32)
        sync1 = np.where(updp, syncp, np.where(updm, syncm, sync1))
        dsym = drift_offsets(cands, drift1, cf)

        # stage 3: fine lag (+/-32 step 16) and fine freq (+/-2 * 0.05)
        worth = sync1 > self.cfg.minsync1
        lag_grid = shift1[:, None] + np.arange(-32, 33, 16)[None, :]
        sync = self._stage(zj, lag_grid, f1[:, None], dsym)
        fi, li = _first_argmax(sync)
        shift1 = np.where(worth, lag_grid[cidx, li], shift1).astype(np.int32)
        sync1 = np.where(worth, sync[cidx, 0, li], sync1)

        freq_grid = (f1[:, None] + (np.arange(-2, 3) * 0.05)[None, :]
                     ).astype(np.float32)
        sync = self._stage(zj, shift1[:, None], freq_grid, dsym)
        fi, li = _first_argmax(sync)
        f1 = np.where(worth, freq_grid[cidx, fi], f1).astype(np.float32)
        sync1 = np.where(worth, sync[cidx, fi, 0], sync1)

        return Refined(freq=f1, shift=shift1, drift=drift1,
                       sync=sync1.astype(np.float32),
                       worth_a_try=worth & cands.valid)

    # -- mode-2 soft symbols over all jiggled shifts -----------------------

    def jiggle_offsets(self) -> np.ndarray:
        return self._jiggles.copy()

    def soft_symbols(self, z: np.ndarray, cands: Candidates, ref: Refined
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (symbols (C, J, 162) uint8, sync (C, J), rms (C, J))
        (finesync.py:624-649)."""
        lag_grid = ref.shift[:, None] + self._jiggles[None, :]   # (C, J)
        dsym = drift_offsets(cands, ref.drift, float(self.coarse.cf))
        sync, p = self._stage(self._window(z), lag_grid, ref.freq[:, None],
                              dsym, want_symbols=True)
        sync = sync[:, 0, :]                                    # (C, J)
        p = p[:, 0]                                             # (C,J,162,4)
        sync_bit = SYNC_VECTOR.astype(bool)[None, None, :]
        fsymb = np.where(sync_bit, p[..., 3] - p[..., 1],
                         p[..., 2] - p[..., 0]).astype(np.float32)
        fsum = fsymb.mean(axis=-1, keepdims=True)
        f2sum = (fsymb * fsymb).mean(axis=-1, keepdims=True)
        fac = np.sqrt(f2sum - fsum * fsum)
        with np.errstate(divide="ignore", invalid="ignore"):
            scaled = self.cfg.symfac * fsymb / fac
        scaled = np.clip(np.nan_to_num(scaled), -128.0, 127.0)
        symbols = np.floor(scaled + 128.0).astype(np.uint8)
        y = symbols.astype(np.float32) - 128.0
        rms = np.sqrt((y * y).mean(axis=-1))
        return symbols, sync, rms


__all__ = ["FineSync", "Refined", "complex_to_ri", "drift_offsets",
           "eval_probe_grid", "eval_probe_grid_core", "jiggle_offsets",
           "make_shared_probe", "make_shared_probe_lanes", "phasor_ramp",
           "probe_constants", "probe_derotate", "shared_probe_eval",
           "sync_of_powers"]
