"""The plain reference of the device engine's batch decode, up to the Fano.

A frozen copy, in plain PyTorch, of the semantics of the port's batched
device decode at a serving point (``with_serving_defaults`` at batch width
W > 1): column-windowed DFT-matmul STFT power, the smoothed SNR spectrum
and its peak pick, the coarse sync grid (conv below 33 passband bins, the
im2col einsum above), the exact drift-model selection (``select.py``: the
literal sequential scan), the cross-window compaction of valid candidates
(weakest coarse SNR shed first, counted), phase A/B probe refinement, the
post-worth compaction, the joint fine grid, soft symbols over every
jiggle, the sync/rms gates and the deinterleave. The two-phase Fano and
the first-success select are in ``fano.py`` and ``outputs`` below.

It imports nothing of the program. Its tables (drift models, SLM
trajectories, jiggles, the interleaver, the sync sign) are built here.
The serving point is worked out here from the configuration file by the
rule the port documents: bf16 probes and the bf16 DFT-matmul STFT where
the file leaves them at "f32"/"auto", candidate/refine/Fano lane caps of
2 W where the window holds at most 32 candidate slots, else min(16 W, 512).

``Prec`` says how the products are rounded. "stated" is the precision the
configuration states: bf16 operands with float32 sums where it says bf16
(the STFT, the probes and their bf16 elementwise math, the wideband
grid's planes), float32 with TF32 off elsewhere. "below" is the control,
one step lower at every such point: float8 e4m3 (per-tensor power-of-two
scale) where the configuration states bf16, TF32 operands where it
states float32. Everything is emulated in float32 arithmetic: a bf16
product of bf16 values is exact in float32 and then rounded once, as
PyTorch's bf16 operators do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from wsprbench.reference import protocol as P
from wsprbench.reference.select import select_literal

_DT = 1.0 / P.SAMPLE_RATE
_PAD = 4096
_FRAME = 162 * 256
_D_MIN, _D_MAX = -6, 6
_N_SHIFTS = _D_MAX - _D_MIN + 1
_IM2COL_BYTES = 1 << 30
SOUND_SPEED = 1500.0


# ---------------------------------------------------------------- precision

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to float8 e4m3 under a power-of-two scale that puts
    the tensor's largest magnitude at or under 448."""
    amax = float(x.abs().amax()) if x.numel() else 0.0
    if not math.isfinite(amax) or amax == 0.0:
        return x
    s = 2.0 ** math.ceil(math.log2(amax / 448.0))
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Prec:
    """Rounding at the configuration's precision points."""

    def __init__(self, level: str = "stated"):
        if level not in ("stated", "below"):
            raise ValueError(f"precision {level!r}")
        self.level = level

    def lo(self, x: torch.Tensor) -> torch.Tensor:
        """A value the configuration holds in bf16."""
        if self.level == "stated":
            return x.to(torch.bfloat16).float()
        return _fp8(x.float())

    def f32(self, x: torch.Tensor) -> torch.Tensor:
        """A product operand the configuration holds in float32."""
        return x if self.level == "stated" else _tf32(x.float())


# ------------------------------------------------------------ configuration

def serving(cfg: dict, batch: int) -> dict:
    """The configuration file's "pipeline" -> the resolved fields the
    reference reads, at the serving point for ``batch`` windows."""
    c, d = dict(cfg["coarse"]), dict(cfg["demod"])
    df = c["fs"] / (2 * c["spb"])
    hpbm = math.ceil(c["halfbandwidth"] / df)
    n_static = min(c["maxfreqs"], (2 * hpbm - 1) // 2)
    if d.get("probe_dtype", "f32") == "f32":
        d["probe_dtype"] = "bf16"
    if c.get("stft_impl", "auto") == "auto":
        c["stft_impl"] = "matmul_bf16"
    if batch <= 1:
        raise ValueError("the reference covers the batch path (W > 1)")
    cap = 2 * batch if n_static <= 32 else min(16 * batch, 512)
    for k in ("refine_max_lanes", "fano_compact_lanes", "cand_compact_lanes"):
        if d.get(k, 0) == 0:
            d[k] = cap
    grid_impl = c.get("grid_impl", "auto")
    if grid_impl == "auto":
        grid_impl = "einsum" if hpbm > 32 else "conv"
    grid_dtype = c.get("grid_dtype", "auto")
    if grid_dtype == "auto":
        grid_dtype = "bf16" if grid_impl == "einsum" else "f32"
    if c["stft_impl"] != "matmul_bf16" or d["probe_dtype"] != "bf16":
        raise ValueError("the reference covers the bf16 STFT and probes")
    if d.get("osd_depth", 0) > 0:
        raise ValueError("the reference covers osd_depth 0")
    return {"coarse": c, "demod": d, "df": df, "hpbm": hpbm,
            "n_cand": n_static, "grid_impl": grid_impl,
            "grid_dtype": grid_dtype, "fft": 2 * c["spb"],
            "n_ffts": int(c["fl"] / c["spb"] * 2) - 3}


# ----------------------------------------------------------------- tables

def slm_drift_np(v1, v2, p1, p2, cf, t):
    q1 = v1 * t + p1
    q2 = v2 * t + p2
    num = v1 * q1 + v2 * q2
    den = np.sqrt(q1 * q1 + q2 * q2)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(den == 0.0, 0.0,
                        -num / np.where(den == 0, 1.0, den)
                        * (cf / SOUND_SPEED))


def trajectories() -> np.ndarray:
    """(125, 4) (V1, V2, p1, p2): V2, then V1 over -2..2, p2 fastest over
    50..850 in steps of 200, p1 = 0."""
    vals = np.arange(-2.0, 2.0 + 1e-9, 1.0)
    p2s = np.arange(50.0, 850.0 + 1e-9, 200.0)
    return np.array([(v1, v2, 0.0, p2) for v2 in vals for v1 in vals
                     for p2 in p2s])


def tables(s: dict, device) -> dict:
    """The decoder's constant tables, on ``device``."""
    c, d = s["coarse"], s["demod"]
    df = s["df"]
    k = np.arange(162)
    rows, nl, drift, slm = [], [], [], []
    for dr in range(-c["maxdrift"], c["maxdrift"] + 1):
        rows.append(np.floor((k - 81.0) / 81.0 * dr / (2.0 * df))
                    .astype(np.int64))
        nl.append(False)
        drift.append(float(dr))
        slm.append((0.0, 0.0, 0.0, 0.0))
    if c["search_nonlinear"]:
        t = (np.arange(162) * 111 // 162).astype(np.float64)
        for v1, v2, p1, p2 in trajectories():
            x = slm_drift_np(v1, v2, p1, p2, c["cf"], t).astype(np.float32)
            rows.append(np.floor(x / np.float32(df)).astype(np.int64))
            nl.append(True)
            drift.append(0.0)
            slm.append((v1, v2, p1, p2))
    idt = np.arange(d["n_jiggles"])
    ii = (idt + 1) // 2
    jig = np.where(idt % 2 == 1, -ii, ii) * d["iifac"]
    sign = 2.0 * P.SYNC_VECTOR.astype(np.float32) - 1.0
    dev = device
    return {
        "offsets": torch.as_tensor(np.stack(rows), device=dev),
        "is_nl": torch.as_tensor(np.array(nl), device=dev),
        "is_nl_np": np.array(nl),
        "model_drift": torch.as_tensor(np.array(drift, np.float32),
                                       device=dev),
        "model_slm": torch.as_tensor(np.array(slm, np.float32), device=dev),
        "sign": torch.as_tensor(sign, device=dev),
        "sync_bit": torch.as_tensor(P.SYNC_VECTOR.astype(bool), device=dev),
        "perm": torch.as_tensor(P.INTERLEAVE_PERM, device=dev),
        "jiggles": torch.as_tensor(jig.astype(np.int64), device=dev),
        "tones": torch.as_tensor((P.TONE_OFFSETS * P.TONE_SPACING)
                                 .astype(np.float32), device=dev),
    }


# ------------------------------------------------------------ the decoder

class PlainDecoder:
    """The reference decode of (W, 2, fl) float32 windows on ``device``."""

    def __init__(self, pipeline: dict, batch: int, device,
                 prec: str = "stated"):
        self.s = serving(pipeline, batch)
        self.device = torch.device(device)
        self.p = Prec(prec)
        self.t = tables(self.s, self.device)
        m = self.s["fft"] // 2
        hpbm = self.s["hpbm"]
        self.cols = (max(0, m - hpbm - 10), min(self.s["fft"], m + hpbm + 10))

    # -- coarse ---------------------------------------------------------

    def stft_power(self, z: torch.Tensor) -> torch.Tensor:
        size, hop, n_ffts = self.s["fft"], self.s["coarse"]["spb"] // 2, \
            self.s["n_ffts"]
        j = np.arange(size)
        w = torch.as_tensor(np.sin(np.pi / (size - 1) * j).astype(np.float32),
                            device=z.device)
        k = np.arange(size)
        ang = -2.0 * np.pi * np.outer(k, k) / size
        shift = np.roll(np.arange(size), size // 2)
        lo, hi = self.cols
        Cm = torch.as_tensor(np.cos(ang)[:, shift][:, lo:hi]
                             .astype(np.float32), device=z.device)
        Sm = torch.as_tensor(np.sin(ang)[:, shift][:, lo:hi]
                             .astype(np.float32), device=z.device)
        kk = size // hop
        n_rows = n_ffts + kk - 1
        pad_to = n_rows * hop

        def frames_of(x):
            fl = x.shape[-1]
            x = (F.pad(x, (0, pad_to - fl)) if pad_to > fl
                 else x[..., :pad_to])
            R = x.reshape(x.shape[:-1] + (n_rows, hop))
            return torch.cat([R[..., i:i + n_ffts, :] for i in range(kk)],
                             dim=-1) * w
        fr, fi = frames_of(z.real), frames_of(z.imag)
        lo_ = self.p.lo

        def mm(a, b):
            return torch.matmul(lo_(a), lo_(b))
        re = mm(fr, Cm) - mm(fi, Sm)
        im = mm(fr, Sm) + mm(fi, Cm)
        return re * re + im * im

    def smoothed(self, ps: torch.Tensor) -> torch.Tensor:
        hpbm, m, col0 = self.s["hpbm"], self.s["fft"] // 2, self.cols[0]
        psavg = ps.sum(dim=-2)
        finpb = 2 * hpbm
        lo = m - hpbm - col0
        pad = F.pad(psavg, (3, 3))
        sm = sum(pad[..., lo + 3 + j: lo + 3 + j + finpb]
                 for j in range(-3, 4))
        srt = torch.sort(sm, dim=-1).values
        noise = srt[..., int(np.floor(0.3 * finpb))]
        snr = sm / noise[..., None] - 1.0
        min_snr = 10.0 ** (-7.0 / 10.0)
        return torch.where(snr < min_snr, 0.1 * min_snr, snr).float()

    def peaks(self, sm: torch.Tensor):
        hpbm, C, m = self.s["hpbm"], self.s["n_cand"], self.s["fft"] // 2
        finpb = 2 * hpbm
        j = torch.arange(finpb, device=sm.device)
        left = torch.roll(sm, 1, dims=-1)
        right = torch.roll(sm, -1, dims=-1)
        is_peak = (sm > left) & (sm > right) & (j >= 1) & (j <= finpb - 2)
        rank = torch.cumsum(is_peak.to(torch.int64), dim=-1)
        keep = is_peak & (rank <= C)
        key = torch.where(keep, j, finpb + 1)
        key = torch.cat([key, torch.full(key.shape[:-1] + (C,), finpb + 1,
                                         dtype=key.dtype, device=sm.device)],
                        dim=-1)
        sel = torch.sort(key, dim=-1).values[..., :C]
        valid = sel < finpb
        sel = torch.clamp(sel, max=finpb - 1)
        snr_db = 10.0 * torch.log10(torch.gather(sm, -1, sel))
        sortkey = torch.where(valid, -snr_db, float("inf"))
        order = torch.argsort(sortkey, dim=-1, stable=True)
        sel = torch.gather(sel, -1, order)
        valid = torch.gather(valid, -1, order)
        snr_db = torch.gather(snr_db, -1, order)
        return valid, sel - hpbm + m, torch.where(valid, snr_db, 0.0)

    def grid(self, ps: torch.Tensor, if0: torch.Tensor) -> torch.Tensor:
        """(B, C, 5, 26, M) sync = ss / pow of the dilated correlation."""
        hpbm, m, cb0 = self.s["hpbm"], self.s["fft"] // 2, self.cols[0]
        n_lags = 26
        size = ps.shape[-1]
        rt = torch.sqrt(ps)
        pad = F.pad(rt, (_D_MAX + 3, _D_MAX + 3))

        def at(d):
            return pad[..., _D_MAX + 3 + d: _D_MAX + 3 + d + size]
        A = (at(-1) + at(3)) - (at(-3) + at(1))
        B = at(-3) + at(-1) + at(1) + at(3)
        lo = max(m - hpbm - 1 - 6 - cb0, 0)
        hi = min(m + hpbm + 1 + 6 - cb0, size)
        A, B = A[..., lo:hi], B[..., lo:hi]
        if self.s["grid_dtype"] == "bf16":
            A, B = self.p.lo(A), self.p.lo(B)
        else:
            A, B = self.p.f32(A), self.p.f32(B)
        onehot = F.one_hot((self.t["offsets"] - _D_MIN).long(),
                           _N_SHIFTS).float()
        W_ss = onehot * self.t["sign"][None, :, None]
        width = hi - lo
        ifr = (if0[..., None] - cb0 + torch.arange(-2, 3, device=ps.device)
               - lo).long()
        ifr = torch.where(ifr < 0, ifr + width, ifr).clamp(0, width - 1)
        bidx = torch.arange(ps.shape[0], device=ps.device)[:, None, None]
        if self.s["grid_impl"] == "conv":
            Ax = F.pad(A, (_D_MAX, -_D_MIN))[:, None]
            Bx = F.pad(B, (_D_MAX, -_D_MIN))[:, None]
            ss = F.conv2d(Ax, W_ss[:, None], dilation=(2, 1))[:, :, :n_lags]
            pw = F.conv2d(Bx, onehot[:, None], dilation=(2, 1))[:, :, :n_lags]
            return (ss[bidx, :, :, ifr] / pw[bidx, :, :, ifr]
                    ).transpose(-1, -2).float()

        def im2col(X):
            padx = F.pad(X, (_N_SHIFTS, _N_SHIFTS))
            off0 = _D_MIN + _N_SHIFTS
            S = torch.stack([padx[..., d + off0:d + off0 + width]
                             for d in range(_N_SHIFTS)], dim=-2)
            return torch.stack([S[:, k0:k0 + 2 * 162:2]
                                for k0 in range(n_lags)], dim=1)
        step = max(1, _IM2COL_BYTES // (n_lags * 162 * _N_SHIFTS * width * 4))
        out = []
        for b0 in range(0, ps.shape[0], step):
            sl = slice(b0, b0 + step)
            ss = torch.einsum("mkd,bwkdf->bwmf", W_ss, im2col(A[sl]))
            pw = torch.einsum("mkd,bwkdf->bwmf", onehot, im2col(B[sl]))
            bi, fi = bidx[:ss.shape[0]], ifr[sl]
            out.append(ss[bi, :, :, fi] / pw[bi, :, :, fi])
        return torch.cat(out).float()

    def coarse(self, ri: torch.Tensor) -> dict:
        z = torch.complex(ri[:, 0], ri[:, 1])
        ps = self.stft_power(z)
        valid, if0, snr = self.peaks(self.smoothed(ps))
        g = self.grid(ps, if0)
        W, C = g.shape[:2]
        M = g.shape[-1]
        _, idx = select_literal(
            g.reshape((W * C,) + g.shape[2:]).cpu().numpy(),
            self.t["is_nl_np"], self.s["coarse"]["threshold"])
        idx = torch.as_tensor(idx.astype(np.int64),
                              device=ri.device).reshape(W, C)
        fi = torch.div(idx, 26 * M, rounding_mode="floor")
        k0 = torch.div(idx, M, rounding_mode="floor") % 26
        mm = idx % M
        freq = ((if0 + fi - 2) - self.s["fft"] // 2).float() \
            * np.float32(self.s["df"])
        return {"z": z, "valid": valid, "snr": snr, "freq": freq.float(),
                "shift": 128 * k0, "drift": self.t["model_drift"][mm],
                "mode": self.t["is_nl"][mm].to(torch.int64),
                "slm_params": self.t["model_slm"][mm]}

    # -- refinement -----------------------------------------------------

    def drift_offsets(self, mode, drift, slm):
        dev = drift.device
        i = torch.arange(162, dtype=torch.float32, device=dev)
        lin = (drift[:, None] / 2.0) * (i[None, :] - 81.0) / 81.0
        t = torch.div(torch.arange(162, device=dev) * 111, 162,
                      rounding_mode="floor").float()[None, :]
        v1, v2, p1, p2 = (slm[:, k:k + 1] for k in range(4))
        q1 = v1 * t + p1
        q2 = v2 * t + p2
        num = v1 * q1 + v2 * q2
        den = torch.sqrt(q1 * q1 + q2 * q2)
        zero = den == 0.0
        nl = torch.where(zero, 0.0, -num / torch.where(zero, 1.0, den)
                         * (float(self.s["coarse"]["cf"]) / SOUND_SPEED))
        return torch.where((mode == 1)[:, None], nl, lin).float()

    def probe(self, z_all, widx, center, reach, Wp, block):
        """(L, 2, 162, Wp) planes of the window around each lane's lag."""
        B, N = z_all.shape
        Np = N + 2 * _PAD + Wp
        start_min = center.to(torch.int64) + _PAD - reach
        base = torch.clamp(torch.div(start_min, block, rounding_mode="floor")
                           * block, 0, Np - (_FRAME + Wp))
        span = torch.arange(_FRAME + Wp, device=z_all.device)
        pos = base[:, None] + span[None, :] - _PAD
        inside = (pos >= 1) & (pos < N)
        posc = torch.clamp(pos, 0, N - 1)
        wi = widx.to(torch.int64)[:, None]
        planes = [self.p.lo(x) for x in (z_all.real, z_all.imag)]
        A = torch.stack([torch.where(inside, q[wi, posc], 0.0)
                         for q in planes], dim=1)
        return A.unfold(-1, Wp, 256)[..., :162, :].contiguous(), base

    def _ramp_ri(self, theta, Wd):
        lo = self.p.lo
        j1 = torch.arange(64, dtype=torch.float32, device=theta.device)
        j2 = torch.arange(Wd // 64, dtype=torch.float32,
                          device=theta.device) * 64.0
        a1, a2 = theta[..., None] * j1, theta[..., None] * j2
        ur, ui = lo(torch.cos(a1)), lo(torch.sin(a1))
        vr, vi = lo(torch.cos(a2)), lo(torch.sin(a2))
        cr = lo(lo(vr[..., :, None] * ur[..., None, :])
                - lo(vi[..., :, None] * ui[..., None, :]))
        ci = lo(lo(vr[..., :, None] * ui[..., None, :])
                + lo(vi[..., :, None] * ur[..., None, :]))
        shp = theta.shape + (Wd,)
        return cr.reshape(shp), ci.reshape(shp)

    def derotate(self, Amat, dsym):
        lo = self.p.lo
        cr, ci = self._ramp_ri((-2.0 * np.pi * _DT) * dsym, Amat.shape[-1])
        ar, ai = Amat[..., 0, :, :], Amat[..., 1, :, :]
        zr = lo(lo(ar * cr) - lo(ai * ci))
        zi = lo(lo(ar * ci) + lo(ai * cr))
        return torch.stack([zr, zi], dim=-3)

    def probe_eval(self, zd, base, lags, freqs, n_lags, want_symbols=False):
        lo = self.p.lo
        C, F_ = freqs.shape
        Wd = zd.shape[-1]
        dev = zd.device
        jpf = torch.arange(Wd, dtype=torch.float32, device=dev)
        b = torch.clamp(lags.to(torch.int64) + _PAD - base[:, None], 0,
                        Wd - 256)
        ft = freqs[..., None] + self.t["tones"]
        theta = (-2.0 * np.pi * _DT) * ft
        j1 = torch.arange(64, dtype=torch.float32, device=dev)
        j2 = torch.arange(Wd // 64, dtype=torch.float32, device=dev) * 64.0
        a1, a2 = theta[..., None] * j1, theta[..., None] * j2
        u = torch.complex(torch.cos(a1), torch.sin(a1))
        v = torch.complex(torch.cos(a2), torch.sin(a2))
        bank = (v[..., :, None] * u[..., None, :]).reshape(
            theta.shape + (Wd,)).reshape(C, 1, 4 * F_, Wd)
        mask = ((jpf[None, None, :] >= b[..., None])
                & (jpf[None, None, :] < b[..., None] + 256)).float()
        maskb = mask[:, :, None, :]
        br = lo(lo(bank.real) * maskb)
        bi = lo(lo(bank.imag) * maskb)
        zr, zi = zd[..., 0, :, :], zd[..., 1, :, :]

        def lane(x, bk):
            Cc, L, Mb, Wx = bk.shape
            out = torch.bmm(x, bk.reshape(Cc, L * Mb, Wx).transpose(1, 2))
            return out.reshape(Cc, 162, L, Mb).permute(0, 2, 1, 3)
        re = lane(zr, br) - lane(zi, bi)
        im = lane(zr, bi) + lane(zi, br)
        p = torch.sqrt(re * re + im * im)
        p = p.reshape(C, n_lags, 162, F_, 4).permute(0, 3, 1, 2, 4)
        cmet = (p[..., 1] + p[..., 3]) - (p[..., 0] + p[..., 2])
        f32 = self.p.f32
        ss = torch.einsum("cfli,i->cfl", f32(cmet), f32(self.t["sign"]))
        sync = (ss / p.sum(dim=(-2, -1))).float()
        return (sync, p) if want_symbols else sync

    def refine_common(self, st, z_all, widx):
        dcfg = self.s["demod"]
        dev = st["freq"].device
        valid, mode, slm = st["valid"], st["mode"], st["slm_params"]
        C = valid.shape[0]
        cidx = torch.arange(C, device=dev)
        f1, shift1, drift1 = st["freq"].float(), st["shift"], st["drift"]
        dsym = self.drift_offsets(mode, drift1, slm)
        Amat1, base1 = self.probe(z_all, widx, shift1, 128, 640, 128)
        zd1 = self.derotate(Amat1, dsym)
        lag_grid = shift1[:, None] + torch.arange(-128, 129, 64, device=dev)
        freq_grid = f1[:, None] + _offsets(0.25, dev)[None, :]
        s = self.probe_eval(zd1, base1, lag_grid, freq_grid, 5)
        li = torch.argmax(s[:, 2, :], dim=1)
        shift1 = lag_grid[cidx, li]
        fi2 = torch.argmax(s[cidx, :, li], dim=1)
        f1 = freq_grid[cidx, fi2]
        sync1 = s[cidx, fi2, li]
        Amat2, base2 = self.probe(z_all, widx, shift1, 96, 640, 128)
        Amat2d = Amat2[..., 96:480]
        base2d = base2 + 96
        is_lin = mode != 1
        driftp, driftm = drift1 + 0.5, drift1 - 0.5
        sp = self.probe_eval(
            self.derotate(Amat2d, self.drift_offsets(mode, driftp, slm)),
            base2d, shift1[:, None], f1[:, None], 1)[:, 0, 0]
        sm_ = self.probe_eval(
            self.derotate(Amat2d, self.drift_offsets(mode, driftm, slm)),
            base2d, shift1[:, None], f1[:, None], 1)[:, 0, 0]
        updp = is_lin & (sp > sync1)
        updm = is_lin & ~updp & (sm_ > sync1)
        drift1 = torch.where(updp, driftp, torch.where(updm, driftm, drift1))
        sync1 = torch.where(updp, sp, torch.where(updm, sm_, sync1))
        return {"valid": valid, "snr": st["snr"], "freq": f1,
                "shift": shift1, "drift": drift1, "mode": mode,
                "slm_params": slm, "sync1": sync1,
                "worth0": sync1 > dcfg["minsync1"], "Amat2": Amat2,
                "base2": base2}

    def tail(self, st):
        dcfg = self.s["demod"]
        dev = st["freq"].device
        C = st["shift"].shape[0]
        cidx = torch.arange(C, device=dev)
        valid = st["valid"]
        f1, shift1, drift1 = st["freq"], st["shift"], st["drift"]
        dsym = self.drift_offsets(st["mode"], drift1, st["slm_params"])
        zd2 = self.derotate(st["Amat2"], dsym)
        base2 = st["base2"]
        worth = st["worth0"]
        lag_grid = shift1[:, None] + torch.arange(-32, 33, 16, device=dev)
        freq_grid = f1[:, None] + _offsets(0.05, dev)[None, :]
        s = self.probe_eval(zd2, base2, lag_grid, freq_grid, 5)
        li = torch.argmax(s[:, 2, :], dim=1)
        shift1 = torch.where(worth, lag_grid[cidx, li], shift1)
        li = torch.where(worth, li, 2)
        fi2 = torch.argmax(s[cidx, :, li], dim=1)
        f1 = torch.where(worth, freq_grid[cidx, fi2], f1)
        worth = worth & valid
        jig = self.t["jiggles"]
        lag_grid = shift1[:, None] + jig[None, :]
        sync2, p = self.probe_eval(zd2, base2, lag_grid, f1[:, None],
                                   jig.shape[0], want_symbols=True)
        sync2, p = sync2[:, 0, :], p[:, 0]
        fsymb = torch.where(self.t["sync_bit"][None, None, :],
                            p[..., 3] - p[..., 1], p[..., 2] - p[..., 0])
        fsum = fsymb.mean(dim=-1, keepdim=True)
        f2sum = (fsymb * fsymb).mean(dim=-1, keepdim=True)
        fac = torch.sqrt(f2sum - fsum * fsum)
        scaled = dcfg["symfac"] * fsymb / torch.clamp(fac, min=1e-12)
        scaled = torch.clamp(torch.nan_to_num(scaled), -128.0, 127.0)
        symbols = torch.floor(scaled + 128.0).to(torch.uint8)
        y = symbols.float() - 128.0
        rms = torch.sqrt((y * y).mean(dim=-1))
        minrms = 52.0 * (dcfg["symfac"] / 64.0)
        gate = (worth[:, None] & (sync2 > dcfg["minsync2"]) & (rms > minrms))
        deint = symbols[..., self.t["perm"]]
        return {"worth": worth, "freq": f1, "shift": shift1, "sync2": sync2,
                "gate": gate, "deint": deint}

    def prefano(self, ri: torch.Tensor) -> dict:
        """(W, 2, fl) -> per (W, C) lane: the coarse fields, the refined
        freq/shift/drift, worth, sync2 and gate (W, C, J), deinterleaved
        soft symbols (W, C, J, 162) u8 and the refine overflow (W,)."""
        mm, cd = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                return self._compact(self.coarse(ri))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = mm
            torch.backends.cudnn.allow_tf32 = cd

    def _compact(self, co: dict) -> dict:
        d = self.s["demod"]
        z_all = co.pop("z")
        W, C = co["valid"].shape
        dev = z_all.device
        J = d["n_jiggles"]
        ML = min(d["cand_compact_lanes"], W * C)
        flat = {k: v.reshape((W * C,) + v.shape[2:]) for k, v in co.items()}
        key = torch.where(flat["valid"], -flat["snr"], float("inf"))
        sel = torch.argsort(key, stable=True)[:ML]
        widx = torch.div(sel, C, rounding_mode="floor")
        head = self.refine_common({k: v[sel] for k, v in flat.items()},
                                  z_all, widx)
        worthy = head["worth0"] & head["valid"]
        ML2 = min(d["refine_max_lanes"], ML)
        sel2 = torch.argsort((~worthy).to(torch.int8), stable=True)[:ML2]
        sub = {k: head[k][sel2]
               for k in ("valid", "freq", "shift", "drift", "mode",
                         "slm_params", "sync1", "Amat2", "base2")}
        sub["worth0"] = worthy[sel2]
        tl = self.tail(sub)
        gsel = sel[sel2]

        def scat(base_flat, vals):
            out = base_flat.clone()
            out[gsel] = vals
            return out.reshape((W, C) + vals.shape[1:])

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        freq = flat["freq"].clone()
        freq[sel] = head["freq"]
        shift = flat["shift"].clone()
        shift[sel] = head["shift"]
        drift = flat["drift"].clone()
        drift[sel] = head["drift"]
        kept = zeros(W * C, torch.bool).index_fill_(0, sel, True)
        tailed = zeros(ML, torch.bool).index_fill_(0, sel2, True)
        worth_dropped = zeros(W * C, torch.bool)
        worth_dropped[sel] = worthy & ~tailed
        overflow = ((flat["valid"] & ~kept).reshape(W, C).sum(dim=1)
                    + worth_dropped.reshape(W, C).sum(dim=1))
        return {
            "valid": co["valid"], "snr": co["snr"], "mode": co["mode"],
            "slm_params": co["slm_params"], "drift": drift.reshape(W, C),
            "worth": scat(zeros(W * C, torch.bool), tl["worth"]),
            "freq": scat(freq, tl["freq"]),
            "shift": scat(shift, tl["shift"]),
            "sync2": scat(zeros((W * C, J), torch.float32), tl["sync2"]),
            "gate": scat(zeros((W * C, J), torch.bool), tl["gate"]),
            "deint": scat(zeros((W * C, J, 162), torch.uint8), tl["deint"]),
            "overflow": overflow,
        }


def _offsets(step: float, device) -> torch.Tensor:
    return torch.arange(-2, 3, dtype=torch.float32, device=device) \
        * np.float32(step)


def to_numpy(pre: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in pre.items()}


def outputs(pre: dict, lanes: dict) -> dict:
    """Numpy prefano fields and the Fano results of their gated lanes
    (``fano.decode_gated``) -> the typed fields of the port's packed output,
    each (W, C): success, payload (W, C, 7), sync, jiggle, and the window
    counts fano_attempts and fano_overflow (W,)."""
    gate = pre["gate"]
    W, C, J = gate.shape
    succ = lanes["success"]                               # (W, C, J)
    first = np.argmax(succ, axis=2)
    any_s = succ.any(axis=2)
    wi, ci = np.indices((W, C))
    return {
        "success": any_s & pre["worth"],
        "payload": lanes["data"][wi, ci, first, :7],
        "jiggle": np.where(any_s, first, 0),
        "sync": pre["sync2"][wi, ci, np.where(any_s, first, 0)],
        "fano_attempts": gate.sum(axis=(1, 2)),
        "fano_overflow": pre["overflow"],
    }
