"""Probe tone powers for fine sync and soft symbols: CUDA kernel + plain
version.

Replaces uwspr_tpu/ops/probe_pallas.py::probe_powers_pallas. For every
(candidate c, freq f, lag l, symbol i, tone t) probe it returns the tone
power |corr| of the 256 samples of symbol i at lag l, derotated by the
candidate's per-symbol drift and correlated with tone t of probe frequency
f: p (C, F, L, 162, 4) float32, the layout of demod/finesync.py.

The lag semantics are those of the JAX wrappers (finesync.py:120-130,
probe_pallas.py:141-143): each candidate reads one 256-aligned window whose
start ``base`` covers its lowest lag, every lag is an offset ``b`` into it,
and both phases are taken at the window-local index j' = b + k. Samples
outside 0 < n < N read as zero (the reference's correlation guard).

``probe_powers`` is the entry point. For CUDA tensors it launches
``csrc/probe_powers.cu`` and counts the launch in ``KERNEL_LAUNCHES``. The
kernel builds, per candidate and tile of symbols, the derotated window and
the tone bank once in shared memory and lets every lag read its slice of
them (neither depends on the lag); ``kernel_tiling`` picks its symbols per
block and block size. For
CPU tensors it runs ``probe_powers_plain``, a transcription of
``_probe_powers_xla`` (finesync.py:103-154): one (162, 1024) overlapped
window per candidate, a masked tone bank and one complex64 product per
candidate, counted in ``PLAIN_CALLS``.
"""

from __future__ import annotations

import numpy as np
import torch

from uwspr_tpu_torch.protocol.constants import (
    SAMPLE_RATE,
    TONE_OFFSETS,
    TONE_SPACING,
)
from uwspr_tpu_torch.utils import cuda_build

# launches of the CUDA kernel / calls of the plain version, in this process
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

PAD = 4096              # zeros in front of the window (negative lags)
_W = 1024               # aligned window width covering every lag of a stage
_FRAME = 162 * 256
_MAX_F = 16             # probe freqs per candidate the kernel takes
_MAX_HALF = 32          # kernel symbols per block, halved (16 at one freq)
_ROW = 129              # the kernel's padded shared-memory row (float2)
# -2*pi/fs rounded to f32, as the JAX code's weak-typed Python float
PHASE = np.float32(-2.0 * np.pi * (1.0 / SAMPLE_RATE))
TONES_HZ = (TONE_OFFSETS * TONE_SPACING).astype(np.float32)      # (4,)


def reset_counters() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


def lag_offsets(lags: torch.Tensor, n: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, L) window-relative lags -> (base (C,), b (C, L)) int64: the
    candidate's 256-aligned start in the padded window and each lag's offset
    into it, clipped as finesync.py:127-130 does."""
    n_padded = n + 2 * PAD + _W
    starts = torch.clamp(lags.to(torch.int64) + PAD, 0, PAD + n)
    base = torch.clamp(
        torch.div(starts.amin(dim=1), 256, rounding_mode="floor") * 256,
        max=n_padded - (_FRAME + _W))
    b = torch.clamp(starts - base[:, None], 0, _W - 256)
    return base, b


def kernel_tiling(n_lags: int, n_freqs: int) -> tuple[int, int, int]:
    """The probe kernel's (symbols per block S, threads per block, dynamic
    shared memory in bytes) for L lags and F freqs. Each thread owns one
    (lag, freq) and 2 symbols, so threads cover L * F * S / 2; S is as large
    as keeps that near 256 threads (at most 64 symbols), then evened out
    over the 162 symbols' tiles. With one freq the bank is small and the
    derotated window's fill dominates, and tiles of at most 32 symbols ran
    faster (scripts/torch_probe_tiling.py). A block has at least 128
    threads, which all build the shared derotated window and bank (the
    host engine's drift stage, L = F = 1, has 14 outputs per block)."""
    lf = n_lags * n_freqs
    half = max(1, min(_MAX_HALF // 2 if n_freqs == 1 else _MAX_HALF,
                      256 // lf))
    tiles = -(-162 // (2 * half))
    half = -(-(-(-162 // tiles)) // 2)
    threads = max(128, -(-lf * half // 32) * 32)
    if threads > 1024:
        raise ValueError(f"probe kernel takes L * F <= 1024, got {lf}")
    return 2 * half, threads, 8 * (2 * half + 4 * n_freqs) * _ROW


def _check(z_ri, lags, freqs, drift_sym, n_lags):
    if z_ri.dim() != 2 or z_ri.shape[0] != 2 or z_ri.dtype != torch.float32:
        raise ValueError(f"z_ri must be (2, N) float32, got "
                         f"{tuple(z_ri.shape)} {z_ri.dtype}")
    C, F = freqs.shape
    if tuple(lags.shape) != (C, n_lags):
        raise ValueError(f"lags {tuple(lags.shape)} != ({C}, {n_lags})")
    if tuple(drift_sym.shape) != (C, 162):
        raise ValueError(f"drift_sym {tuple(drift_sym.shape)} != ({C}, 162)")
    for name, x in (("lags", lags), ("freqs", freqs), ("drift", drift_sym)):
        if x.device != z_ri.device:
            raise ValueError(f"{name} lies on {x.device}, z_ri on "
                             f"{z_ri.device}")


def probe_powers(z_ri: torch.Tensor, lags: torch.Tensor, freqs: torch.Tensor,
                 drift_sym: torch.Tensor, *, n_lags: int) -> torch.Tensor:
    """z_ri (2, N) f32 window, lags (C, L) int, freqs (C, F) f32 absolute
    probe frequencies, drift_sym (C, 162) f32 per-symbol drift in Hz ->
    p (C, F, L, 162, 4) f32."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    _check(z_ri, lags, freqs, drift_sym, n_lags)
    if z_ri.device.type == "cpu":
        PLAIN_CALLS += 1
        return probe_powers_plain(z_ri, lags, freqs, drift_sym,
                                  n_lags=n_lags)
    if z_ri.device.type != "cuda":
        raise ValueError(f"probe_powers: unsupported device {z_ri.device}")
    C, F = freqs.shape
    if not 1 <= F <= _MAX_F:
        raise ValueError(f"probe_powers kernel takes 1..{_MAX_F} freqs, "
                         f"got {F}")
    S, threads, _ = kernel_tiling(n_lags, F)
    N = z_ri.shape[1]
    lg = lags.to(torch.int32).contiguous()     # clipped in the kernel
    z = z_ri.contiguous()
    fq = freqs.to(torch.float32).contiguous()
    dr = drift_sym.to(torch.float32).contiguous()
    out = torch.empty((C, F, n_lags, 162, 4), dtype=torch.float32,
                      device=z.device)
    lib = cuda_build.load_library()
    code = lib.uwspr_probe_powers(
        z.data_ptr(), N, lg.data_ptr(), fq.data_ptr(), dr.data_ptr(), C,
        n_lags, F, S, threads, float(PHASE), out.data_ptr(),
        torch.cuda.current_stream(z.device).cuda_stream)
    cuda_build.check_launch("uwspr_probe_powers", code)
    KERNEL_LAUNCHES += 1
    return out


def probe_powers_plain(z_ri: torch.Tensor, lags: torch.Tensor,
                       freqs: torch.Tensor, drift_sym: torch.Tensor, *,
                       n_lags: int) -> torch.Tensor:
    """_probe_powers_xla (finesync.py:103-154) in torch: Amat[c, i, j'] =
    zp[base_c + 256*i + j'], derotated and multiplied by the tone bank
    masked to each lag's columns [b, b+256), as one complex64 product per
    candidate."""
    N = z_ri.shape[1]
    C, F = freqs.shape
    dev = z_ri.device
    base, b = lag_offsets(lags, N)
    z = torch.complex(z_ri[0], z_ri[1])
    pos = base[:, None] + torch.arange(_FRAME + _W, device=dev) - PAD
    inside = (pos >= 1) & (pos < N)                   # z[0] is zeroed
    A = torch.where(inside, z[torch.clamp(pos, 0, N - 1)], 0)
    Amat = A.unfold(-1, _W, 256)[:, :162]             # (C, 162, W)
    jpf = torch.arange(_W, dtype=torch.float32, device=dev)
    phase = torch.tensor(PHASE, device=dev)
    wd = (phase * drift_sym.float())[..., None] * jpf
    zd = Amat * torch.complex(torch.cos(wd), torch.sin(wd))
    ft = freqs.float()[..., None] + torch.from_numpy(TONES_HZ).to(dev)
    wb = (phase * ft)[..., None] * jpf                # (C, F, 4, W)
    bank = torch.complex(torch.cos(wb), torch.sin(wb)).reshape(C, 1, 4 * F,
                                                                _W)
    mask = ((jpf >= b[..., None]) & (jpf < b[..., None] + 256)).float()
    bankm = (bank * mask[:, :, None, :]).reshape(C, n_lags * 4 * F, _W)
    corr = torch.bmm(zd, bankm.transpose(1, 2))       # (C, 162, L*4F)
    p = torch.abs(corr).reshape(C, 162, n_lags, F, 4)
    return p.permute(0, 3, 2, 1, 4).contiguous()      # (C, F, L, 162, 4)


__all__ = ["KERNEL_LAUNCHES", "PAD", "PHASE", "PLAIN_CALLS", "TONES_HZ",
           "kernel_tiling", "lag_offsets", "probe_powers", "probe_powers_plain",
           "reset_counters"]
