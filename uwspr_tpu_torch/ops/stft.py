"""Batched STFT power spectrum for the coarse search (torch): plain forms and
the fused CUDA kernel.

Counterpart of uwspr_tpu/ops/stft.py::stft_power_core and stft_power: 348
half-sine windowed 512-point transforms stepped by half symbols, DC at
column ``size/2`` (lib/FDR_impl.cc:222-254), batched over leading dims.

``impl="pallas"`` replaces uwspr_tpu/ops/stft_pallas.py::stft_power_pallas.
For CUDA tensors it launches ``csrc/stft_power.cu``, which runs the DFT as
one bf16 GEMM on the tensor cores, D = [fr | fi] . [[C, S], [-S, C]] with
f32 sums, builds the windowed frames in registers from samples staged in
shared memory and squares adjacent (re, im) columns of D, so frames never
reach device memory; the launch is counted in ``KERNEL_LAUNCHES``. Its B
operand is built once per decoder by ``dft_fragments``, in the kernel's
fragment order. For CPU tensors it runs the plain
version with the same numerics, ``impl="matmul_bf16"`` (window applied in
f32, frames and cos/sin rounded to bf16, f32 accumulation), counted in
``PLAIN_CALLS``.

The DFT product of ``impl="matmul_bf16"`` is a plain matrix product, as the
JAX package leaves it to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.utils import cuda_build

# launches of the CUDA kernel / calls of the plain version, in this process
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counters() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


def half_sine_window(size: int) -> np.ndarray:
    """w[j] = sin(pi/(size-1) * j) — reference lib/FDR_impl.cc:100-105."""
    return np.sin(np.pi / (size - 1) * np.arange(size)).astype(np.float32)


def dft_matrices(size: int, col_window: tuple[int, int] | None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """float32 cos/sin DFT matrices with the fftshift folded in: output
    column j is bin (j - size/2) mod size (ops/stft.py:75-84)."""
    k = np.arange(size)
    ang = -2.0 * np.pi * np.outer(k, k) / size
    shift = np.roll(np.arange(size), size // 2)
    C = np.cos(ang)[:, shift].astype(np.float32)
    S = np.sin(ang)[:, shift].astype(np.float32)
    if col_window is not None:
        C = C[:, col_window[0]:col_window[1]]
        S = S[:, col_window[0]:col_window[1]]
    return np.ascontiguousarray(C), np.ascontiguousarray(S)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 product with float32 accumulation, returned in float32.

    ``torch.matmul`` on bf16 tensors returns bf16 (a second rounding that
    JAX's ``preferred_element_type=f32`` does not have). A product of two
    bf16 values is exact in f32, so upcasting the bf16-rounded operands and
    multiplying in f32 (TF32 off) gives the f32-accumulated result."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


def mma_tiles(ncols: int) -> int:
    """n8 tiles of the kernel's GEMM per block for ``ncols`` output columns
    (2 * ncols GEMM columns): 4, 8, 12 or 16 (a block's 16 frames x 128
    columns of accumulators per warp at most)."""
    tiles = -(-2 * ncols // 8)
    return min(16, -(-tiles // 4) * 4)


def dft_fragments(cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The STFT kernel's B operand from the (size, ncols) cos/sin matrices:
    bf16 (n_blocks, size/8, nt, 32, 4), nt = mma_tiles(ncols).

    B' = [[C, S], [-S, C]] with its columns interleaved as (re, im) pairs of
    each output column (GEMM column 2c is re of column c, 2c+1 its im) and
    its K rows taken in k16 steps: rows 16s..16s+7 are [C, S] of DFT rows
    8s..8s+7 (they meet the real parts of the frame), rows 16s+8..16s+15
    [-S, C] of the same DFT rows (the imaginary parts). Columns past
    2 * ncols are zero. Entry [nb, s, i, lane, m] is B'[16s + k, n] with
    n = 8 * (nb * nt + i) + lane // 4 and k = (2t, 2t+1, 2t+8, 2t+9)[m],
    t = lane % 4: the (b0, b1) registers of an mma.sync m16n8k16 B fragment
    of n8 tile i in k16 step s, as lane ``lane`` reads them."""
    size, ncols = cos.shape
    if size % 8:
        raise ValueError(f"DFT size {size} is not a multiple of 8")
    nt = mma_tiles(ncols)
    n_blocks = -(-2 * ncols // (8 * nt))
    steps = size // 8
    cb = cos.to(torch.bfloat16).cpu().reshape(steps, 8, ncols)
    sb = sin.to(torch.bfloat16).cpu().reshape(steps, 8, ncols)
    B = torch.zeros((steps, 16, n_blocks * nt * 8), dtype=torch.bfloat16)
    B[:, :8, 0:2 * ncols:2] = cb
    B[:, :8, 1:2 * ncols:2] = sb
    B[:, 8:, 0:2 * ncols:2] = -sb          # negation is exact in bf16
    B[:, 8:, 1:2 * ncols:2] = cb
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    k = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], dim=-1)
    n = (8 * (torch.arange(n_blocks)[:, None, None] * nt
              + torch.arange(nt)[None, :, None]) + g)           # (nb, nt, 32)
    frag = B[torch.arange(steps)[None, :, None, None, None],
             k[None, None, None], n[:, None, :, :, None]]
    return frag.contiguous()                # (nb, steps, nt, 32, 4)


def stft_constants(size: int, col_window: tuple[int, int] | None,
                   device: torch.device) -> dict[str, torch.Tensor]:
    """The half-sine window, the column-windowed cos/sin DFT matrices in
    float32 and (for the kernel) their bf16 GEMM fragments
    (``dft_fragments``), on ``device``.

    A caller that runs the STFT repeatedly builds these once: computing
    them per call costs host time, and each host-to-device copy waits for
    the device to drain."""
    C, S = dft_matrices(size, col_window)
    cos, sin = torch.from_numpy(C), torch.from_numpy(S)
    return {"window": torch.from_numpy(half_sine_window(size)).to(device),
            "cos": cos.to(device), "sin": sin.to(device),
            "frag": dft_fragments(cos, sin).to(device)}


def stft_power_core(z: torch.Tensor, *, n_ffts: int = 348, size: int = 512,
                    hop: int = 128, impl: str = "fft",
                    col_window: tuple[int, int] | None = None,
                    consts: dict[str, torch.Tensor] | None = None
                    ) -> torch.Tensor:
    """(..., fl) complex64 -> (..., n_ffts, ncols) float32 power.

    impl "fft": torch.fft (f32). impl "matmul_bf16": frames and the cos/sin
    DFT matrices rounded to bf16, products accumulated in f32. impl
    "pallas": the fused kernel on a CUDA tensor, "matmul_bf16" on a CPU
    tensor. col_window=(lo, hi) keeps output columns [lo, hi) only; the
    matmul forms and the kernel compute only those. ``consts`` are
    stft_constants(size, col_window, z.device), built here if not given."""
    global PLAIN_CALLS
    if impl not in ("fft", "matmul_bf16", "pallas"):
        raise ValueError(f"stft impl {impl!r}")
    dev = z.device
    if consts is None:
        consts = stft_constants(size, col_window, dev)
    if impl == "pallas":
        if dev.type != "cpu":
            return stft_power_kernel(z, n_ffts=n_ffts, size=size, hop=hop,
                                     consts=consts)
        PLAIN_CALLS += 1
        impl = "matmul_bf16"
    w = consts["window"]
    zr, zi = z.real, z.imag
    if impl == "matmul_bf16" and size % hop == 0:
        # frame i = rows i..i+size/hop-1 of the (fl/hop, hop) reshape
        k = size // hop
        n_rows = n_ffts + k - 1
        pad_to = n_rows * hop
        fl = z.shape[-1]

        def frames_of(x):
            if pad_to > fl:
                x = torch.nn.functional.pad(x, (0, pad_to - fl))
            else:
                x = x[..., :pad_to]
            R = x.reshape(x.shape[:-1] + (n_rows, hop))
            return torch.cat([R[..., i:i + n_ffts, :] for i in range(k)],
                             dim=-1) * w
        fr, fi = frames_of(zr), frames_of(zi)
    else:
        starts = torch.arange(n_ffts, device=dev) * hop
        idx = starts[:, None] + torch.arange(size, device=dev)[None, :]
        fr, fi = zr[..., idx] * w, zi[..., idx] * w
    if impl == "matmul_bf16":
        Cb, Sb = consts["cos"], consts["sin"]
        re = bf16_matmul(fr, Cb) - bf16_matmul(fi, Sb)
        im = bf16_matmul(fr, Sb) + bf16_matmul(fi, Cb)
        return re * re + im * im
    spec = torch.fft.fft(torch.complex(fr, fi), dim=-1)
    spec = torch.fft.fftshift(spec, dim=-1)
    ps = (spec.real * spec.real + spec.imag * spec.imag).float()
    if col_window is not None:
        ps = ps[..., col_window[0]:col_window[1]]
    return ps


def stft_power_kernel(z: torch.Tensor, *, n_ffts: int, size: int, hop: int,
                      consts: dict[str, torch.Tensor]) -> torch.Tensor:
    """Launch csrc/stft_power.cu on a CUDA complex64 (..., fl) tensor ->
    (..., n_ffts, ncols) float32, ncols the width of consts' matrices."""
    global KERNEL_LAUNCHES
    if z.device.type != "cuda":
        raise ValueError(f"stft_power kernel: unsupported device {z.device}")
    if z.dtype != torch.complex64:
        raise ValueError(f"stft_power kernel takes complex64, got {z.dtype}")
    ncols = consts["cos"].shape[1]
    frag = consts["frag"]
    n_blocks, steps, nt = frag.shape[:3]
    if (steps * 8 != size or tuple(frag.shape[3:]) != (32, 4)
            or frag.dtype != torch.bfloat16 or nt != mma_tiles(ncols)):
        raise ValueError(f"DFT fragments {tuple(frag.shape)} do not match "
                         f"size {size}, {ncols} columns")
    lead = z.shape[:-1]
    fl = z.shape[-1]
    zi = torch.view_as_real(z.reshape(-1, fl).contiguous())   # (B, fl, 2)
    B = zi.shape[0]
    out = torch.empty((B, n_ffts, ncols), dtype=torch.float32,
                      device=z.device)
    window = consts["window"].contiguous()
    lib = cuda_build.load_library()
    code = lib.uwspr_stft_power(
        zi.data_ptr(), B, fl, n_ffts, size, hop, window.data_ptr(),
        frag.contiguous().data_ptr(), nt, n_blocks, ncols, out.data_ptr(),
        torch.cuda.current_stream(z.device).cuda_stream)
    cuda_build.check_launch("uwspr_stft_power", code)
    KERNEL_LAUNCHES += 1
    return out.reshape(lead + (n_ffts, ncols))


def stft_power(z: np.ndarray, *, n_ffts: int = 348, size: int = 512,
               hop: int = 128, device: str | torch.device,
               consts: dict[str, torch.Tensor] | None = None
               ) -> torch.Tensor:
    """Host entry (ops/stft.py:108-118): numpy complex samples -> the f32
    FFT power spectrum (..., n_ffts, size) on ``device``. ``consts`` are
    stft_constants(size, None, device), built here if not given."""
    z = np.asarray(z)
    zt = torch.complex(torch.from_numpy(z.real.astype(np.float32)),
                       torch.from_numpy(z.imag.astype(np.float32)))
    return stft_power_core(zt.to(resolve_device(device)), n_ffts=n_ffts,
                           size=size, hop=hop, impl="fft", consts=consts)


__all__ = ["KERNEL_LAUNCHES", "PLAIN_CALLS", "bf16_matmul", "dft_fragments",
           "dft_matrices", "half_sine_window", "mma_tiles", "reset_counters",
           "stft_constants", "stft_power", "stft_power_core",
           "stft_power_kernel"]
