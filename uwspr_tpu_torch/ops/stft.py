"""Batched STFT power spectrum for the coarse search (torch).

Counterpart of uwspr_tpu/ops/stft.py::stft_power_core: 348 half-sine
windowed 512-point transforms stepped by half symbols, DC at column
``size/2`` (lib/FDR_impl.cc:222-254), batched over leading dims.

The DFT product of ``impl="matmul_bf16"`` is a plain matrix product, as the
JAX package leaves it to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def _half_sine_window(size: int) -> np.ndarray:
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


def stft_constants(size: int, col_window: tuple[int, int] | None,
                   device: torch.device) -> dict[str, torch.Tensor]:
    """The half-sine window and the cos/sin DFT matrices on ``device``.

    A caller that runs the STFT repeatedly builds these once: computing
    them per call costs host time, and each host-to-device copy waits for
    the device to drain."""
    C, S = dft_matrices(size, col_window)
    return {"window": torch.from_numpy(_half_sine_window(size)).to(device),
            "cos": torch.from_numpy(C).to(device),
            "sin": torch.from_numpy(S).to(device)}


def stft_power_core(z: torch.Tensor, *, n_ffts: int = 348, size: int = 512,
                    hop: int = 128, impl: str = "fft",
                    col_window: tuple[int, int] | None = None,
                    consts: dict[str, torch.Tensor] | None = None
                    ) -> torch.Tensor:
    """(..., fl) complex64 -> (..., n_ffts, ncols) float32 power.

    impl "fft": torch.fft (f32). impl "matmul_bf16": frames and the cos/sin
    DFT matrices rounded to bf16, products accumulated in f32.
    col_window=(lo, hi) keeps output columns [lo, hi) only. ``consts`` are
    stft_constants(size, col_window, z.device), built here if not given."""
    if impl not in ("fft", "matmul_bf16"):
        raise NotImplementedError(
            f"stft impl {impl!r} is not ported (use 'fft' or 'matmul_bf16')")
    dev = z.device
    if consts is None:
        consts = stft_constants(size, col_window, dev)
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


__all__ = ["bf16_matmul", "dft_matrices", "stft_constants", "stft_power_core"]
