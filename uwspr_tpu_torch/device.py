"""Explicit device handling: the caller names the device, nothing falls back."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must really be present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev


@contextlib.contextmanager
def exact_f32():
    """Full float32 products on the card: no TF32 in cuBLAS or cuDNN.

    The coarse grid feeds a strict ``v > best`` selection that resolves
    single-ulp ties, and the bf16 emulation (bf16 operands upcast, f32
    products) is exact only without TF32. cuBLAS defaults to full f32
    (``torch.backends.cuda.matmul.allow_tf32`` False) but cuDNN convolutions
    default to TF32; both are pinned off here and restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


__all__ = ["exact_f32", "resolve_device"]
