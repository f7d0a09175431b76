"""The device multipass subtraction: CUDA kernel + its CPU twin.

Not a TPU kernel: the JAX package subtracts a decoded frame on the host in
numpy (uwspr_tpu/pipeline/multipass.py), one window at a time between
single-window decodes. The port's ``pipeline/multipass.py::subtract_spot``
is that code; ``subtract_lanes`` is its semantics for every decoded frame
of a batch at once, in place, inside the device engine's batch program
(``DeviceDecoder``, ``MultipassConfig.passes`` > 1):

- for a CUDA tensor one launch of ``csrc/subtract_lanes.cu`` (a block a
  window, the window's lanes in lane order, float64 arithmetic), counted
  in ``KERNEL_LAUNCHES``;
- for a CPU tensor the kernel's twin, ``csrc/subtract_lanes_host.cc``
  built by g++ with ``csrc/subtract_lane.cuh`` (the lane arithmetic both
  share), counted in ``PLAIN_CALLS``.

Each lane is a decoded spot: its window, its 7-byte payload, its refined
frequency, the lag of its first sample (shift plus the decoding jiggle's
offset, ``multipass.spot_lag``), its drift model (mode, linear drift, SLM
parameters). Lanes with ``active`` unset are skipped; a window's active
lanes are subtracted in lane order, each fitted against the residual of
the ones before it, as ``multipass_spots`` subtracts a window's spots.
"""

from __future__ import annotations

import ctypes
import os
import pathlib

import torch

from uwspr_tpu_torch.utils import cuda_build
from uwspr_tpu_torch.utils.gxx_build import load_gxx_library

# launches of the CUDA kernel onto a stream (a capture only records one) /
# calls of the twin, in this process
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

FRAME = 162 * 256
HEADER = cuda_build.CSRC_DIR / "subtract_lane.cuh"
HOST_SOURCE = cuda_build.CSRC_DIR / "subtract_lanes_host.cc"


def reset_counters() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


def twin_source() -> pathlib.Path:
    """The twin's one-file source in the build directory: the header's
    text, then the host driver's (whose include of the header it
    replaces), so that an edit of either rebuilds it."""
    text = (HEADER.read_text() + "\n"
            + HOST_SOURCE.read_text().replace(
                '#include "subtract_lane.cuh"', ""))
    out = cuda_build.BUILD_DIR / "subtract_lanes_twin.cc"
    if not out.exists() or out.read_text() != text:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(text)
        tmp.replace(out)
    return out


def _configure(lib) -> None:
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.uwspr_subtract_lanes_host.argtypes = [
        vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, cd, ci, ci, ci, vp,
        vp]
    lib.uwspr_subtract_lanes_host.restype = ci


def load_twin() -> ctypes.CDLL:
    return load_gxx_library(twin_source(), _configure)


def subtract_lanes(ri: torch.Tensor, widx: torch.Tensor, active: torch.Tensor,
                   payload: torch.Tensor, freq: torch.Tensor,
                   lag: torch.Tensor, mode: torch.Tensor, drift: torch.Tensor,
                   slm: torch.Tensor, *, cf: float, nfilt: int = 5,
                   freq_iters: int = 3, lag_search: int = 16
                   ) -> torch.Tensor:
    """Subtract every active lane's fitted frame from ``ri`` in place.

    ri: (W, 2, N) float32, contiguous; widx, lag, mode: (L,) integers;
    active: (L,) bool; payload: (L, 7) uint8; freq, drift: (L,) float32;
    slm: (L, 4) float32, all on ri's device. Returns (L, 4) float64, for
    each active lane (zeros for the others): the lag after the first
    polish, the final lag and frequency, and the frequency polishes that
    moved it. Queues the work on the current stream; nothing waits."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    if (ri.dim() != 3 or ri.shape[1] != 2 or ri.dtype != torch.float32
            or not ri.is_contiguous()):
        raise ValueError(f"ri must be a contiguous (W, 2, N) float32 "
                         f"tensor, got {tuple(ri.shape)} {ri.dtype}")
    L = widx.shape[0]
    if payload.shape != (L, 7) or slm.shape != (L, 4):
        raise ValueError("payload must be (L, 7) and slm (L, 4)")
    dev = ri.device
    W, _, N = ri.shape
    i64 = [t.to(device=dev, dtype=torch.int64).contiguous()
           for t in (widx, lag, mode)]
    f32 = [t.to(device=dev, dtype=torch.float32).contiguous()
           for t in (freq, drift, slm)]
    act = active.to(device=dev, dtype=torch.uint8).contiguous()
    pay = payload.to(device=dev, dtype=torch.uint8).contiguous()
    scratch = torch.empty((W, 2, FRAME), dtype=torch.float32, device=dev)
    info = torch.zeros((L, 4), dtype=torch.float64, device=dev)
    args = (ri.data_ptr(), W, N, L, i64[0].data_ptr(), act.data_ptr(),
            pay.data_ptr(), f32[0].data_ptr(), i64[1].data_ptr(),
            i64[2].data_ptr(), f32[1].data_ptr(), f32[2].data_ptr(),
            float(cf), int(nfilt), int(freq_iters), int(lag_search),
            scratch.data_ptr(), info.data_ptr())
    if dev.type == "cpu":
        PLAIN_CALLS += 1
        code = load_twin().uwspr_subtract_lanes_host(*args)
        if code != 0:
            raise ValueError("subtract_lanes: the twin refused its "
                             "arguments")
        return info
    if dev.type != "cuda":
        raise ValueError(f"subtract_lanes: unsupported device {dev}")
    lib = cuda_build.load_library()
    code = lib.uwspr_subtract_lanes(
        *args, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("uwspr_subtract_lanes", code)
    if not torch.cuda.is_current_stream_capturing():
        KERNEL_LAUNCHES += 1    # a capture only records it
    return info


__all__ = ["FRAME", "KERNEL_LAUNCHES", "PLAIN_CALLS",
           "reset_counters", "subtract_lanes", "load_twin"]
