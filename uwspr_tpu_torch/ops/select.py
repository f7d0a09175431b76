"""Exact order-dependent drift-model selection: CUDA kernel + plain version.

Replaces uwspr_tpu/ops/select_pallas.py::select_best_pallas. The semantics
are the reference's sequential walk (lib/FDR_impl.cc:344-405) over each
lane's (freq, lag, model) grid in order, with best starting at -1e30:

- a linear model accepts when ``v > best``;
- a nonlinear model accepts when ``v / best > threshold`` (f32 division);
- NaN never accepts.

``select_best`` is the entry point. For a CUDA tensor it launches
``csrc/select_best.cu`` (one block per lane, every lane in one launch:
four warps read the per-group extremes at the HBM rate while a fifth
follows them with the ballot walk, whose nonlinear
test is division-free, see ``threshold_midpoint``) and counts the launch
in ``KERNEL_LAUNCHES``; the model bank may be in any order and is read as
bytes, so a bool bank costs no conversion. For a CPU tensor it runs
``select_best_plain``, a transcription of the event-skip loop
``_select_best_grouped`` (uwspr_tpu/coarse/search.py:483-583), and counts
the call in ``PLAIN_CALLS``. Both are bit-exact with the literal scan.
"""

from __future__ import annotations

import numpy as np
import torch

from uwspr_tpu_torch.utils import cuda_build

# launches of the CUDA kernel onto a stream (a CUDA graph's capture only
# records one, and its replays are seen only in a trace of the card) /
# calls of the plain version, in this process
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

MAX_MODELS = 128       # the kernel holds 4 chunks of 32 models
MAX_GROUPS = 3072      # its per-group table fits 48 KB of shared memory


def reset_counters() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


def _check(sync: torch.Tensor, is_nonlinear: torch.Tensor) -> None:
    if sync.dtype != torch.float32 or sync.dim() != 4:
        raise ValueError(f"sync must be (L, 5, lags, M) float32, got "
                         f"{tuple(sync.shape)} {sync.dtype}")
    if is_nonlinear.shape != (sync.shape[3],):
        raise ValueError(f"is_nonlinear {tuple(is_nonlinear.shape)} does not "
                         f"match M={sync.shape[3]}")
    if is_nonlinear.device != sync.device:
        raise ValueError("sync and is_nonlinear lie on different devices")


def select_best(sync: torch.Tensor, is_nonlinear: torch.Tensor, *,
                threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, 5, lags, M) f32 scores in evaluation order ->
    (best (L,) f32, flat index (L,) int32 into (5, lags, M))."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    _check(sync, is_nonlinear)
    if sync.device.type == "cpu":
        PLAIN_CALLS += 1
        return select_best_plain(sync, is_nonlinear, threshold=threshold)
    if sync.device.type != "cuda":
        raise ValueError(f"select_best: unsupported device {sync.device}")
    mid, tie_up = threshold_midpoint(threshold)
    L, _, _, M = sync.shape
    G = sync.shape[1] * sync.shape[2]
    if M > MAX_MODELS or G > MAX_GROUPS:
        raise ValueError(f"select_best: the kernel takes at most "
                         f"{MAX_MODELS} models and {MAX_GROUPS} groups, got "
                         f"{M} and {G}")
    grid = sync.contiguous()
    nl = is_nonlinear
    if nl.dtype not in (torch.bool, torch.uint8):
        nl = nl != 0
    nl = nl.contiguous()
    best = torch.empty(L, dtype=torch.float32, device=sync.device)
    idx = torch.empty(L, dtype=torch.int32, device=sync.device)
    lib = cuda_build.load_library()
    code = lib.uwspr_select_best(
        grid.data_ptr(), nl.data_ptr(), L, G, M, mid, int(tie_up),
        best.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(sync.device).cuda_stream)
    cuda_build.check_launch("uwspr_select_best", code)
    if not torch.cuda.is_current_stream_capturing():
        KERNEL_LAUNCHES += 1    # a capture only records it
    return best, idx


def threshold_midpoint(threshold: float) -> tuple[float, bool]:
    """(mid, tie_up) of a finite f32 threshold T: mid is the midpoint
    between T and the next float above it (exact in double) and tie_up
    says that a quotient of exactly mid rounds up, above T (T's bit pattern
    is odd; -0 counts as +0). fl(x) > T iff x > mid, or x == mid and
    tie_up: the kernel's division-free nonlinear test."""
    t = np.float32(threshold)
    if not np.isfinite(t):
        raise ValueError(f"select_best: threshold {threshold} must be a "
                         f"finite float32")
    if t == 0:
        t = np.float32(0.0)
    with np.errstate(over="ignore"):
        up = np.nextafter(t, np.float32(np.inf), dtype=np.float32)
    if np.isinf(up):                       # T = FLT_MAX: half its ulp
        mid = float(t) + 2.0 ** 103
    else:
        mid = (float(t) + float(up)) / 2
    return mid, bool(int(t.view(np.int32)) & 1)


def select_best_plain(sync: torch.Tensor, is_nonlinear: torch.Tensor, *,
                      threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Event-skip selection with closed-form group resolution, transcribed
    from _select_best_grouped (search.py:483-583). Requires a linear-first
    model bank, which build_drift_models always produces.

    Every visited group is resolved in one round: the linear segment's last
    accept is its max at its first occurrence; the nonlinear segment takes
    up to three chained accepts and revisits the group past the chain if a
    fourth could follow. Jumps go to the first later group whose linear
    max, or nonlinear max or min, can accept (NaN excluded)."""
    nl_flags = is_nonlinear.bool()
    if bool((nl_flags[1:].int() < nl_flags[:-1].int()).any()):
        raise ValueError("select_best_plain needs a linear-first model bank")
    dev = sync.device
    C = sync.shape[0]
    Mdim = sync.shape[3]
    g3 = sync.reshape(C, -1, Mdim)                         # (C, G, M)
    G = g3.shape[1]
    is_nl = nl_flags[None, :]                              # (1, M)
    nan = torch.isnan(g3)
    ninf = torch.tensor(float("-inf"), device=dev)
    pinf = torch.tensor(float("inf"), device=dev)
    lin_max = torch.where(is_nl[:, None] | nan, ninf, g3).amax(dim=2)
    nl_max = torch.where(~is_nl[:, None] | nan, ninf, g3).amax(dim=2)
    nl_min = torch.where(~is_nl[:, None] | nan, pinf, g3).amin(dim=2)
    any_nl = bool(nl_flags.any())
    g_idx = torch.arange(G, dtype=torch.int32, device=dev)[None, :]
    midx = torch.arange(Mdim, dtype=torch.int32, device=dev)[None, :]
    cidx = torch.arange(C, device=dev)
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)

    def first_true(mask):                                  # (C, N) -> (C,)
        return torch.argmax(mask.to(torch.int32), dim=1).to(torch.int32)

    best = torch.full((C,), -1e30, dtype=torch.float32, device=dev)
    bidx = torch.zeros(C, dtype=torch.int32, device=dev)
    g_cur = torch.zeros(C, dtype=torch.int32, device=dev)
    off = torch.zeros(C, dtype=torch.int32, device=dev)
    act = torch.ones(C, dtype=torch.bool, device=dev)
    while bool(act.any()):
        row = g3[cidx, g_cur.long()]                       # (C, M)
        bad = torch.isnan(row)
        linvals = torch.where(is_nl | bad | (midx < off[:, None]), ninf, row)
        lmax = linvals.amax(dim=1)
        lidx = torch.argmax(linvals, dim=1).to(torch.int32)
        accL = act & (lmax > best)
        best = torch.where(accL, lmax, best)
        bidx = torch.where(accL, g_cur * Mdim + lidx, bidx)
        prev = off - 1
        for _ in range(3):
            ok = (is_nl & (row / best[:, None] > thr)
                  & (midx > prev[:, None]) & act[:, None])
            has = ok.any(dim=1)
            c = first_true(ok)
            v = row[cidx, c.long()]
            best = torch.where(has, v, best)
            bidx = torch.where(has, g_cur * Mdim + c, bidx)
            prev = torch.where(has, c, Mdim)
        resid = (is_nl & (row / best[:, None] > thr)
                 & (midx > prev[:, None]) & act[:, None]).any(dim=1)
        rl = lin_max > best[:, None]
        rn = (((nl_max / best[:, None]) > thr)
              | ((nl_min / best[:, None]) > thr)) & any_nl
        gmask = (rl | rn) & (g_idx > g_cur[:, None])
        has_g = gmask.any(dim=1)
        g_next = first_true(gmask)
        off = torch.where(resid, prev + 1, 0).to(torch.int32)
        g_cur = torch.where(act & ~resid & has_g, g_next, g_cur)
        act = act & (resid | has_g)
    return best, bidx


__all__ = ["KERNEL_LAUNCHES", "MAX_GROUPS", "MAX_MODELS", "PLAIN_CALLS",
           "reset_counters", "select_best", "select_best_plain",
           "threshold_midpoint"]
