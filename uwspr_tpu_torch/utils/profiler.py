"""torch.profiler integration: a TensorBoard-loadable trace of a run.

Counterpart of uwspr_tpu/utils/profiler.py. On a CUDA device the trace
records the card's activity beside the host's (CUPTI), so the port's own
kernels (``select_best_kernel``, ``fano_kernel``, ...) appear by name:

    from uwspr_tpu_torch.utils.profiler import trace
    with trace("/tmp/uwspr-trace", device="cuda"):
        decoder.decode_windows_ri(ri)

or from the CLI: ``uwspr-torch decode file.c2 --trace-dir /tmp/uwspr-trace``.
"""

from __future__ import annotations

import contextlib

import torch

from uwspr_tpu_torch.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str | None, *, device: str | torch.device):
    """Profile the enclosed block into ``log_dir`` (no-op if None), with
    the card's activity when ``device`` is CUDA."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def annotate(name: str):
    """Named sub-span inside a trace (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


__all__ = ["trace", "annotate"]
