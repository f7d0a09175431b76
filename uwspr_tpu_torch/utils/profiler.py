"""torch.profiler integration: a TensorBoard-loadable trace of a run, and
the port's host spans inside it.

Counterpart of uwspr_tpu/utils/profiler.py. On a CUDA device the trace
records the card's activity beside the host's (CUPTI), so the port's own
kernels (``select_best_kernel``, ``fano_kernel``, ...) appear by name:

    from uwspr_tpu_torch.utils.profiler import trace
    with trace("/tmp/uwspr-trace", device="cuda"):
        decoder.decode_windows_ri(ri)

or from the CLI: ``uwspr-torch decode file.c2 --trace-dir /tmp/uwspr-trace``.

``span(name, request)`` is a host range named ``uwspr.<name>`` at a layer
boundary of the serving path (``RingServe.push``, ``DeviceRingDecoder.
push_hop``, ``DeviceDecoder``'s submit, fetch and spots, the captured
program's load, replay and capture). A span is a profiler range
(``RecordFunction``) on kineto's host clock, beside the card's events, so
any profiler trace holds it, the benchmark's in-memory one included. It
is an operator's range (``_RecordFunctionFast``, the scope of an aten op)
and not a user annotation (``record_function``): kineto copies a user
annotation onto the device timeline over every kernel launched inside
it, which a reader of device events would count as a kernel. Its one
input is the request's number where the call knows it (the ring's hop,
the decoder's batch), which a trace keeps with ``record_shapes`` (``trace``
sets it: the ``Concrete Inputs`` of the range); ``record_function``'s
string argument is kept by no trace. Inside a replay the stages are
device kernels, ``ops/marks.py``'s markers. With no profiler running a
span is one shared no-op context and builds no range.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler

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
    with profile(activities=activities, record_shapes=True,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


_NO_SPAN = contextlib.nullcontext()


def span(name: str, request: int | None = None):
    """The host range ``uwspr.<name>`` while a profiler runs, with the
    request's number as its input where given; else the shared no-op
    context (no range is built)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if request is None:
        return torch._C._profiler._RecordFunctionFast(f"uwspr.{name}")
    return torch._C._profiler._RecordFunctionFast(f"uwspr.{name}",
                                                  (int(request),))


__all__ = ["span", "trace"]
