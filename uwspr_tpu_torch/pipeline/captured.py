"""Captured programs: a function of one fixed-shape CUDA tensor, run as a
CUDA graph replay.

Counterpart of ``jax.jit`` where the JAX package compiles its device
engine: ``self.decode_windows_ri = jax.jit(self._decode_windows_batched)``
and the per-window program (uwspr_tpu/pipeline/jit_decoder.py:156-176),
and the ring's one program per hop (uwspr_tpu/pipeline/device_ring.py:
94-118). XLA compiles each of them once per input shape and then
dispatches one executable; PyTorch runs eagerly, about a thousand kernel
launches a decode. ``CapturedProgram`` keeps one ``torch.cuda.CUDAGraph``
per input shape and replays it:

- the first call of a shape runs the function once eagerly on the
  program's side stream (the warm-up: the kernel library's load, each
  kernel's one-time ``cudaFuncSetAttribute``, cuFFT plans, cuBLAS and
  cuDNN handles and workspaces all happen here, outside the capture), then
  captures it under ``torch.cuda.graph`` and returns the warm-up's result.
  This call waits on the host (``torch.cuda.graph`` synchronises the
  device before it captures), as ``jax.jit``'s first call compiles;
- every later call copies its input into the graph's static input (a
  host input from pinned memory, without blocking; a device input on the
  current stream), replays the graph on the current stream and returns a
  fresh clone of the static output, so that a handle already returned is
  never overwritten by a later replay and a caller may keep several in
  flight. Nothing waits on the host.

Memory: the graphs of one program share the program's graph pool, and
the pool lives as long as the program (its decoder). A pool keeps every
segment it has taken while a graph holds it, and a larger graph cannot
reuse a smaller one's segments, so a pool shared wider would hold, for
as long as its longest-lived program, what every program that shared it
once needed: on an H100 one pool a card grew to 54 GiB over
chip_smoke.py's phases, and one pool a shape kept an uncompacted
decoder's 8.5 GiB under the serving decoder's W = 128 graph, and both ran
out of memory. The static inputs lie outside the pools. No reference
cycle holds a decoder, so a dropped decoder's graphs go at once, and a
capture first returns the allocator's unused blocks to the card
(``torch.cuda.empty_cache``): the warm-up's, and the pools of dropped
programs. The collector is off during a capture: a collection then
could destroy another graph, which CUDA refuses while a stream
captures. A graph does not outlive its process (JAX's persistent
compile cache has no counterpart here).

Kernel launches: the wrappers count the launches they make onto a stream
(``KERNEL_LAUNCHES``); a capture only records a launch into its graph,
and a replay runs no Python. So a program reads each captured graph's
kernel nodes from the graph itself (CUDA's DOT print of the
``cudaGraph_t``, one node a launch, named by its mangled symbol), and
every replay adds that graph's kernel nodes to ``REPLAY_LAUNCHES``: what
a replay launches is what its graph holds.

Tracing: while a profiler runs, a call's input copy, replay and first-call
capture are the host spans ``uwspr.captured.load``, ``.replay`` and
``.capture`` (utils/profiler.py).

``eager()`` is the counterpart of ``jax.disable_jit``: under it a program
runs its function eagerly and captures nothing. Code that must see each
call's Python (a recorder that copies a kernel's inputs to the host, an
operation counter, a stage split with CUDA events, a test) enters it; the
serving path never does. A failed capture or replay raises: nothing falls
back to eager launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import pathlib
import re
import tempfile
import time
import weakref
from dataclasses import dataclass

import torch

from uwspr_tpu_torch.coarse import search
from uwspr_tpu_torch.demod import finesync
from uwspr_tpu_torch.device import to_device
from uwspr_tpu_torch.fec import fano, osd_torch
from uwspr_tpu_torch.ops import probe, select, stft, subtract
from uwspr_tpu_torch.utils.profiler import span

# the kernel wrappers, by the name their launches are reported under
COUNTED = (("select_best", select), ("fano_decode", fano),
           ("probe_powers", probe), ("stft_power", stft),
           ("osd_decode", osd_torch), ("sync_grid", search),
           ("probe_lanes", finesync), ("subtract_lanes", subtract))

# each wrapper's kernel, by the symbol its mangled name holds
KERNEL_SYMBOLS = {"select_best": "select_best_kernel",
                  "fano_decode": "fano_kernel",
                  "probe_powers": "probe_powers_kernel",
                  "stft_power": "stft_power_mma",
                  "osd_decode": "osd_kernel",
                  "sync_grid": "sync_grid_kernel",
                  "probe_lanes": "probe_lanes_kernel",
                  "subtract_lanes": "subtract_lanes_kernel"}
# the kernel launches of every replay in this process, by kernel
REPLAY_LAUNCHES = dict.fromkeys(KERNEL_SYMBOLS, 0)

_EAGER = False
# the live programs, for the MiB of their pools
_PROGRAMS = weakref.WeakSet()


def eager_active() -> bool:
    """Whether calls run inside ``eager()``."""
    return _EAGER


@contextlib.contextmanager
def eager():
    """Programs run their functions eagerly and capture nothing
    (``jax.disable_jit``). Nests; the previous state comes back on exit,
    also after an exception."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


def pool_mib(index: int) -> float:
    """The MiB of the graph pools of the live programs on device
    ``index``."""
    return sum(p.pool_mib for p in _PROGRAMS if p.index == index)


def reset_replay_launches() -> None:
    for k in REPLAY_LAUNCHES:
        REPLAY_LAUNCHES[k] = 0


def kernel_counts(names) -> dict[str, int]:
    """The launches by kernel among kernel names (mangled or not); other
    kernels are not counted."""
    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for name in names:
        for k, sym in KERNEL_SYMBOLS.items():
            if sym in name:
                counts[k] += 1
    return counts


def dot_kernels(dot: str) -> dict[str, int]:
    """The kernel nodes by kernel of a graph's DOT print, where a kernel
    node's label holds its kernel's mangled name."""
    return kernel_counts(re.findall(r'label="([^"]*)"', dot))


def graph_kernels(graph: torch.cuda.CUDAGraph) -> dict[str, int]:
    """The kernel nodes of a captured graph (kept: ``keep_graph=True``),
    by kernel, from CUDA's DOT print of it."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "graph.dot"
        code = libcuda.cuGraphDebugDotPrint(
            ctypes.c_void_p(graph.raw_cuda_graph()), str(path).encode(),
            ctypes.c_uint(0))
        if code != 0:
            raise RuntimeError(f"cuGraphDebugDotPrint returned {code}")
        return dot_kernels(path.read_text())


def _load(static: torch.Tensor, x: torch.Tensor) -> None:
    """x into the static input: a host tensor from pinned memory without
    blocking (``device.to_device``'s rule), a device tensor on the current
    stream."""
    if x.device.type == "cpu":
        x = x.pin_memory()
    static.copy_(x, non_blocking=True)


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: dict[str, int]


class CapturedProgram:
    """A cache of CUDA graphs of ``fn``, keyed by input shape (see the
    module doc). ``fn`` is a bound method (of the object that holds the
    program, held weakly: no reference cycle) of one tensor on ``device``
    that returns one tensor; ``program(x)`` runs it on ``x``.

    ``captures`` holds, by input shape, the first call's warm-up and
    capture seconds, the MiB the capture added to the program's graph
    pool, the pool's MiB after it and the graph's kernel nodes by kernel
    (``launches``, what each replay launches)."""

    def __init__(self, device: torch.device, fn):
        if device.type != "cuda":
            raise ValueError(f"a captured program runs on a CUDA device, "
                             f"not {device}")
        self.device = device
        self._fn = weakref.WeakMethod(fn)
        self.captures: dict[tuple, dict] = {}
        self._graphs: dict[tuple, _Graph] = {}
        self._stream = None
        self._pool = None
        self.index = None        # the device's index, at the first capture
        self.pool_mib = 0.0
        _PROGRAMS.add(self)

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        if _EAGER:
            return self._fn()(to_device(x, self.device))
        g = self._graphs.get(tuple(x.shape))
        if g is None:
            with span("captured.capture"):
                return self._capture(x)
        with span("captured.load"):
            _load(g.static_in, x)
        with span("captured.replay"):
            g.graph.replay()
            for k, n in g.launches.items():
                REPLAY_LAUNCHES[k] += n
        return g.static_out.clone()

    def _capture(self, x: torch.Tensor) -> torch.Tensor:
        fn, dev = self._fn(), self.device
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        t0 = time.perf_counter()
        # outside the pool: the static input outlives every capture
        static_in = torch.empty(x.shape, dtype=x.dtype, device=dev)
        _load(static_in, x)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side, main = self._stream, torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(static_in)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        if self._pool is None:
            self.index, self._pool = index, torch.cuda.graph_pool_handle()
        # kept until its kernel nodes are read, then instantiated
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # no collection during the capture: a collected program's graph
        # would be destroyed, which CUDA refuses while a stream
        # captures, and this capture would be invalidated
        collecting = gc.isenabled()
        gc.disable()
        try:
            # capture_error_mode "global" (the default) holds: the NCCL
            # watchdog's event queries do not trip it (the mesh's decode)
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                static_out = fn(static_in)
        finally:
            if collecting:
                gc.enable()
        launches = graph_kernels(graph)
        graph.instantiate()
        main.wait_stream(side)
        out.record_stream(main)
        key = tuple(x.shape)
        self._graphs[key] = _Graph(graph, static_in, static_out,
                                   {k: n for k, n in launches.items() if n})
        grew = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
        self.pool_mib += grew
        self.captures[key] = {
            "warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1,
            "pool_mib": grew, "pool_total_mib": self.pool_mib,
            "launches": launches}
        return out


__all__ = ["COUNTED", "CapturedProgram", "KERNEL_SYMBOLS", "REPLAY_LAUNCHES",
           "dot_kernels", "eager", "eager_active", "graph_kernels",
           "kernel_counts", "pool_mib", "reset_replay_launches"]
