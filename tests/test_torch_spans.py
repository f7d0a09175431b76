"""The port's host spans (utils/profiler.py::span) and the stage markers of
its device decode (ops/marks.py, csrc/marks.cu), on the CPU.

- Under a CPU ``torch.profiler`` (``record_shapes``, which keeps a span's
  request number as its input): a ``DeviceDecoder`` batch (submit, a
  program's capture, load and replay, fetch, spots) and a decoding
  ``RingServe.push`` give the spans of their layer boundaries, each inside
  the span that called it, and the spans of one request carry one number:
  the decoder's batch, the ring's hop.
- Without a profiler ``span`` is the one shared no-op context and builds
  no range.
- A recording hook on ``marks.mark`` sees ``STAGES`` in order, each once
  a batch, on the compacted, uncompacted (refine_max_lanes), wideband,
  one-jiggle, ``osd_depth`` 4 and hybrid paths: ``fano2`` only where
  J > 1, ``osd`` only with the device OSD, no Fano stage in the hybrid,
  ``subtract`` on none of these single-pass paths (a multipass decode's
  markers are tests/test_torch_subtract_lanes.py's).
- ``marks.mark`` launches nothing for a CPU tensor; the C entry point's
  stages follow ``STAGES``.

A card's trace of a replay (each marker once, in ``STAGES`` order, the
replay bitwise equal to its eager run) is ``chip_smoke.py``'s phase 20.
"""

import dataclasses as dc
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig,
                                    PipelineConfig, with_serving_defaults)
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.ops import marks
from uwspr_tpu_torch.pipeline import captured
from uwspr_tpu_torch.pipeline.captured import CapturedProgram
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.pipeline.device_ring import RingServe
from uwspr_tpu_torch.protocol.modulate import synthesize_frame
from uwspr_tpu_torch.utils import cuda_build, profiler

TOY = DemodConfig(n_jiggles=3, maxcycles=4)
SERVING = with_serving_defaults(PipelineConfig(demod=TOY), 2)


def frame_windows(n, seed=0):
    """n (2, 45000) windows, each one "VE3EMB FN25 30" frame at -18 dB."""
    rng = np.random.default_rng(seed)
    z = np.stack([awgn(synthesize_frame(
        "VE3EMB", "FN25", 30, start_sample=int(rng.integers(0, 2000)),
        freq_offset=float(rng.uniform(-5, 5))), -18, rng=rng)
        for _ in range(n)])
    return np.stack([z.real, z.imag], axis=1).astype(np.float32)


def uwspr_spans(prof):
    """[(name, start ns, end ns, request or None, parent name or None)] of
    the trace's ``uwspr.`` ranges; a parent is the innermost ``uwspr.``
    range that holds the span. No span is a user annotation, which a
    device trace would copy onto the device timeline."""
    evs = [(e.name(), int(e.start_ns()), int(e.end_ns()),
            list(e.concrete_inputs()))
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("uwspr.")]
    assert not any(e.is_user_annotation()
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("uwspr."))
    out = []
    for i, (name, s, t, inputs) in enumerate(evs):
        holders = [o for j, o in enumerate(evs)
                   if j != i and o[1] <= s and t <= o[2]]
        parent = min(holders, key=lambda o: o[2] - o[1])[0] if holders \
            else None
        out.append((name[len("uwspr."):], s, t,
                    inputs[0] if inputs else None,
                    parent[len("uwspr."):] if parent else None))
    return sorted(out, key=lambda x: x[1])


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
    return uwspr_spans(p)


class FakeGraph:
    """A graph stand-in on the CPU: a replay runs the function on the
    static input into the static output."""

    def __init__(self, fn, static_in, static_out):
        self.fn, self.static_in, self.static_out = fn, static_in, static_out

    def replay(self):
        self.static_out.copy_(self.fn(self.static_in))


def cpu_program(dec, monkeypatch):
    """A CapturedProgram on ``dec`` whose capture and input copy run on the
    CPU (a first call runs the function and keeps a FakeGraph)."""
    prog = CapturedProgram(torch.device("cuda"), dec._decode)

    def capture(x):
        static_in = x.clone()
        out = dec._decode(static_in)
        prog._graphs[tuple(x.shape)] = captured._Graph(
            FakeGraph(dec._decode, static_in, out.clone()), static_in,
            out.clone(), {})
        return out
    monkeypatch.setattr(prog, "_capture", capture)
    monkeypatch.setattr(captured, "_load", lambda static, x: static.copy_(x))
    return prog


def test_without_a_profiler_a_span_is_the_shared_noop(monkeypatch):
    def no_range(*a):
        raise AssertionError("a range was built with no profiler running")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    a, b = profiler.span("ring.push", 3), profiler.span("decoder.spots")
    assert a is b is profiler._NO_SPAN
    with a, b:
        pass


def test_decoder_batch_spans(monkeypatch):
    ri = frame_windows(1)
    dec = DeviceDecoder(SERVING, device="cpu")
    dec.program = cpu_program(dec, monkeypatch)
    hold = {}

    def batches():
        hold["first"] = dec.decode_windows_ri(ri)        # captures
        hold["h"] = h = dec.decode_windows_ri(ri)        # replays
        out = dec.fetch(h)
        hold["spots"] = dec.spots(out.window(0))
    spans = traced(batches)
    assert hold["first"].uwspr_request == 0 and hold["h"].uwspr_request == 1
    assert torch.equal(hold["h"], hold["first"])
    assert [s.message for s in hold["spots"]] == ["VE3EMB FN25 30"]
    assert [(name, req, parent) for name, _, _, req, parent in spans] == [
        ("decoder.submit", 0, None),
        ("captured.capture", None, "decoder.submit"),
        ("decoder.submit", 1, None),
        ("captured.load", None, "decoder.submit"),
        ("captured.replay", None, "decoder.submit"),
        ("decoder.fetch", 1, None),
        ("decoder.spots", None, None)]


def test_ring_push_spans():
    cfg = PipelineConfig(demod=TOY)
    serve = RingServe(cfg, n_channels=2, device="cpu")
    ring = serve.ring
    hop, fl = ring.hop, ring.fl
    rng = np.random.default_rng(1)
    n = -(-fl // hop)
    stream = (rng.standard_normal((2, (n + 1) * hop))
              + 1j * rng.standard_normal((2, (n + 1) * hop))).astype(
                  np.complex64)
    for k in range(n - 1):
        assert serve.push(stream[:, k * hop:(k + 1) * hop]) == []
    assert ring.next_hop() == 0 and ring.hops == 0
    res = {}
    for k in (n - 1, n):
        spans = traced(lambda: res.setdefault(k, serve.push(
            stream[:, k * hop:(k + 1) * hop])))
        h = k - (n - 1)                        # the hop's number
        assert len(res[k]) == 2 and ring.hops == h + 1
        got = [(name, req, parent) for name, _, _, req, parent in spans]
        assert got == [
            ("ring.push", h, None),
            ("ring.buffer", None, "ring.push"),
            ("ring.buffer", None, "ring.push"),
            ("ring.push_hop", h, "ring.push"),
            ("decoder.submit", h, "ring.push_hop"),
            ("decoder.fetch", h, "ring.push"),
            ("ring.results", h, "ring.push"),
            ("decoder.spots", None, "ring.results"),
            ("decoder.spots", None, "ring.results")]


def one_jiggle(cfg):
    return dc.replace(cfg, demod=dc.replace(cfg.demod, n_jiggles=1))


ALL = [s for s in marks.STAGES if s not in ("osd", "subtract")]
PATHS = {
    "compacted": (SERVING, "device", ALL),
    "refine_max_lanes": (PipelineConfig(demod=dc.replace(
        TOY, refine_max_lanes=4)), "device", ALL),
    "wideband": (with_serving_defaults(PipelineConfig(
        coarse=CoarseConfig(halfbandwidth=187, maxfreqs=200), demod=TOY), 2),
        "device", ALL),
    "one jiggle": (one_jiggle(SERVING), "device",
                   [s for s in ALL if s != "fano2"]),
    "osd_depth 4": (dc.replace(SERVING, demod=dc.replace(
        SERVING.demod, osd_depth=4)), "device",
        [s for s in marks.STAGES if s != "subtract"]),
    "hybrid": (SERVING, "host", [s for s in ALL
                                 if s not in ("fano1", "fano2")]),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_marks_follow_the_stages(path, monkeypatch):
    cfg, fano_mode, want = PATHS[path]
    dec = DeviceDecoder(cfg, device="cpu", fano_mode=fano_mode)
    seen = []
    real = marks.mark

    def record(stage, x):
        seen.append(stage)
        real(stage, x)
    monkeypatch.setattr(marks, "mark", record)
    dec.fetch(dec.decode_windows_ri(frame_windows(2)))
    assert seen == want
    assert [marks.STAGES.index(s) for s in seen] == sorted(
        marks.STAGES.index(s) for s in set(seen))
    if path == "refine_max_lanes":
        assert dec.config.demod.cand_compact_lanes == 0
    if path in ("compacted", "wideband"):
        assert dec.config.demod.cand_compact_lanes > 0


def test_mark_on_the_cpu_launches_nothing(monkeypatch):
    def no_library():
        raise AssertionError("a CPU mark loaded the kernel library")
    monkeypatch.setattr(cuda_build, "load_library", no_library)
    for stage in marks.STAGES:
        assert marks.mark(stage, torch.zeros(1)) is None
    with pytest.raises(KeyError):
        marks.mark("grid", torch.zeros(1))


def test_c_markers_follow_the_stages():
    src = (cuda_build.CSRC_DIR / "marks.cu").read_text()
    kernels = re.findall(r"__global__ void uwspr_mark_(\w+)\(\) \{\}", src)
    cases = re.findall(r"case (\d+): uwspr_mark_(\w+)<<<1, 1, 0, s>>>", src)
    assert kernels == list(marks.STAGES)
    assert cases == [(str(i), s) for i, s in enumerate(marks.STAGES)]
    assert cuda_build._SIGNATURES["uwspr_mark"] == [
        cuda_build.ctypes.c_int, cuda_build.ctypes.c_void_p]
