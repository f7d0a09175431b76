"""The port's spot logger, roofline accounting and profiler trace.

- ``SpotLogger`` writes the same four files as the JAX one for the same
  spots (a linear, a nonlinear and an OSD spot, built in both packages'
  ``Spot`` class), with the clock patched for both: byte for byte.
- ``roofline.analyze`` classifies synthetic intervals as the JAX function
  does when given the same peaks (the port's bound names say "tensor
  core" where the JAX ones say "MXU"); ``cost_of`` counts a matmul's FLOPs.
- ``utils.profiler.trace`` writes a TensorBoard trace of a CPU decode.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from uwspr_tpu.pipeline import decoder as jdecoder
from uwspr_tpu.utils import roofline as jroof
from uwspr_tpu.utils import spotlog as jspotlog
from uwspr_tpu_torch.pipeline import decoder as tdecoder
from uwspr_tpu_torch.utils import profiler as tprof
from uwspr_tpu_torch.utils import roofline as troof
from uwspr_tpu_torch.utils import spotlog as tspotlog

CLOCK = 1_760_000_000.0
SPOTS = [
    dict(message="K1ABC FN42 37", payload=bytes(range(7)), freq=2.4875,
         snr=-18.25, sync=0.734, shift=1100, drift=0.0, mode=0,
         fano_cycles=1234, jiggle=3, candidate=2),
    dict(message="VE3EMB FN25 30", payload=bytes([9, 8, 7, 6, 5, 4, 3]),
         freq=-4.125, snr=-27.5, sync=0.41, shift=600, drift=-1.5, mode=1,
         slm_params=(np.float32(1.25), -0.5, 3.0, 7.0), fano_cycles=810002,
         jiggle=11),
    dict(message="G4ABC IO91 0", payload=bytes(7), freq=0.05, snr=-30.0,
         sync=0.3, shift=0, drift=0.5, mode=0, osd=4, pass_index=1),
]


@pytest.fixture
def frozen_clock(monkeypatch):
    gm, lt = time.gmtime, time.localtime
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    monkeypatch.setattr(time, "gmtime", lambda *a: gm(CLOCK))
    monkeypatch.setattr(time, "localtime", lambda *a: lt(CLOCK))


def _write(mod, spot_cls, d):
    paths = [d / n for n in ("messagelog.txt", "s.jsonl", "wspr_spots.txt",
                             "ALL_WSPR.TXT")]
    log = mod.SpotLogger(*map(str, paths), dial_freq_mhz=14.0956)
    for s in SPOTS:
        log.log(spot_cls(**s))
    log.close()
    return [p.read_bytes() for p in paths]


def test_spotlogger_files_equal(frozen_clock, tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = _write(tspotlog, tdecoder.Spot, tmp_path / "t")
    want = _write(jspotlog, jdecoder.Spot, tmp_path / "j")
    assert [f.count(b"\n") for f in got][1:] == [3, 3, 3]
    for a, b in zip(got, want):
        assert a == b
    assert b"Nonlinear drift  V=:(1.25,-0.50) p=(3,7)" in got[0]


def test_spot_fields_equal():
    tf = [(f.name, f.default) for f in dataclasses.fields(tdecoder.Spot)]
    jf = [(f.name, f.default) for f in dataclasses.fields(jdecoder.Spot)]
    assert tf == jf


INTERVALS = [(1e9, 1e6, 1e-3), (5e11, 1e6, 1e-3), (1e6, 3e9, 1e-3),
             (0.0, 0.0, 0.0), (2e12, 2e9, 1e-2), (1e6, 1e3, 1.0)]


@pytest.mark.parametrize("flops,nbytes,seconds", INTERVALS)
def test_analyze_classifies_as_jax(flops, nbytes, seconds):
    peaks = dict(peak_flops=troof.H100_PEAK_BF16_FLOPS,
                 peak_bytes=troof.H100_PEAK_HBM_BYTES)
    t = troof.analyze(flops, nbytes, seconds, **peaks)
    j = jroof.analyze(flops, nbytes, seconds, **peaks)
    names = {"MXU": "tensor core", "HBM": "HBM",
             "dispatch/latency": "dispatch/latency"}
    assert t.bound == names[j.bound]
    assert (t.flops_per_s, t.bytes_per_s, t.tc_util, t.hbm_util) == (
        j.flops_per_s, j.bytes_per_s, j.mxu_util, j.hbm_util)
    assert t.line().replace("tensor core", "MXU") == j.line()


def test_h100_peaks_and_cost_of():
    assert troof.H100_PEAK_BF16_FLOPS == 989e12
    assert troof.H100_PEAK_HBM_BYTES == 3.35e12
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    assert troof.cost_of(torch.matmul, a, b) == (2.0 * 64 * 32 * 16, 0.0)


def test_profiler_trace_writes_a_trace(tmp_path):
    from uwspr_tpu_torch.config import PipelineConfig
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    dec = DeviceDecoder(PipelineConfig(), device="cpu")
    z = synthesize_frame("VE3EMB", "FN25", 30)
    with tprof.trace(str(tmp_path), device="cpu"):
        with tprof.span("one_window", 7):
            msgs = dec.messages(dec(z))
    assert msgs == ["VE3EMB FN25 30"]
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"uwspr.one_window", "uwspr.decoder.submit", "uwspr.decoder.fetch",
            "aten::argmax"} <= names
    one = [e for e in events if e.get("name") == "uwspr.one_window"]
    assert len(one) == 1 and one[0]["args"]["Concrete Inputs"] == ["7"]
    with tprof.trace(None, device="cpu"):        # no-op
        pass
    assert len(list(tmp_path.iterdir())) == 1
