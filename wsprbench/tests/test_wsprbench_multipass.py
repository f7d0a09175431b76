"""The cells of this benchmark's multipass deployment and of the ring at
1,024 channels: a shrunk CPU run of ``narrow_masked_w32`` is correct and
its driver puts the decoder's multipass and OSD tallies in the counters,
the masked traffic is what its file says, the plain subtraction and the
check import nothing of the port or of JAX and hold the port's
subtraction, the new readers read a planted trace, and three faults
planted in the program's passes make ``correct`` false: the subtraction
skipped, a duplicate reported, and the later passes run in every window.
The shrunk ring at 1,024 channels' traffic file runs as the 128-channel
one does. On the card (``-m cuda``), the masked cell at its own size is
correct and its control is not."""

from __future__ import annotations

import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from wsprbench import compare
from wsprbench import run as R
from wsprbench.tests.conftest import run_small

CELL = "narrow_masked_w32"
SEED = 20261017


def test_shrunk_cell_is_correct_and_counts_the_passes():
    res, _, _ = run_small(CELL, seed=SEED)
    assert res["correct"] is True
    c = R.LAST_RUN.counters
    assert c["mp_decodes"] >= 3 and c["mp_subtracted"] > 0
    assert c["mp_spots_pass2"] > 0 and c["osd_decodes"] == 3 * c[
        "mp_decodes"]
    ref = R.LAST_RUN.checked["ref"]
    C = ref["success"].shape[1] // 3
    assert ref["success"][:, C:].any()          # a frame of a later pass
    assert (R.LAST_RUN.checked["prog"]["pass_index"]
            == np.arange(3 * C) // C).all()


def test_masked_traffic():
    from wsprbench.generators import cycle_masked
    t = json.loads((R.ROOT / "wsprbench" / "traffic"
                    / "cycle_masked.json").read_text())
    t.update(batch=2, pool_batches=2)
    a = cycle_masked.generate(t, 2**31 + 7, torch.device("cpu"))
    b = cycle_masked.generate(t, 2**31 + 7, torch.device("cpu"))
    assert a["pool"].shape == (2, 2, 2, 45000)
    assert np.array_equal(a["pool"], b["pool"])
    f = a["frames"]
    sep = np.abs(f["freq"][1::2] - f["freq"][0::2])
    assert ((sep >= 1.0) & (sep <= 2.0)).all()
    assert (np.abs(f["freq"][0::2]) <= 4.0).all()
    assert (f["message"][0::2] != f["message"][1::2]).all()
    assert f["weak"].tolist() == [False, True] * 4
    assert (f["start"] < 2000).all()


def test_plain_subtraction_imports_nothing_of_the_port():
    code = ("import sys, wsprbench.reference.subtract, "
            "wsprbench.checks.device_plain_mp\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT,
                         capture_output=True, text=True, check=True)
    mods = json.loads(out.stdout.replace("'", '"'))
    assert not set(mods) & {"jax", "jaxlib", "uwspr_tpu", "uwspr_tpu_torch"}


def test_plain_subtraction_holds_the_ports():
    """The plain subtraction equals the port's subtract_spot within a
    float32 ulp of the fitted frame, on a linear and an SLM spot; its
    float32 phase (the control) does not."""
    from uwspr_tpu_torch.io.channel import awgn
    from uwspr_tpu_torch.pipeline import multipass as mp
    from uwspr_tpu_torch.pipeline.decoder import Spot
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    from wsprbench.reference import protocol as P
    from wsprbench.reference import subtract as plain
    z = awgn(synthesize_frame("K1ABC", "FN42", 37, start_sample=900,
                              freq_offset=-2.1), -14,
             rng=np.random.default_rng(1))
    pay = P.pack_type1("K1ABC", "FN42", 37)
    for mode, slm in ((0, ()), (1, (1.0, -2.0, 0.0, 250.0))):
        s = Spot(message="", payload=pay, freq=-2.1, snr=0.0, sync=0.5,
                 shift=896, drift=0.5 * (1 - mode), mode=mode,
                 slm_params=slm, jiggle=1)
        want = mp.subtract_spot(z, s)
        lag = 896 - 8
        got = plain.subtract(z, pay, s.freq, lag, mode, s.drift,
                             slm or (0, 0, 0, 0), 1500.0)
        tol = 1e-6 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= tol
        f32 = plain.subtract(z, pay, s.freq, lag, mode, s.drift,
                             slm or (0, 0, 0, 0), 1500.0, phase="f32")
        assert float(np.abs(f32 - want).max()) > tol


MS = 1_000_000          # ns


def _layer(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "layer", R.ROOT / "wsprbench" / "layers" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def multipass_view(passes=3):
    """One replay of a 2-window batch over ``passes`` passes: each pass's
    stages (a kernel of 10 ns each, the OSD's 30), a subtraction stage of
    a compaction (5) and the kernel (200) after each pass but the last,
    then pack and end; a copy inside each stage and a kernel after the
    end belong to none."""
    from wsprbench.trace import DeviceEvent, TraceView
    ev, t = [], 0

    def k(name, dur):
        nonlocal t
        ev.append(DeviceEvent(name, t, t + dur))
        t += dur + 1
    for p in range(passes):
        for stage in ("stft", "coarse", "select", "compact", "refine",
                      "prefano_tail", "fano1", "fano2"):
            k(f"uwspr_mark_{stage}", 1)
            k("some_kernel(float*)", 10)
        k("uwspr_mark_osd", 1)
        k("osd_kernel(unsigned char*)", 30)
        k("Memcpy DtoD (Device -> Device)", 4)
        if p < passes - 1:
            k("uwspr_mark_subtract", 1)
            k("index_kernel", 5)
            k("(anonymous namespace)::subtract_lanes_kernel(Args)", 200)
    k("uwspr_mark_pack", 1)
    k("pack_kernel", 3)
    k("uwspr_mark_end", 1)
    k("CatArrayBatchedCopy", 50)
    return TraceView(0, t, 1, 2, ev, [])


class _Run:
    def __init__(self, counters, passes=3):
        self.counters = counters
        self.traffic = {"batch": 2}
        self.config = {"pipeline": {"multipass": {"passes": passes}}}


def test_multipass_readers_on_a_planted_trace():
    view = multipass_view()
    sub = _layer("subtract.ms_per_window").read
    later = _layer("later_passes.ms_per_window").read
    lanes = _layer("subtract.lanes_per_window").read
    roof = _layer("subtract_roofline").read
    assert sub(None, view) == pytest.approx(2 * 205 / 1e6 / 2)
    # two subtractions and passes 2 and 3 (8 kernels of 10, the OSD's 30)
    assert later(None, view) == pytest.approx(
        (2 * 205 + 2 * (8 * 10 + 30)) / 1e6 / 2)
    run = _Run({"mp_decodes": 4, "mp_subtracted": 12})
    assert lanes(run, None) == pytest.approx(12 / (4 * 2))
    work = _layer("_subtract_work")
    frames = 12 / (4 * 2)
    want = frames * work.fmas() / work.DFMA_PER_S / 200e-9 * 100
    assert roof(run, view) == pytest.approx(want)
    assert work.fmas() == 69 * 41472 * 4
    single = multipass_view(passes=1)
    for read in (sub, later):
        assert read(None, single) is None and read(None, None) is None
    assert lanes(_Run({}), None) is None
    assert roof(_Run({}), view) is None
    assert roof(run, single) is None


def _no_subtraction(r):
    from uwspr_tpu_torch.pipeline import device_decoder as dd
    orig = dd.subtract_lanes
    r._undo = lambda: setattr(dd, "subtract_lanes", orig)
    dd.subtract_lanes = lambda ri, *a, **k: torch.zeros(
        (a[0].shape[0], 4), dtype=torch.float64)


def _duplicate_reported(r):
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    orig = DeviceDecoder._duplicates
    r._undo = lambda: setattr(DeviceDecoder, "_duplicates", orig)
    DeviceDecoder._duplicates = lambda self, out, earlier: torch.zeros_like(
        out["success"])


def _every_window(r):
    """Later passes over every window, on frames too weak to decode: the
    program decodes again the windows where nothing was subtracted."""
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    orig = DeviceDecoder._subtract
    r.traffic["strong_snr_db"] = -31.0

    def every(self, res, out):
        windows, n, capped = orig(self, res, out)
        return torch.ones_like(windows), n, capped
    r._undo = lambda: setattr(DeviceDecoder, "_subtract", orig)
    DeviceDecoder._subtract = every


FAULTS = {"subtraction_skipped": _no_subtraction,
          "duplicate_reported": _duplicate_reported,
          "every_window": _every_window}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_multipass_is_not_correct(fault):
    holder = {}

    def plant(r):
        FAULTS[fault](r)
        holder["r"] = r
    try:
        res, _, _ = run_small(CELL, seed=SEED, patch=plant)
    finally:
        holder["r"]._undo()
    assert res["correct"] is False, res["checked"]


def test_ring_c1024_traffic_is_the_ring_at_1024_channels():
    a = json.loads((R.ROOT / "wsprbench" / "traffic"
                    / "ring_beacons.json").read_text())
    b = json.loads((R.ROOT / "wsprbench" / "traffic"
                    / "ring_beacons_c1024.json").read_text())
    assert b.pop("channels") == 1024 and a.pop("channels") == 128
    assert a == b
    res, _, _ = run_small("narrow_stream_c1024", seed=SEED)
    assert res["correct"] is True


@pytest.mark.cuda
def test_cell_is_correct_and_its_control_is_not(card):
    R.set_build_env(R.ROOT)
    res = R.run_cell(R.ROOT, CELL, 2_147_483_659, 3.0, 0, device=card,
                     out=io.StringIO(), err=io.StringIO())
    assert res["correct"] is True
    lim = {k: v["limit"] for k, v in res["checked"].items()}
    ok, _ = compare.judge(R.LAST_RUN.reference().control(R.LAST_RUN), lim)
    assert ok is False
