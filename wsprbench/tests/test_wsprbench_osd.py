"""The cell of the deep-SNR deployment: a shrunk CPU run is correct and
its driver puts the decoder's OSD tally in the counters, the plain OSD and
its check import nothing of the port or of JAX, and two faults planted in
the OSD make ``correct`` false: an OSD-accepted payload altered, and the
margin screen switched off in the program. On the card (``-m cuda``), the
cell at its own size is correct and its control is not."""

from __future__ import annotations

import dataclasses
import io
import json
import subprocess
import sys

import pytest

from wsprbench import compare
from wsprbench import run as R
from wsprbench.tests.conftest import run_small

CELL = "narrow_osd_deep_w32"


def test_shrunk_cell_is_correct_and_counts_the_osd():
    res, _, _ = run_small(CELL)
    assert res["correct"] is True
    c = R.LAST_RUN.counters
    assert c["osd_decodes"] >= 3 and c["osd_active_lanes"] > 0
    assert c["osd_accepted_margin"] + c["osd_accepted_agreement"] > 0
    assert (R.LAST_RUN.checked["ref"]["osd"] > 0).any()


def test_osd_reference_imports_nothing_of_the_port():
    code = ("import sys, wsprbench.reference.osd, "
            "wsprbench.checks.device_plain_osd\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT,
                         capture_output=True, text=True, check=True)
    mods = json.loads(out.stdout.replace("'", '"'))
    assert not set(mods) & {"jax", "jaxlib", "uwspr_tpu", "uwspr_tpu_torch"}


def _deep(r):
    """Frames the OSD rescues at every lane: a Fano budget of one cycle
    a bit (81 looks, which a decode never finishes inside) at -26 dB."""
    r.config["pipeline"]["demod"]["maxcycles"] = 1
    r.traffic["snr_db"] = -26.0


def _altered_payload(r):
    from uwspr_tpu_torch.pipeline import device_decoder as dd
    orig = dd.bits_to_payload
    r._undo = lambda: setattr(dd, "bits_to_payload", orig)
    dd.bits_to_payload = lambda u: orig(u) ^ 1
    _deep(r)


def _no_margin_screen(r):
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    orig = DeviceDecoder._osd_rescue

    def unscreened(self, *a):
        cfg = self.config
        self.config = dataclasses.replace(cfg, demod=dataclasses.replace(
            cfg.demod, osd_min_margin=0.0, osd_margin_agree=0.0))
        try:
            return orig(self, *a)
        finally:
            self.config = cfg
    r._undo = lambda: setattr(DeviceDecoder, "_osd_rescue", orig)
    DeviceDecoder._osd_rescue = unscreened


@pytest.mark.parametrize("fault", [_altered_payload, _no_margin_screen])
def test_a_broken_osd_is_not_correct(fault):
    holder = {}

    def plant(r):
        fault(r)
        holder["r"] = r
    try:
        res, _, _ = run_small(CELL, patch=plant)
    finally:
        holder["r"]._undo()
    assert res["correct"] is False
    assert res["checked"]["spots_differ"]["value"] > 0


@pytest.mark.cuda
def test_cell_is_correct_and_its_control_is_not(card):
    R.set_build_env(R.ROOT)
    res = R.run_cell(R.ROOT, CELL, 2_147_483_659, 3.0, 0, device=card,
                     out=io.StringIO(), err=io.StringIO())
    assert res["correct"] is True
    lim = {k: v["limit"] for k, v in res["checked"].items()}
    ok, _ = compare.judge(R.LAST_RUN.reference().control(R.LAST_RUN), lim)
    assert ok is False
