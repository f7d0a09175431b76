"""The check fails a broken timed path, and its control.

Each fault is planted in the port underneath a shrunk CPU run of a cell,
which is otherwise driven as on the card: a ring that returns its state
unchanged (no shift), half the batch left out, an answer altered where it
is produced. The control, the reference one precision step below the
configuration's in the program's place, must fail too. No cell spans
chips, so no exchange is left out."""

from __future__ import annotations

import pytest
import torch

from wsprbench import compare
from wsprbench import run as R
from wsprbench.tests.conftest import run_small


def _no_shift(r):
    from uwspr_tpu_torch.pipeline.device_ring import DeviceRingDecoder
    orig = DeviceRingDecoder._append

    def stale(self, new, scale):
        if self._filled + self.hop >= self.fl:
            return self._rings[self._cur]
        return orig(self, new, scale)
    r._undo = lambda: setattr(DeviceRingDecoder, "_append", orig)
    DeviceRingDecoder._append = stale


def _half_batch(r):
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    orig = DeviceDecoder._decode

    def half(self, ri):
        W = ri.shape[0]
        out = orig(self, ri[:max(1, W // 2)])
        pad = out[-1:].expand((W - out.shape[0],) + out.shape[1:])
        return torch.cat([out, pad.clone()])
    r._undo = lambda: setattr(DeviceDecoder, "_decode", orig)
    DeviceDecoder._decode = half


def _altered(r):
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    orig = DeviceDecoder._pack

    def alter(out):
        out = dict(out)
        out["payload"] = out["payload"] ^ 1
        out["sync"] = out["sync"] * 1.5
        return orig(out)
    r._undo = lambda: setattr(DeviceDecoder, "_pack", staticmethod(orig))
    DeviceDecoder._pack = staticmethod(alter)


FAULTS = {"state_unchanged": _no_shift, "half_batch": _half_batch,
          "answer_altered": _altered}
CASES = [("narrow_stream_c128", f) for f in FAULTS] + \
    [("wide_cycle_w32", f) for f in ("half_batch", "answer_altered")]


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    holder = {}

    def plant(r):
        FAULTS[fault](r)
        holder["r"] = r
    try:
        res, _, _ = run_small(cell, patch=plant)
    finally:
        holder["r"]._undo()
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["narrow_stream_c128", "wide_cycle_w32"])
def test_sound_run_is_correct_and_its_control_is_not(cell):
    res, _, _ = run_small(cell)
    assert res["correct"] is True
    nums = R.LAST_RUN.reference().control(R.LAST_RUN, procs=2)
    lim = {k: v["limit"] for k, v in res["checked"].items()}
    ok, _ = compare.judge(nums, lim)
    assert ok is False
