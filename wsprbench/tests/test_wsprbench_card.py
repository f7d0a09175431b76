"""On the card, at each cell's own size: a short run is correct and the
control (the reference one precision step below) is not. Run with
``python -m pytest wsprbench/tests -m cuda`` on a machine with a card."""

from __future__ import annotations

import io

import pytest

from wsprbench import compare
from wsprbench import run as R


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["narrow_stream_c128", "wide_cycle_w32"])
def test_cell_is_correct_and_its_control_is_not(card, cell):
    R.set_build_env(R.ROOT)
    res = R.run_cell(R.ROOT, cell, 2_147_483_659, 3.0, 0, device=card,
                     out=io.StringIO(), err=io.StringIO())
    assert res["correct"] is True
    lim = {k: v["limit"] for k, v in res["checked"].items()}
    ok, _ = compare.judge(R.LAST_RUN.reference().control(R.LAST_RUN), lim)
    assert ok is False
