"""The narrowband batch cell ``narrow_cycle_w128``: a shrunk CPU run is
correct and its batch of whole frames reaches the Fano. On the card
(``-m cuda``), the cell at its own size is correct and its control is
not."""

from __future__ import annotations

import io

import pytest

from wsprbench import compare
from wsprbench import run as R
from wsprbench.tests.conftest import run_small

CELL = "narrow_cycle_w128"


def test_shrunk_cell_is_correct():
    res, _, _ = run_small(CELL)
    assert res["correct"] is True
    assert all(v["value"] == 0 for k, v in res["checked"].items()
               if k in ("spots_differ", "counts_differ"))
    assert R.LAST_RUN.counters["fano_attempts"] > 0


@pytest.mark.cuda
def test_cell_is_correct_and_its_control_is_not(card):
    R.set_build_env(R.ROOT)
    res = R.run_cell(R.ROOT, CELL, 2_147_483_659, 3.0, 0, device=card,
                     out=io.StringIO(), err=io.StringIO())
    assert res["correct"] is True
    lim = {k: v["limit"] for k, v in res["checked"].items()}
    ok, _ = compare.judge(R.LAST_RUN.reference().control(R.LAST_RUN), lim)
    assert ok is False
