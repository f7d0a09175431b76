"""Shared fixtures of the benchmark's tests: a cell shrunk to run on the
CPU in seconds, and the card, looked for inside a fixture."""

from __future__ import annotations

import io
import json

import pytest
import torch

from wsprbench import run as R


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def shrink(r) -> None:
    """A cell at a size the CPU runs in seconds: a few channels or windows
    and a toy Fano budget (the plain lockstep Fano walks every cycle)."""
    t = r.traffic
    r.config["pipeline"]["demod"]["maxcycles"] = 30
    if t["kind"] == "ring_stream":
        t["channels"] = 4
        t["check"]["windows"] = 4
    else:
        t["batch"], t["pool_batches"] = 2, 2
        t["check"]["windows"] = 2


def run_small(cell: str, seed: int = 20261017, patch=None):
    """(result object, last stdout line, stderr) of a shrunk CPU run."""
    out, err = io.StringIO(), io.StringIO()

    def both(r):
        shrink(r)
        if patch is not None:
            patch(r)
    res = R.run_cell(R.ROOT, cell, seed, 0.2, 0, device="cpu", out=out,
                     err=err, patch=both)
    last = out.getvalue().strip().splitlines()[-1]
    assert json.loads(last) == res
    return res, last, err.getvalue()
