"""``uwspr_tpu_torch/harness/replay.py``, the replay that holds a path's
selection and Fano calls to their oracles, on the CPU: the calls that the
device engine's bound names make are recorded and the names restored; a
faithful record replays clean; a record whose selection result, active
Fano lane or inactive Fano lane breaks the oracle or the kernel's contract
is reported; replays merge by summing.
"""

import copy
import functools

import numpy as np
import pytest
import torch

from uwspr_tpu_torch.coarse import search
from uwspr_tpu_torch.harness import replay
from uwspr_tpu_torch.pipeline import device_decoder as ddm
from uwspr_tpu_torch.protocol.constants import FANO_METTAB
from uwspr_tpu_torch.protocol.fec_encode import encode_bits

MAXCYCLES = 60


def lanes(rng, n, sigma=20.0, scale=50.0):
    """n soft-symbol lanes of encoded random payloads plus noise."""
    out = []
    for _ in range(n):
        bits = rng.integers(0, 2, size=50).astype(np.uint8)
        coded = encode_bits(np.concatenate([bits, np.zeros(31, np.uint8)]))
        soft = (np.where(coded == 1, 1.0, -1.0) * scale
                + rng.normal(0, sigma, 162) + 128)
        out.append(np.clip(soft, 0, 255).astype(np.uint8))
    return np.stack(out)


def record():
    """A copy of ``_record()``'s recorded calls, in a KernelReplay of its
    own."""
    calls, rec = replay.KernelReplay(), _record()
    calls.select, calls.fano, calls.probe = copy.deepcopy(
        (rec.select, rec.fano, rec.probe))
    return calls


@functools.cache
def _record():
    """A KernelReplay of two selection calls (through both engines' bound
    names) and one Fano call with two inactive lanes and two lanes of
    noise that run out of budget."""
    rng = np.random.default_rng(5)
    sym = np.concatenate([lanes(rng, 4), rng.integers(
        0, 256, size=(2, 162)).astype(np.uint8)])
    active = torch.tensor([True, False, True, True, False, True])
    grid = torch.from_numpy(rng.normal(size=(3, 5, 26, 7))
                            .astype(np.float32))
    is_nl = torch.tensor([False] * 4 + [True] * 3)   # linear first
    orig = (ddm.select_best, ddm.fano_decode_batch, search.select_best)
    with replay.KernelReplay() as calls:
        ddm.select_best(grid, is_nl, threshold=0.5)
        search.select_best(grid[:2], is_nl, threshold=1.0)
        ddm.fano_decode_batch(torch.from_numpy(sym),
                              torch.from_numpy(FANO_METTAB), active,
                              maxcycles=MAXCYCLES)
    assert (ddm.select_best, ddm.fano_decode_batch,
            search.select_best) == orig
    return calls


def test_a_faithful_record_replays_clean():
    r = record().replay()
    assert r["ok"] and r["failures"] == []
    assert (r["select_calls"], r["select_lanes"]) == (2, 5)
    assert (r["fano_calls"], r["fano_active_lanes"]) == (1, 4)
    assert r["fano_timeouts"] == 1 and r["fano_max_abs_err"] == 0
    assert r["probe_calls"] == 0


def _select_best(calls):
    calls.select[0][3][1] += 1.0


def _select_index(calls):
    calls.select[1][4][0] += 1


def _active_data(calls):
    calls.fano[0][5]["data"][0, 3] ^= 1


def _active_cycles(calls):
    calls.fano[0][5]["cycles"][2] += 1


def _inactive_success(calls):
    calls.fano[0][5]["success"][1] = True


def _inactive_cycles(calls):
    calls.fano[0][5]["cycles"][4] = 0


def _inactive_maxnp(calls):
    calls.fano[0][5]["maxnp"][1] = 3


@pytest.mark.parametrize("tamper,found", [
    (_select_best, "select_best differs"),
    (_select_index, "select_best differs"),
    (_active_data, "data differs"),
    (_active_cycles, "cycles differs"),
    (_inactive_success, "inactive Fano lanes"),
    (_inactive_cycles, "inactive Fano lanes"),
    (_inactive_maxnp, "inactive Fano lanes"),
], ids=lambda v: getattr(v, "__name__", "")[1:] or None)
def test_a_broken_record_is_reported(tamper, found):
    calls = record()
    tamper(calls)
    r = calls.replay()
    assert not r["ok"]
    assert any(found in f for f in r["failures"]), r["failures"]


def test_merged_sums_the_counts():
    a = record().replay()
    calls = record()
    _inactive_cycles(calls)
    b = calls.replay()
    m = replay.merged([a, b])
    assert m["select_lanes"] == 10 and m["fano_active_lanes"] == 8
    assert m["fano_timeouts"] == 2 and not m["ok"]
    assert m["failures"] == b["failures"]
    assert replay.merged([a, a])["ok"]
