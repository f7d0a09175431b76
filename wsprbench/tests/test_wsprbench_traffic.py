"""The traffic generator: deterministic from the seed, and the ring stream
continuous across its wrap."""

from __future__ import annotations

import json

import numpy as np
import torch

from wsprbench import gen
from wsprbench import run as R
from wsprbench.reference import protocol as P

CPU = torch.device("cpu")


def _traffic(name: str) -> dict:
    return json.loads((R.ROOT / "wsprbench" / "traffic" / f"{name}.json")
                      .read_text())


def _small_ring() -> dict:
    t = _traffic("ring_beacons")
    t["channels"] = 3
    return t


def _small_wide() -> dict:
    t = _traffic("cycle_wide")
    t["batch"], t["pool_batches"], t["signals"] = 2, 2, 3
    return t


def test_each_traffic_is_deterministic_from_its_seed():
    for t in (_small_ring(), _small_wide()):
        a = gen.generate(t, 2 ** 31 + 77, CPU)
        b = gen.generate(t, 2 ** 31 + 77, CPU)
        c = gen.generate(t, 5, CPU)
        key = "stream" if t["kind"] == "ring_stream" else "pool"
        assert np.array_equal(a[key], b[key])
        assert not np.array_equal(a[key], c[key])


def test_ring_stream_is_continuous_across_its_wrap():
    t = _small_ring()
    t["snr_db"] = 200.0                      # no noise to speak of
    d = gen.generate(t, 99, CPU)
    s, N, fr = d["stream"], d["period"], d["frames"]
    assert N == 120 * t["hop_samples"]
    wrapped = [i for i in range(len(fr["start"]))
               if fr["start"][i] + P.FRAME_SAMPLES > N]
    assert wrapped, "no frame of the seed runs across the wrap"
    i = wrapped[0]
    _, _, syms = gen.message_table()
    frame = gen.synth_frames(syms[[fr["message"][i]]],
                             np.asarray([fr["freq"][i]]), CPU)[0].numpy()
    want = frame[0] + 1j * frame[1]
    pos = (fr["start"][i] + np.arange(P.FRAME_SAMPLES)) % N
    got = s[fr["channel"][i], pos]
    assert np.abs(got - want).max() < 1e-5
    # the last sample before the wrap and the first after it are
    # consecutive samples of one frame
    k = N - fr["start"][i]
    assert np.abs(got[k - 1] - want[k - 1]) < 1e-5
    assert np.abs(got[k] - want[k]) < 1e-5


def test_every_seed_gets_the_same_frame_phases():
    t = _traffic("ring_beacons")
    t["channels"], t["snr_db"] = 8, 0.0
    a = gen.generate(t, 1, CPU)["frames"]
    b = gen.generate(t, 2, CPU)["frames"]
    cyc = t["cycle_samples"]
    ph_a = np.sort(a["start"][a["start"] < cyc] // (cyc // 8))
    ph_b = np.sort(b["start"][b["start"] < cyc] // (cyc // 8))
    assert np.array_equal(ph_a, ph_b)
