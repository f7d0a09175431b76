"""The port's result harnesses (``uwspr_tpu_torch.harness``) against the
reference's (``bench.py`` and ``scripts/``), on the CPU at toy sizes.

- Scenes: every scene of ``harness/scenes.py`` is bitwise equal to the
  windows the reference harness hands its decoder, captured by replacing
  the script's decoder (or ``timed_batch``, or ``multipass_spots``) with a
  recorder that decodes nothing; 2 windows, channels or trials each. The
  4096-channel scene is synthesised by different generators (JAX's on the
  reference's side); at 120 dB SNR, where the noise is below 1e-6, its
  frames agree to 2e-3 of their unit amplitude (float32 phase summed over
  41,472 samples in another order).
- ``vs_reference``: a point passes within 2 trials, a curve within 4.
- ``harness.bench`` prints bench.py's keys and refuses
  ``BENCH_FANO_IMPL=while``; the matrix refuses ``golden_single``.

The decodes against the scripts' own loops are in
tests/test_torch_harness_host.py (host engine),
tests/test_torch_harness_device.py (device and hybrid engines) and
tests/test_torch_harness_osd.py (device OSD). Those files share this one's
helpers and its loaded scripts.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from uwspr_tpu.pipeline import decoder as jdecoder
from uwspr_tpu.pipeline import jit_decoder
from uwspr_tpu.pipeline import sweep as jsweep
from uwspr_tpu_torch import config as tconfig
from uwspr_tpu_torch.harness import (bench, common, matrix, multipass,
                                     osd_calibrate, osd_sweeps, ring_ingest,
                                     scenes, sweeps)
from uwspr_tpu_torch.pipeline import device_decoder as tdd
from uwspr_tpu_torch.pipeline import sweep as tsweep

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = {"bench": "bench.py",
           "matrix": "scripts/bench_matrix.py",
           "sweep": "scripts/sweep_r05_artifact.py",
           "osd_host": "scripts/sweep_osd_artifact.py",
           "osd_device": "scripts/sweep_osd_device_artifact.py",
           "multipass": "scripts/multipass_artifact.py",
           "calibrate": "scripts/osd_calibrate.py",
           "ring": "scripts/bench_ring_ingest.py"}
FRAME_ATOL = 2e-3


def load_scripts(tmp):
    """The reference harnesses as modules. They read sys.argv and point
    JAX's compile cache at a directory when imported: argv is cleared and
    the cache sent to ``tmp`` meanwhile, then restored."""
    mods = {}
    prev = jax.config.jax_compilation_cache_dir
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp))
        for key, rel in SCRIPTS.items():
            mp.setattr(sys, "argv", [rel])
            spec = importlib.util.spec_from_file_location(
                f"_reference_{key}", ROOT / rel)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[key] = mod
    jax.config.update("jax_compilation_cache_dir", prev)
    return mods


_SCRIPTS = {}


def scripts(tmp_path_factory):
    """The reference harnesses, loaded once in a process and shared by the
    harness test files that run there; each test undoes what it patches."""
    if not _SCRIPTS:
        _SCRIPTS.update(load_scripts(tmp_path_factory.mktemp("jax_cache")))
    return _SCRIPTS


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return scripts(tmp_path_factory)


def toy(cls, coarse=None, demod=None):
    """A stand-in for a package's PipelineConfig that builds the config,
    then replaces the given coarse and demod fields."""
    def make(*a, **kw):
        cfg = cls(*a, **kw)
        return dataclasses.replace(
            cfg, coarse=dataclasses.replace(cfg.coarse, **(coarse or {})),
            demod=dataclasses.replace(cfg.demod, **(demod or {})))
    return make


class _Captured(Exception):
    pass


def recorder(package_decoder, seen, stop=None):
    """A decoder class that records the windows it is handed and decodes
    nothing (zero packed output); raises _Captured after ``stop``."""
    raw = vars(package_decoder)           # static or not, as defined

    def note(ri):
        seen.append(np.array(ri))
        if stop is not None and len(seen) >= stop:
            raise _Captured

    class Recorder:
        config = None

        def __init__(self, *a, **k):
            pass

        def decode_windows_ri(self, ri):
            note(ri)
            return np.zeros((len(ri), 1, 23), np.float32)

        def decode_ri_batch(self, ri):
            note(ri)
            return package_decoder.unpack_output(
                np.zeros((len(ri), 1, 23), np.float32))

        def __call__(self, z):
            note(z)
            return argparse.Namespace(spots=[])

        unpack_output = raw.get("unpack_output")
        messages = raw.get("messages")
        spots = raw.get("spots")
    return Recorder


# ---------------------------------------------------------------- scenes

def test_bench_scene_bitwise(ref):
    zj, ej = ref["bench"].make_windows(2)
    zt, et = scenes.bench_windows(2)
    np.testing.assert_array_equal(zt, zj)
    assert et == ej


def test_matrix_scenes_bitwise(ref, monkeypatch):
    m = ref["matrix"]
    seen = []
    monkeypatch.setattr(m, "DeviceDecoder",
                        recorder(jit_decoder.DeviceDecoder, []))
    monkeypatch.setattr(m, "timed_batch", lambda dec, ri, reps=3: (
        seen.append(np.array(ri)), (np.zeros((len(ri), 1, 23)), 1.0))[1])
    m.row_wideband(n_windows=2)
    m.row_deepsnr(n_windows=2)
    m.row_channels(n_ch=2)
    m.row_noise_only(n_windows=2)
    m.row_dense_deepsnr(n_windows=2)
    mine = [scenes.to_ri(scenes.wideband_scene(2)[0])]
    mine += [scenes.to_ri(w) for _, w in scenes.deepsnr_scenes(2)]
    mine += [scenes.to_ri(scenes.channels_scene(2)),
             scenes.to_ri(scenes.noise_only_scene(2)),
             scenes.to_ri(scenes.dense_deepsnr_scene(2)[0])]
    assert len(seen) == len(mine) == 7
    for a, b in zip(mine, seen):
        np.testing.assert_array_equal(a, b)
    exp = scenes.wideband_scene(2)[1]
    assert exp[0] == {f"{c} {g} 30" for c, g in zip(scenes.CALLS,
                                                     scenes.GRIDS)}


def test_serve_4096_scene_frames_match(ref, monkeypatch):
    m = ref["matrix"]
    seen = []
    monkeypatch.setattr(m, "DeviceDecoder",
                        recorder(jit_decoder.DeviceDecoder, seen))
    m.row_serve_4096(n_ch=16, snr_db=120.0, step=16)
    jax_scene = seen[0]                        # the warm-up step: all 16
    scene, emb = scenes.serve_4096_scene(16, 120.0, device=torch.device(
        "cpu"))
    carries = np.abs(jax_scene).max(axis=(1, 2)) > 0.5
    assert np.flatnonzero(carries).tolist() == emb.tolist() and len(emb) == 2
    np.testing.assert_allclose(scene.numpy(), jax_scene, rtol=0,
                               atol=FRAME_ATOL)


def test_sweep_trials_skip_ahead_bitwise(ref, monkeypatch):
    """The harness's points, alone or with the points before them skipped,
    get the windows the JAX sweep hands its decoder at those points."""
    r = ref["sweep"]
    assert (r.SNRS, r.TRIALS) == (sweeps.SNRS, sweeps.TRIALS)
    seen_j, seen_t = [], []
    monkeypatch.setattr(jit_decoder, "DeviceDecoder",
                        recorder(jit_decoder.DeviceDecoder, seen_j))
    monkeypatch.setattr(tsweep, "DeviceDecoder",
                        recorder(tdd.DeviceDecoder, seen_t))
    jsweep.snr_sweep([-15, -16, -17], trials=2, engine="device", seed=1)
    out, _ = sweeps.run_curve("device", tconfig.PipelineConfig(), [-17], 2,
                              device="cpu", all_snrs=[-15, -16, -17])
    assert out == {"-17": [0, 0]} and len(seen_t) == 1
    np.testing.assert_array_equal(seen_t[0], seen_j[2])
    sweeps.run_curve("hybrid", tconfig.PipelineConfig(), [-15, -17], 2,
                     device="cpu", all_snrs=[-15, -16, -17])
    for a, b in zip(seen_t[1:], [seen_j[0], seen_j[2]]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not among"):
        sweeps.run_curve("device", tconfig.PipelineConfig(), [-40], 2,
                         device="cpu")


def test_osd_trials_bitwise(ref, monkeypatch, tmp_path):
    d, h, c = ref["osd_device"], ref["osd_host"], ref["calibrate"]
    assert (d.SNRS, d.TRIALS) == (h.SNRS, h.TRIALS) == (osd_sweeps.SNRS,
                                                        osd_sweeps.TRIALS)
    assert (c.SNRS + [None], c.ORDER, c.TRIALS, c.SEED_BASE) == (
        osd_calibrate.SNRS, osd_calibrate.ORDER, osd_calibrate.TRIALS,
        osd_calibrate.SEED_BASE)
    monkeypatch.setattr(d, "TRIALS", 2)
    np.testing.assert_array_equal(scenes.osd_batch(-30.0, 2),
                                  d.make_batch(-30.0))
    for snr in (-29.0, None):
        for t in range(2):
            np.testing.assert_array_equal(scenes.osd_trial(snr, t),
                                          c.window_for(snr, t))
    seen = []          # the host sweep's loop: base(z), then deep(z)
    monkeypatch.setattr(h, "WindowDecoder",
                        recorder(jdecoder.WindowDecoder, seen))
    for name, v in (("TRIALS", 2), ("SNRS", [-31.0]),
                    ("OUT", str(tmp_path / "osd.json"))):
        monkeypatch.setattr(h, name, v)
    h.main()
    assert len(seen) == 4
    for t in range(2):
        for z in seen[2 * t:2 * t + 2]:
            np.testing.assert_array_equal(scenes.osd_trial(-31.0, t), z)


def test_multipass_trials_bitwise(ref, monkeypatch):
    m = ref["multipass"]
    seen = []
    capture = recorder(jdecoder.WindowDecoder, seen, stop=2)()
    monkeypatch.setattr(m, "WindowDecoder",
                        recorder(jdecoder.WindowDecoder, []))
    monkeypatch.setattr(m, "multipass_spots",
                        lambda z, *a, **k: capture(z).spots)
    monkeypatch.setattr(m, "WEAK_REL_DB", [-12.0])
    with pytest.raises(_Captured):
        m.main()
    for t in range(2):
        np.testing.assert_array_equal(scenes.multipass_trial(-12.0, t),
                                      seen[t])
    assert (m.TRIALS, m.WEAK_REL_DB[0], m.SEP_HZ, m.STRONG_SNR) == (
        multipass.TRIALS, -12.0, scenes.SEP_HZ, scenes.STRONG_SNR)


def test_ring_streams_bitwise(ref, monkeypatch):
    r = ref["ring"]
    monkeypatch.setattr(r, "C", 2)
    np.testing.assert_array_equal(scenes.ring_streams(2, r.HOPS),
                                  r.make_streams())
    blk = r.complex_to_ri_block(r.make_streams()[:, :scenes.HOP])
    np.testing.assert_array_equal(
        scenes.to_ri(scenes.ring_streams(2)[:, :scenes.HOP]), blk)


def test_skip_sweep_trials_leaves_the_generator_where_trials_do():
    from uwspr_tpu_torch.io.channel import awgn
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        f = a.uniform(-5.0, 5.0)
        start = int(a.integers(0, 750))
        awgn(synthesize_frame("VE3EMB", "FN25", 30, start_sample=start,
                              freq_offset=f), -20, rng=a)
    scenes.skip_sweep_trials(b, 3)
    assert a.bit_generator.state == b.bit_generator.state


# ---------------------------------------------------------------- checks

@pytest.mark.parametrize("port, ok", [
    ({"-29": 41 / 50, "-30": 18 / 50}, True),      # -2 and 0
    ({"-29": 45 / 50, "-30": 20 / 50}, True),      # +2, +2: sum 4
    ({"-29": 40 / 50}, False),                     # -3 at one point
    ({"-29": 41 / 50, "-30": 16 / 50, "-31": 0.0}, False),   # sum 5
    ({"-31": 1 / 50}, True),                       # a subset: -31 alone
])
def test_vs_reference_bounds(port, ok):
    record = {"-29": 0.86, "-30": 0.36, "-31": 0.02}
    block = common.vs_reference(port, record, "curve", 50)
    assert block["pass"] is ok
    assert set(block["points"]) == set(port)
    assert block["sum_abs_diff"] == sum(
        abs(round(v * 50) - round(record[p] * 50)) for p, v in port.items())


def test_vs_reference_refuses_unknown_point():
    with pytest.raises(KeyError, match="-40"):
        common.vs_reference({"-40": 0.0}, {"-29": 0.86}, "curve", 50)


def test_finish_fails_on_any_check(tmp_path):
    block = common.vs_reference({"-29": 0.5}, {"-29": 0.86}, "c", 50)
    for rec, rc in (({"exact": {"a": True}}, 0),
                    ({"exact": {"a": False}}, 1),
                    ({"vs_reference": {"c": block}}, 1),
                    ({"rows": [{"config": "x", "exact": {"b": False}}]}, 1),
                    ({"rows": {"x": {"exact": {"b": True}}}}, 0)):
        assert common.finish(rec, str(tmp_path), "r") == rc
        assert json.loads((tmp_path / "r.json").read_text())["pass"] is (
            rc == 0)


def test_osd_calibrate_compare():
    row = {"snr": -30.0, "trial": 0, "cand": 0, "correct": False,
           "unpack": True, "quality": 0.7225, "margin": 0.01126,
           "flips": 3, "sync2": 0.1416, "agree2": False}
    assert osd_calibrate.compare([row], [row])["pass"]
    near = dict(row, quality=0.7230, sync2=0.1410)
    assert osd_calibrate.compare([near], [row])["pass"]
    far = osd_calibrate.compare([dict(row, margin=0.0125)], [row])
    assert not far["pass"] and far["differ"][0]["fields"] == ["margin"]
    flips = osd_calibrate.compare([dict(row, flips=2)], [row])
    assert flips["differ"][0]["fields"] == ["flips"]
    extra = osd_calibrate.compare([row, dict(row, trial=1)], [row])
    assert extra["only_port"] == [[-30.0, 1, 0]] and not extra["pass"]


def test_ring_htod_checks():
    """The bytes each ring row must send per step, at C = 128 (one H100
    run read 3,456,002 B for an f32 hop, 1,728,514 for int16, 46,080,002
    for the full windows and 2 for the resident batch)."""
    read = {"ring_f32": 3456002.0, "ring_f32_unstaged": 3456002.0,
            "ring_int16": 1728514.0, "ring_multi13": 1728514.0,
            "full_h2d": 46080002.0, "h2d_only": 3456000.0,
            "device_resident": 2.0}
    rows = {k: {"htod_bytes_per_step": v} for k, v in read.items()}
    assert all(ring_ingest.htod_checks(rows, 128).values())
    for k, v in (("h2d_only", 0.0), ("ring_int16", 3456002.0),
                 ("device_resident", 46080002.0)):
        bad = ring_ingest.htod_checks({**rows, k: {
            "htod_bytes_per_step": v}}, 128)
        assert [n for n, ok in bad.items() if not ok] == [f"{k}_htod_bytes"]


# ---------------------------------------------------------------- bench

def test_bench_prints_bench_py_keys(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("BENCH_WINDOWS", "2")
    monkeypatch.setenv("BENCH_REPS", "1")
    assert bench.main(["--device", "cpu", "--out", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "window_samples_per_s_per_chip"
    assert line["value"] > 0 and line["unit"] == "samples/s"
    rec = json.loads((tmp_path / "bench.json").read_text())
    assert rec["decoded"] == "2/2" and rec["card"] == "cpu" and rec["pass"]
    assert rec["roofline"] == "not measured (CPU run)"
    assert rec["plain_calls"]["select_best"] > 0


def test_bench_refuses_the_while_loop_fano(monkeypatch):
    with pytest.raises(SystemExit, match="do-not-port"):
        bench.knobs({"BENCH_FANO_IMPL": "while"})
    k = bench.knobs({})
    assert (k["windows"], k["refine_max_lanes"], k["stft_impl"],
            k["reps"]) == (128, 256, "matmul_bf16", 8)
    assert bench.knobs({"BENCH_STFT": "pallas"})["stft_impl"] == "pallas"


def test_golden_single_refused(tmp_path):
    with pytest.raises(SystemExit, match="not in the repository"):
        matrix.main(["--device", "cpu", "--only", "golden_single",
                     "--out", str(tmp_path)])
    assert not (tmp_path / "matrix.json").exists()


def test_harness_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        sweeps.main(["--snr", "-15", "--trials", "1"])


def test_records_read_by_the_harnesses_exist():
    names = {bench: ["BENCH_r05.json"], matrix: [matrix.REFERENCE],
             sweeps: [sweeps.REFERENCE], multipass: [multipass.REFERENCE],
             osd_calibrate: [osd_calibrate.REFERENCE],
             osd_sweeps: list(osd_sweeps.REFERENCES.values())}
    for mod, recs in names.items():
        for name in recs:
            assert isinstance(common.load_record(name), dict), name
    assert bench.reference_decoded() == (128, 128)
    assert os.path.isfile(ROOT / "BENCH_RING_r05.json")
