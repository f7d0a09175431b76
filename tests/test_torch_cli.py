"""The port's CLI (``uwspr_tpu_torch.cli``) against the JAX package's.

Both CLIs are called in-process through ``main(argv)``, the JAX one with
``--platform cpu`` and the port with ``--device cpu``, on files made here
from a seed. One window per decode; the JAX engines run only where a
parity check needs them.

Tolerances: decode prints the same messages, and the spots' JSONL records
(full precision) agree as tests/test_torch_window_decoder.py holds the host
engine: message, payload, freq, shift, drift, mode, candidate and jiggle
equal, SNR to rel 1e-5, sync to 1e-5. ``c2towav`` writes equal bytes (the
same numpy upconvert); ``wavtoc2`` goes through the front end and agrees
to within 1e-5 of the peak magnitude. The synthetic serve source and the
sweep's trial windows are bitwise equal.
"""

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from uwspr_tpu import cli as jcli
from uwspr_tpu.pipeline import sweep as jsweep
from uwspr_tpu_torch import cli as tcli
from uwspr_tpu_torch.io.c2file import read_c2
from uwspr_tpu_torch.pipeline import sweep as tsweep

ROOT = pathlib.Path(__file__).resolve().parents[1]
SYNC_ATOL = 1e-5
SPOT = re.compile(r"^(.+?)    \(freq ([+-]\d+\.\d+) Hz, SNR (-?\d+\.\d) dB, "
                  r"sync (\d+\.\d\d), (linear|nonlinear)\)$")


def port(*argv):
    tcli.main(["--device", "cpu", *map(str, argv)])


def jax(*argv):
    jcli.main(["--platform", "cpu", *map(str, argv)])


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    tcli.main(["encode", "K1ABC", "FN42", "37", "-o", str(d / "x.c2"),
               "--freq-offset", "2.5", "--start", "900"])
    return d, d / "x.c2"


def _jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_decode_prints_the_jax_cli_spots(frame, tmp_path, capsys):
    d, c2 = frame
    assert c2.stat().st_size == 360026        # reference c2 layout
    capsys.readouterr()
    port("decode", c2, "--engine", "host", "--jsonl", tmp_path / "t.jsonl",
         "--spots", tmp_path / "t.txt")
    out_t = capsys.readouterr()
    jax("decode", c2, "--engine", "host", "--jsonl", tmp_path / "j.jsonl")
    out_j = capsys.readouterr()
    lines_t = out_t.out.splitlines()
    lines_j = out_j.out.splitlines()
    assert [SPOT.match(x).group(1) for x in lines_t] == ["K1ABC FN42 37"]
    assert ([SPOT.match(x).group(1) for x in lines_t]
            == [SPOT.match(x).group(1) for x in lines_j])
    assert "# 1 spot(s) from 1 window(s)" in out_t.err
    assert "(host engine on cpu; 0 lanes shed by the lane caps)" in out_t.err
    assert "K1ABC FN42 37" in (tmp_path / "t.txt").read_text()
    (rt,), (rj,) = _jsonl(tmp_path / "t.jsonl"), _jsonl(tmp_path / "j.jsonl")
    for k in ("message", "payload", "freq", "shift", "drift", "mode",
              "candidate", "jiggle", "osd", "pass_index"):
        assert rt[k] == rj[k], k
    assert rt["snr"] == pytest.approx(rj["snr"], rel=1e-5)
    assert rt["sync"] == pytest.approx(rj["sync"], abs=SYNC_ATOL)


def test_decode_device_engines(frame, capsys):
    """The port's device and hybrid engines (no JAX counterpart run:
    tests/test_torch_decoder.py holds those engines to JAX) decode the same
    frame, and --passes 2 keeps one spot."""
    _, c2 = frame
    for extra in (["--engine", "device"], ["--engine", "hybrid"],
                  ["--engine", "device", "--passes", "2"]):
        capsys.readouterr()
        port("decode", c2, *extra)
        cap = capsys.readouterr()
        assert [SPOT.match(x).group(1) for x in cap.out.splitlines()] == [
            "K1ABC FN42 37"], extra
        assert f"({extra[1]} engine on cpu;" in cap.err


def test_wav_round_trip_matches_jax(frame, tmp_path, capsys):
    _, c2 = frame
    for run, tag in ((port, "t"), (jax, "j")):
        run("c2towav", c2, "-o", tmp_path / f"{tag}.wav", "--amplitude",
            "0.3")
        run("wavtoc2", tmp_path / f"{tag}.wav", "-o", tmp_path / f"{tag}.c2")
    assert ((tmp_path / "t.wav").read_bytes()
            == (tmp_path / "j.wav").read_bytes())
    zt = read_c2(tmp_path / "t.c2").samples
    zj = read_c2(tmp_path / "j.c2").samples
    assert zt.shape == zj.shape == (45000,)
    assert np.abs(zt - zj).max() <= 1e-5 * np.abs(zj).max()
    capsys.readouterr()
    port("decode", tmp_path / "t.wav")          # the default engine (host)
    assert "K1ABC FN42 37" in capsys.readouterr().out


@pytest.mark.parametrize("snr,channels,windows,duty",
                         [(-18.0, 4, 20, 0.3), (-25.0, 3, 7, 0.9)])
def test_synthetic_source_bitwise_equal(snr, channels, windows, duty):
    args = argparse.Namespace(snr=snr, channels=channels, windows=windows,
                              duty=duty)
    it, ij = {"sent": 0}, {"sent": 0}
    bt = list(tcli._synthetic_source(args, 3375, it))
    bj = list(jcli._synthetic_source(args, 3375, ij))
    assert len(bt) == len(bj) == windows
    for a, b in zip(bt, bj):
        assert a.dtype == b.dtype == np.complex64
        np.testing.assert_array_equal(a, b)
    assert it == ij and it["sent"] > 0


def test_sweep_trials_bitwise_equal(monkeypatch):
    """Each package's sweep hands its WindowDecoder the same windows for
    the same seed (no decode: a recorder stands in)."""
    seen = {"t": [], "j": []}

    def recorder(tag):
        class Recorder:
            def __init__(self, *a, **k):
                pass

            def __call__(self, z):
                seen[tag].append(np.array(z))
                return argparse.Namespace(spots=[])
        return Recorder
    monkeypatch.setattr(tsweep, "WindowDecoder", recorder("t"))
    monkeypatch.setattr(jsweep, "WindowDecoder", recorder("j"))
    whale = (np.random.default_rng(3).normal(size=20000)
             + 0j).astype(np.complex64)
    rt = tsweep.snr_sweep([-15.0, -21.0], trials=3, seed=7,
                          interference=whale, device="cpu")
    rj = jsweep.snr_sweep([-15.0, -21.0], trials=3, seed=7,
                          interference=whale)
    assert len(seen["t"]) == len(seen["j"]) == 6
    for a, b in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(a, b)
    assert rt.as_dict() == rj.as_dict() == {"-15": 0.0, "-21": 0.0}


def test_sweep_cli(capsys):
    port("sweep", "--snr", "-15", "-15", "1", "--trials", "2", "--engine",
         "device")
    doc = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert doc["decode_rate"] == {"-15": 1.0}
    assert (doc["engine"], doc["backend"], doc["trials"]) == ("device",
                                                              "cpu", 2)


def test_mesh_refused_with_the_queue_item(capsys):
    """--mesh runs since the multi-device queue item landed; it is refused
    only without a named backend, which nothing chooses for the caller."""
    with pytest.raises(SystemExit) as e:
        port("serve", "--mesh", "2x4")
    assert "--mesh needs --dist-backend: nccl" in str(e.value.code)


MESH_SERVE = ("--channels", "2", "--windows", "18", "--duty", "0.5",
              "--maxcycles", "50")


def test_serve_mesh_1x1_prints_the_python_runtime_spots(capsys):
    """A world of one over gloo on the synthetic source prints the spots of
    serve --runtime python with the same (hybrid) engine, one line per
    (channel, window) spot, and leaves no process group behind."""
    import torch.distributed as dist
    port("serve", "--mesh", "1x1", "--dist-backend", "gloo", *MESH_SERVE)
    mesh = capsys.readouterr()
    assert not dist.is_initialized()
    port("serve", "--runtime", "python", "--engine", "hybrid", *MESH_SERVE)
    single = capsys.readouterr()
    got = [re.sub(r"^(ch\d+) w\d+:", r"\1:", ln)
           for ln in mesh.out.splitlines()]
    assert got and sorted(got) == sorted(single.out.splitlines())
    assert re.search(r"# mesh 1x1 \(hybrid\): 2 steps, 10 windows, \d+ "
                     r"frames sent, 3 spots, \d+ window-samples/s", mesh.err)
    assert "# 10 windows" in single.err


def test_serve_mesh_reads_stdin_on_rank_0(monkeypatch, capsys):
    """--input - under --mesh: rank 0 reads cf32 from stdin and broadcasts
    each block (a world of one here); the frame's window decodes."""
    import io
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    z = np.concatenate([synthesize_frame("VE3EMB", "FN25", 30),
                        np.zeros(3375, np.complex64)])
    iq = np.stack([z.real, z.imag], axis=1).astype("<f4").tobytes()
    monkeypatch.setattr(sys, "stdin", argparse.Namespace(
        buffer=io.BytesIO(iq)))
    port("serve", "--mesh", "1x1", "--dist-backend", "gloo", "--input", "-",
         "--channels", "1", "--maxcycles", "50")
    cap = capsys.readouterr()
    assert "ch0 w0: VE3EMB FN25 30 (" in cap.out, cap.err
    assert "# mesh 1x1 (hybrid): 1 steps, 2 windows, 1 spots" in cap.err


def test_serve_mesh_needs_a_launcher(capsys):
    with pytest.raises(SystemExit) as e:
        port("serve", "--mesh", "2x1", "--dist-backend", "gloo")
    assert ("start it under a launcher, python -m torch.distributed.run "
            "--nproc-per-node 2" in str(e.value.code))


@pytest.mark.parametrize("argv,why", [
    (("--runtime", "native"), "drop --runtime native"),
    (("--passes", "2"), "drop it for --mesh")])
def test_serve_mesh_refuses_what_jax_refuses(argv, why, capsys):
    for run in (lambda: port("serve", "--mesh", "1x1", "--dist-backend",
                             "gloo", *argv),
                lambda: jax("serve", "--mesh", "1x1", *argv)):
        with pytest.raises(SystemExit) as e:
            run()
        assert why in str(e.value.code)


def test_default_device_needs_cuda(frame, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, c2 = frame
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        tcli.main(["decode", str(c2)])
    assert "torch.cuda.is_available() is False" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_audio_named_file_is_a_file(frame, tmp_path, monkeypatch, capsys):
    """``--input audio1.wav`` follows the file; only ``audio`` and
    ``audio:<dev>`` mean the soundcard (none here: exits naming the
    backends)."""
    _, c2 = frame
    monkeypatch.chdir(tmp_path)
    port("c2towav", c2, "-o", "audio1.wav")
    capsys.readouterr()
    port("serve", "--input", "audio1.wav", "--maxcycles", "300")
    cap = capsys.readouterr()
    assert "ch0: K1ABC FN42 37" in cap.out, cap.err
    assert "# 1 windows, 1 spots" in cap.err
    for name in ("audio", "audio:hw:1"):
        with pytest.raises(SystemExit) as e:
            port("serve", "--input", name)
        assert "arecord" in str(e.value.code)


def test_serve_ring_reports_shed_lanes(capsys):
    port("serve", "--runtime", "ring", "--channels", "2", "--windows", "16",
         "--maxcycles", "50", "--duty", "0.5")
    cap = capsys.readouterr()
    assert "ch0: VE3EMB FN25 30" in cap.out
    assert re.search(r"# 6 windows, 3 frames sent, \d+ spots, \d+ "
                     r"window-samples/s, \d+ lanes shed by the lane caps",
                     cap.err), cap.err


def test_cli_process_loads_no_jax(frame):
    """``python -m uwspr_tpu_torch.cli decode`` in a process of its own:
    -X importtime lists every module it imports; none is jax* or
    uwspr_tpu*."""
    _, c2 = frame
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "uwspr_tpu_torch.cli",
         "decode", str(c2), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(c2.parent),
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "K1ABC FN42 37" in proc.stdout
    mods = [ln.rsplit("|", 1)[1].strip() for ln in proc.stderr.splitlines()
            if ln.startswith("import time:") and "|" in ln]
    assert "uwspr_tpu_torch.frontend.downconvert" in mods
    leaked = [m for m in mods if m.split(".")[0].startswith("jax")
              or m.split(".")[0] == "uwspr_tpu"]
    assert leaked == []


@pytest.mark.parametrize("runtime, module, cls", [
    ("python", "uwspr_tpu_torch.pipeline.stream", "StreamDecoder"),
    ("ring", "uwspr_tpu_torch.pipeline.device_ring", "RingServe")])
def test_serve_osd_depth_reaches_the_runtime(runtime, module, cls,
                                             monkeypatch):
    """``serve --osd-depth`` (with ``--maxcycles``, the deep-SNR
    deployment's two settings) reaches the runtime's
    ``DemodConfig.osd_depth``; without it the depth stays 0."""
    import importlib

    class Seen(Exception):
        pass

    def record(config, *a, **k):
        raise Seen(config)
    monkeypatch.setattr(importlib.import_module(module), cls, record)
    for argv, depth, budget in (
            (("--osd-depth", "4", "--maxcycles", "500"), 4, 500),
            (("--maxcycles", "500"), 0, 500)):
        with pytest.raises(Seen) as e:
            port("serve", "--runtime", runtime, "--engine", "device", *argv)
        demod = e.value.args[0].demod
        assert (demod.osd_depth, demod.maxcycles) == (depth, budget)
