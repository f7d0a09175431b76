"""The port's DeviceDecoder against the JAX DeviceDecoder.

Scene: two windows under with_serving_defaults(PipelineConfig(demod=
DemodConfig(maxcycles=2000)), 2): one "VE3EMB FN25 30" frame at -18 dB and
one noise-only window, made with numpy from a seed; the paths without
compaction and the hybrid engine also take two windows that each hold a
frame. The JAX decoder runs on the CPU (its Fano through the
lax.while_loop path); the port runs on the CPU with its plain versions.

Tolerances: decoded messages, valid, success, fano_attempts and
fano_overflow equal; freq, shift, drift and mode equal on decoded
candidates; snr to 1e-4 relative and sync to 1e-3 absolute (f32 and bf16
sums taken in another order).
"""

import dataclasses as dc
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_copies import jax_config
from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder as JaxDecoder
from uwspr_tpu_torch import params
from uwspr_tpu_torch.config import (DemodConfig, PipelineConfig,
                                    with_serving_defaults)
from uwspr_tpu_torch.io.channel import awgn, noise_sigma
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = with_serving_defaults(PipelineConfig(demod=DemodConfig(maxcycles=2000)),
                            2)
STATE_ATTRS = {"offsets": "_offsets", "is_nl": "_is_nl",
               "model_drift": "_model_drift", "model_slm": "_model_slm",
               "sign": "_sign", "sync_bit": "_sync_bit", "mettab": "_mettab",
               "perm": "_perm", "jiggles": "_jiggles", "osd_G": "_osd_G"}


def scene(seed=0):
    rng = np.random.default_rng(seed)
    z = synthesize_frame("VE3EMB", "FN25", 30,
                         start_sample=int(rng.integers(0, 2000)),
                         freq_offset=float(rng.uniform(-5, 5)))
    sig = awgn(z, -18, rng=rng)
    s = noise_sigma(-18.0)
    noise = rng.normal(scale=s, size=45000) + 1j * rng.normal(scale=s,
                                                               size=45000)
    w = np.stack([sig, noise])
    return np.stack([w.real, w.imag], axis=1).astype(np.float32)


RI = scene()


@pytest.fixture(scope="module")
def jax_run():
    dec = JaxDecoder(jax_config(CFG))
    return dec, np.asarray(dec.decode_windows_ri(RI))


@pytest.fixture(scope="module")
def port_run():
    dec = DeviceDecoder(CFG, device="cpu")
    return dec, dec.decode_windows_ri(torch.from_numpy(RI)).numpy()


def test_slice_matches_jax(jax_run, port_run):
    jdec, ja = jax_run
    tdec, ta = port_run
    assert ta.shape == ja.shape == (2, tdec.n_cand, 23)
    assert np.isfinite(ta).all()
    j, t = jdec.unpack_output(ja), tdec.unpack_output(ta)
    for w in range(2):
        assert tdec.messages(t.window(w)) == jdec.messages(j.window(w))
    assert tdec.messages(t.window(0)) == ["VE3EMB FN25 30"]
    assert tdec.messages(t.window(1)) == []
    for key in ("valid", "success", "fano_attempts", "fano_overflow"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key),
                                      err_msg=key)
    s = j.success
    for key in ("freq", "shift", "drift", "mode", "payload", "jiggle"):
        np.testing.assert_array_equal(getattr(t, key)[s], getattr(j, key)[s],
                                      err_msg=key)
    v = j.valid
    np.testing.assert_allclose(t.snr[v], j.snr[v], rtol=1e-4)
    np.testing.assert_allclose(t.sync[s], j.sync[s], atol=1e-3)


def jax_state(jdec, cfg):
    return {k: np.asarray(getattr(jdec, STATE_ATTRS[k]))
            for k in params.state_keys(cfg)}


def test_state_carried_from_jax(jax_run, port_run, osd_runs):
    """The constants read off a JAX DeviceDecoder equal the port's own
    construction, and a decoder built from them decodes identically; with
    on-device OSD on, the state also carries the OSD generator matrix."""
    jdec, _ = jax_run
    tdec, ta = port_run
    d = jax_state(jdec, CFG)
    own = params.state_numpy(CFG)
    assert set(d) == set(own) and "osd_G" not in own
    for k in d:
        np.testing.assert_array_equal(d[k], own[k], err_msg=k)
    dec = DeviceDecoder(CFG, device="cpu", state=d)
    np.testing.assert_array_equal(
        dec.decode_windows_ri(torch.from_numpy(RI)).numpy(), ta)
    jo, to = osd_runs["jax_dec"], osd_runs["port_dec"]
    d = jax_state(jo, OSD_CFG)
    own = params.state_numpy(OSD_CFG)
    assert set(d) == set(own) and "osd_G" in own
    for k in d:
        np.testing.assert_array_equal(d[k], own[k], err_msg=k)
    dec = DeviceDecoder(OSD_CFG, device="cpu", state=d)
    np.testing.assert_array_equal(
        dec.decode_windows_ri(torch.from_numpy(OSD_RI)).numpy(),
        osd_runs["port_packed"])


def test_state_validation():
    d = params.state_numpy(CFG)
    with pytest.raises(ValueError, match="missing"):
        params.state_from_numpy({k: v for k, v in d.items() if k != "perm"},
                                "cpu")
    bad = dict(d, mettab=d["mettab"][:1])
    with pytest.raises(ValueError, match="mettab"):
        params.state_from_numpy(bad, "cpu")


def test_pack_roundtrip(port_run):
    tdec, ta = port_run
    out = tdec.unpack_output(ta)
    assert out.payload.shape == (2, tdec.n_cand, 7)
    assert out.fano_attempts.shape == (2,)
    assert (out.osd == 0).all()


@pytest.mark.parametrize("what", ["truncate"])
def test_outside_slice_raises(what):
    """truncate_stage is not ported (CUDA events split the stages)."""
    with pytest.raises(NotImplementedError):
        DeviceDecoder(CFG, device="cpu", truncate_stage="post_fano")


# ------------------------------------------------ paths without compaction
#
# The configurations that were outside the first slice, each against the JAX
# DeviceDecoder of the same config, at the tolerances of the module doc.

def two_frames(seed=3):
    """Two windows, each holding one "VE3EMB FN25 30" frame at -18 dB."""
    rng = np.random.default_rng(seed)
    wins = [awgn(synthesize_frame("VE3EMB", "FN25", 30,
                                  start_sample=int(rng.integers(0, 2000)),
                                  freq_offset=float(rng.uniform(-5, 5))),
                 -18, rng=rng) for _ in range(2)]
    w = np.stack(wins)
    return np.stack([w.real, w.imag], axis=1).astype(np.float32)


RI2 = two_frames()
PLAIN = PipelineConfig(demod=DemodConfig(maxcycles=2000))


def run_both(cfg, ri, fano_mode="device"):
    """(JAX typed output, port typed output, port decoder) on ``ri``."""
    jdec = JaxDecoder(jax_config(cfg), fano_mode=fano_mode)
    tdec = DeviceDecoder(cfg, device="cpu", fano_mode=fano_mode)
    return (jdec.decode_ri_batch(ri),
            tdec.decode_ri_batch(torch.from_numpy(ri)), tdec)


def assert_outputs_match(t, j, tdec):
    for w in range(t.success.shape[0]):
        assert ([s.message for s in tdec.spots(t.window(w))]
                == tdec.messages(j.window(w)))
    for key in ("valid", "success", "fano_attempts", "fano_overflow", "osd"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key),
                                      err_msg=key)
    s = j.success
    for key in ("freq", "shift", "drift", "mode", "payload", "jiggle"):
        np.testing.assert_array_equal(getattr(t, key)[s], getattr(j, key)[s],
                                      err_msg=key)
    v = j.valid
    np.testing.assert_allclose(t.snr[v], j.snr[v], rtol=1e-4)
    np.testing.assert_allclose(t.sync[s], j.sync[s], atol=1e-3)


@pytest.mark.parametrize("refine_max_lanes", [0, 1])
def test_no_cand_compaction_matches_jax(refine_max_lanes):
    """cand_compact_lanes == 0: every lane of both windows through the
    refinement; with refine_max_lanes = 1 the tail runs on one worth lane
    of the batch and the other window's is counted in fano_overflow."""
    cfg = dc.replace(PLAIN, demod=dc.replace(
        PLAIN.demod, refine_max_lanes=refine_max_lanes))
    j, t, tdec = run_both(cfg, RI2)
    assert_outputs_match(t, j, tdec)
    decoded = [len(tdec.messages(t.window(w))) for w in range(2)]
    if refine_max_lanes:
        assert decoded == [1, 0] and list(t.fano_overflow) == [0, 1]
    else:
        assert decoded == [1, 1] and not t.fano_overflow.any()


def test_per_window_fano_cap_matches_jax():
    """fano_compact_lanes == 0: at most fano_max_lanes gated lanes per
    window and phase. At maxcycles 1 every Fano lane times out, so phase 2
    gates the 16 jiggle retries of the signal window and the cap of 4
    leaves 12 of them in fano_overflow."""
    cfg = with_serving_defaults(PipelineConfig(
        demod=DemodConfig(maxcycles=1, fano_max_lanes=4)), 2)
    cfg = dc.replace(cfg, demod=dc.replace(cfg.demod, fano_compact_lanes=0))
    j, t, tdec = run_both(cfg, RI)
    assert_outputs_match(t, j, tdec)
    assert t.fano_overflow[0] > 0 and t.fano_attempts[0] > 4


@pytest.mark.parametrize("osd", [False, True], ids=["fano", "osd_depth_2"])
def test_hybrid_matches_jax(osd):
    """fano_mode "host": the packed prefano layout and the host assembly
    (native Fano). With osd_depth 2 at maxcycles 1 every Fano lane fails
    and the host OSD rescues the frame, tagged with its order."""
    cfg = CFG
    if osd:
        cfg = dc.replace(CFG, demod=dc.replace(CFG.demod, maxcycles=1,
                                               osd_depth=2))
    j, t, tdec = run_both(cfg, RI, fano_mode="host")
    assert_outputs_match(t, j, tdec)
    assert tdec.messages(t.window(0)) == ["VE3EMB FN25 30"]
    assert list(t.osd[0][t.success[0]]) == ([2] if osd else [0])
    packed = tdec.decode_windows_ri(torch.from_numpy(RI))
    J = cfg.demod.n_jiggles
    assert packed.shape == (2, tdec.n_cand, 11 + 2 * J + 162 * J + 1)


def test_spots_drop_osd_payload_that_fails_unpack(port_run):
    """A success tagged as OSD whose payload does not unpack is no spot;
    a Fano success keeps its spot whatever its payload."""
    tdec, ta = port_run
    out = tdec.unpack_output(ta).window(0)
    c = int(np.flatnonzero(out.success)[0])
    assert [s.message for s in tdec.spots(out)] == ["VE3EMB FN25 30"]
    bad = dc.replace(out, payload=out.payload.copy(), osd=out.osd.copy())
    bad.payload[c] = 255                     # a packed call out of range
    assert len(tdec.spots(bad)) == 1
    bad.osd[c] = 2
    assert tdec.spots(bad) == []


def test_pallas_stft_slice_matches_jax(jax_run, port_run):
    """stft_impl="pallas": the port's DeviceDecoder on the CPU (the STFT's
    plain version, matmul_bf16) against the JAX decoder with that config
    (its Pallas kernel in interpret mode): same messages, valid, success
    and fano_attempts; the packed output equals the port's default run,
    whose STFT has the same numerics."""
    from uwspr_tpu_torch.ops import stft
    cfg = dc.replace(CFG, coarse=dc.replace(CFG.coarse, stft_impl="pallas"))
    jdec = JaxDecoder(jax_config(cfg))
    j = jdec.unpack_output(np.asarray(jdec.decode_windows_ri(RI)))
    before = stft.PLAIN_CALLS
    tdec = DeviceDecoder(cfg, device="cpu")
    ta = tdec.decode_windows_ri(torch.from_numpy(RI)).numpy()
    assert stft.PLAIN_CALLS == before + 1
    t = tdec.unpack_output(ta)
    for w in range(2):
        assert tdec.messages(t.window(w)) == jdec.messages(j.window(w))
    assert tdec.messages(t.window(0)) == ["VE3EMB FN25 30"]
    for key in ("valid", "success", "fano_attempts"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key),
                                      err_msg=key)
    np.testing.assert_array_equal(ta, port_run[1])


# ------------------------------------------------------------ on-device OSD
#
# The scenes of tests/test_osd.py:184-222 at maxcycles 1 (every Fano lane
# fails) and 3 jiggles: the OSD rescues each frame, tagged with its order.
# Equal to the JAX DeviceDecoder per window (__call__) and batched: success,
# payload, osd, jiggle, fano_overflow and the rest of assert_outputs_match.

OSD_CFG = PipelineConfig(demod=DemodConfig(maxcycles=1, n_jiggles=3,
                                           osd_depth=2))
MSG = "VE3EMB FN25 30"


def osd_windows():
    rng = np.random.default_rng(22)
    return np.stack([
        awgn(synthesize_frame("VE3EMB", "FN25", 30, start_sample=300 * w,
                              freq_offset=float(w) - 1.0), -18.0, rng=rng)
        for w in range(3)])


OSD_Z = osd_windows()
OSD_RI = np.stack([OSD_Z.real, OSD_Z.imag], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def osd_runs():
    jdec = JaxDecoder(jax_config(OSD_CFG))
    tdec = DeviceDecoder(OSD_CFG, device="cpu")
    return {"jax_dec": jdec, "port_dec": tdec,
            "jax": jdec.decode_batch(OSD_Z),
            "port": tdec.decode_batch(OSD_Z),
            "port_packed": tdec.decode_windows_ri(
                torch.from_numpy(OSD_RI)).numpy()}


def as_batch(out):
    """One window's output as a batch of one."""
    return dc.replace(out, **{f.name: np.asarray(getattr(out, f.name))[None]
                              for f in dc.fields(out)})


def test_device_osd_batch_matches_jax(osd_runs):
    j, t, tdec = osd_runs["jax"], osd_runs["port"], osd_runs["port_dec"]
    assert_outputs_match(t, j, tdec)
    for w in range(3):
        by = {s.message: s for s in tdec.spots(t.window(w))}
        assert by[MSG].osd == 2
    assert (t.osd[t.success] == 2).all()


def test_device_osd_call_matches_jax(osd_runs):
    """The per-window program (tests/test_osd.py:184-202's window)."""
    rng = np.random.default_rng(21)
    z = awgn(synthesize_frame("VE3EMB", "FN25", 30, start_sample=500,
                              freq_offset=1.0), -18.0, rng=rng)
    j = osd_runs["jax_dec"](z)
    t = osd_runs["port_dec"](z)
    tdec = osd_runs["port_dec"]
    assert_outputs_match(as_batch(t), as_batch(j), tdec)
    assert [(s.message, s.osd) for s in tdec.spots(t)] == [(MSG, 2)]


def test_device_osd_lane_cap_matches_jax():
    """osd_max_lanes 1 over 3 windows: one lane of the batch is rescued,
    the other two failed lanes are dropped and counted in fano_overflow,
    as in the JAX decoder."""
    cfg = dc.replace(OSD_CFG, demod=dc.replace(OSD_CFG.demod,
                                               osd_max_lanes=1))
    j, t, tdec = run_both(cfg, OSD_RI)
    assert_outputs_match(t, j, tdec)
    assert int(t.fano_overflow.sum()) >= 2
    assert int((t.osd > 0).sum()) == 1


def test_device_osd_noise_window_yields_no_spots():
    """tests/test_osd.py:167-181: a noise-only window gives no spots."""
    rng = np.random.default_rng(33)
    sigma = noise_sigma(-14.0)
    z = (rng.normal(scale=sigma, size=45000)
         + 1j * rng.normal(scale=sigma, size=45000)).astype(np.complex64)
    cfg = PipelineConfig(demod=DemodConfig(maxcycles=64, n_jiggles=3,
                                           osd_depth=2))
    tdec = DeviceDecoder(cfg, device="cpu")
    assert tdec.spots(tdec(z)) == []


def test_call_runs_the_per_window_program():
    """__call__ ignores the batch knobs and caps each Fano phase at
    fano_max_lanes, as the JAX __call__ does: at maxcycles 1 the signal
    window gates 16 jiggle retries, 4 are decoded and 12 are counted in
    fano_overflow, while the batch path (cand_compact_lanes 1, never-drop
    Fano chunks) drops no Fano lane."""
    cfg = PipelineConfig(demod=DemodConfig(
        maxcycles=1, fano_max_lanes=4, fano_compact_lanes=8,
        cand_compact_lanes=1, refine_max_lanes=1))
    z = RI[0, 0] + 1j * RI[0, 1]
    jdec = JaxDecoder(jax_config(cfg))
    tdec = DeviceDecoder(cfg, device="cpu")
    j, t = jdec(z), tdec(z)
    assert_outputs_match(as_batch(t), as_batch(j), tdec)
    assert int(t.fano_overflow) == 12 and int(t.fano_attempts) > 4
    b = tdec.decode_batch(z[None]).window(0)
    assert int(b.fano_overflow) == 0
    assert tdec.config.demod.cand_compact_lanes == 1


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceDecoder(CFG, device="cuda")


_NO_JAX = r"""
import importlib, os, pkgutil, sys
import numpy as np
import torch
import uwspr_tpu_torch
jax_pkg = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(uwspr_tpu_torch.__file__))), "uwspr_tpu") + os.sep
opened = []

def audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        path = os.path.abspath(os.fsdecode(args[0]))
        if path.startswith(jax_pkg):
            opened.append(path)
sys.addaudithook(audit)
for m in pkgutil.walk_packages(uwspr_tpu_torch.__path__, "uwspr_tpu_torch."):
    importlib.import_module(m.name)
from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig, PipelineConfig,
                                    with_serving_defaults)
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
ri = np.load(sys.argv[1])
cfg = with_serving_defaults(PipelineConfig(demod=DemodConfig(maxcycles=200)), 2)
dec = DeviceDecoder(cfg, device="cpu")
out = dec.unpack_output(dec.decode_windows_ri(torch.from_numpy(ri)))
print(dec.messages(out.window(0)))
from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
z = ri[0, 0] + 1j * ri[0, 1]
host = WindowDecoder(PipelineConfig(coarse=CoarseConfig(maxfreqs=13),
                                    demod=DemodConfig(maxcycles=300)),
                     device="cpu")
print("host", [s.message for s in host(z).spots])   # native Fano backend
from uwspr_tpu_torch.pipeline.device_ring import RingServe
from uwspr_tpu_torch.pipeline.stream import StreamDecoder
pad = np.zeros(2250, np.complex64)
plain = PipelineConfig(demod=DemodConfig(maxcycles=200))
ring = RingServe(plain, device="cpu")           # windows end on hop edges
print("ring", [s.message for _, r in ring.push(np.concatenate([pad, z]))
               for s in r.spots])
sd = StreamDecoder(plain, engine="device", device="cpu")
print("stream", [s.message for _, r in sd.push(np.concatenate([z, pad]))
                 for s in r.spots])
osd = DeviceDecoder(PipelineConfig(demod=DemodConfig(
    maxcycles=1, n_jiggles=3, osd_depth=2)), device="cpu")  # device OSD
print("osd", [(s.message, s.osd) for s in osd.spots(osd(z))])
wide = DeviceDecoder(PipelineConfig(
    coarse=CoarseConfig(halfbandwidth=187, maxfreqs=16),
    demod=DemodConfig(maxcycles=200, n_jiggles=3)), device="cpu")
print("wideband", wide.messages(wide(z)))
mp = StreamDecoder(plain, engine="device", passes=2, device="cpu")
print("passes", [(s.message, s.pass_index)
                 for _, r in mp.push(np.concatenate([z, pad]))
                 for s in r.spots])
import tempfile
import torch.distributed as dist
from uwspr_tpu_torch.parallel.distributed import global_mesh, initialize
from uwspr_tpu_torch.parallel.mesh import ShardedStreamDecoder
with tempfile.TemporaryDirectory() as d:         # a world of one, gloo
    initialize("gloo", init_method=f"file://{d}/store", world_size=1, rank=0)
    msd = ShardedStreamDecoder(plain, global_mesh(1, 1, "cpu"))
    print("mesh", [(w, s.message) for _, w, s in
                   msd.push(np.concatenate([z, pad])) + msd.flush()])
    dist.destroy_process_group()
from uwspr_tpu_torch.harness import common, scenes, sweeps
rates = common.load_record(sweeps.REFERENCE)["curves"]["device_serving"]
print("harness", common.vs_reference({"-29": 0.86}, rates["decode_rate"],
                                     "device_serving", 50)["pass"],
      scenes.bench_windows(1)[1])
leaked = sorted(m for m in sys.modules if m.startswith("jax")
                or m == "uwspr_tpu" or m.startswith("uwspr_tpu."))
assert not leaked, leaked
assert not opened, opened
print("NO_JAX_OK")
"""


def test_port_never_imports_jax(tmp_path):
    np.save(tmp_path / "ri.npy", RI)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX,
                           str(tmp_path / "ri.npy")], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_JAX_OK" in proc.stdout
    assert "VE3EMB FN25 30" in proc.stdout
    assert "host ['VE3EMB FN25 30']" in proc.stdout
    assert "ring ['VE3EMB FN25 30']" in proc.stdout
    assert "stream ['VE3EMB FN25 30']" in proc.stdout
    assert "osd [('VE3EMB FN25 30', 2)]" in proc.stdout
    assert "wideband ['VE3EMB FN25 30']" in proc.stdout
    assert "passes [('VE3EMB FN25 30', 0)]" in proc.stdout
    assert "mesh [(0, 'VE3EMB FN25 30')]" in proc.stdout
    assert "harness True ['VE3EMB FN25 30']" in proc.stdout


def test_entry_points_take_only_port_configs():
    jcfg = jax_config(CFG)
    with pytest.raises(TypeError, match="uwspr_tpu_torch.config"):
        DeviceDecoder(jcfg, device="cpu")
    from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
    with pytest.raises(TypeError, match="uwspr_tpu_torch.config"):
        WindowDecoder(jcfg, device="cpu")
