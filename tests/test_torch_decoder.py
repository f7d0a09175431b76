"""The port's serving slice against the JAX DeviceDecoder.

Scene: two windows under with_serving_defaults(PipelineConfig(demod=
DemodConfig(maxcycles=2000)), 2): one "VE3EMB FN25 30" frame at -18 dB and
one noise-only window, made with numpy from a seed. The JAX decoder runs on
the CPU (its Fano through the lax.while_loop path); the port runs on the CPU
with its plain versions.

Tolerances: decoded messages, valid, success, fano_attempts and
fano_overflow equal; freq, shift, drift and mode equal on decoded
candidates; snr to 1e-4 relative and sync to 1e-3 absolute (f32 and bf16
sums taken in another order).
"""

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
from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig, PipelineConfig,
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
               "perm": "_perm", "jiggles": "_jiggles"}


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


def test_state_carried_from_jax(jax_run, port_run):
    """The constants read off a JAX DeviceDecoder equal the port's own
    construction, and a decoder built from them decodes identically."""
    jdec, _ = jax_run
    tdec, ta = port_run
    d = {k: np.asarray(getattr(jdec, a)) for k, a in STATE_ATTRS.items()}
    own = params.state_numpy(CFG)
    for k in params.STATE_SPEC:
        np.testing.assert_array_equal(d[k], own[k], err_msg=k)
    dec = DeviceDecoder(CFG, device="cpu", state=d)
    np.testing.assert_array_equal(
        dec.decode_windows_ri(torch.from_numpy(RI)).numpy(), ta)


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


@pytest.mark.parametrize("what", ["no_cand_compaction", "no_fano_compaction",
                                  "wideband", "einsum_grid", "osd",
                                  "host_fano", "truncate"])
def test_outside_slice_raises(what):
    cfg, kw = CFG, {}
    d, c = CFG.demod, CFG.coarse
    import dataclasses as dc
    if what == "no_cand_compaction":
        cfg = PipelineConfig()
    elif what == "no_fano_compaction":
        cfg = dc.replace(CFG, demod=dc.replace(d, fano_compact_lanes=0))
    elif what == "wideband":
        cfg = with_serving_defaults(
            PipelineConfig(coarse=CoarseConfig(halfbandwidth=187)), 2)
    elif what == "einsum_grid":
        cfg = dc.replace(CFG, coarse=dc.replace(c, grid_impl="einsum"))
    elif what == "osd":
        cfg = dc.replace(CFG, demod=dc.replace(d, osd_depth=2))
    elif what == "host_fano":
        kw = {"fano_mode": "host"}
    else:
        kw = {"truncate_stage": "post_fano"}
    with pytest.raises(NotImplementedError):
        DeviceDecoder(cfg, device="cpu", **kw)


def test_pallas_stft_slice_matches_jax(jax_run, port_run):
    """stft_impl="pallas": the port's DeviceDecoder on the CPU (the STFT's
    plain version, matmul_bf16) against the JAX decoder with that config
    (its Pallas kernel in interpret mode): same messages, valid, success
    and fano_attempts; the packed output equals the port's default run,
    whose STFT has the same numerics."""
    import dataclasses as dc

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


def test_entry_points_take_only_port_configs():
    jcfg = jax_config(CFG)
    with pytest.raises(TypeError, match="uwspr_tpu_torch.config"):
        DeviceDecoder(jcfg, device="cpu")
    from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
    with pytest.raises(TypeError, match="uwspr_tpu_torch.config"):
        WindowDecoder(jcfg, device="cpu")
