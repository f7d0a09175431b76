"""The port's host engine (``uwspr_tpu_torch.pipeline.decoder``) against the
JAX ``WindowDecoder``.

Scenes are those of tests/test_pipeline.py, made with numpy from a seed:
one frame at -18 dB, two frames at -14 dB, and noise. Both packages run on
the CPU with ``CoarseConfig(maxfreqs=13)`` (narrowband has at most 13
peaks, so the semantics are those of the default 200 lanes) and toy Fano
budgets. The port runs its plain versions.

Tolerances: messages, payloads, candidate, jiggle, shift, mode, drift and
the stage counts are equal; the refined frequency is picked from the same
f32 grid, so it is equal too; sync scores, ratios of f32 sums taken in
another order, to 1e-5; u8 soft symbols from f32 tone powers may differ by
1 where a scaled value sits within ulps of an integer, in at most 0.1% of
the entries; rms, a mean over those symbols, to 1e-2.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from test_torch_copies import jax_config
from uwspr_tpu.pipeline import decoder as jdecoder
from uwspr_tpu_torch import params
from uwspr_tpu_torch.config import CoarseConfig, DemodConfig, PipelineConfig
from uwspr_tpu_torch.fec.host import fano_decode_batch_host
from uwspr_tpu_torch.io.c2file import write_c2
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.pipeline import decoder as tdecoder
from uwspr_tpu_torch.protocol.constants import deinterleave
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

COARSE = CoarseConfig(maxfreqs=13)
CFG = PipelineConfig(coarse=COARSE, demod=DemodConfig(maxcycles=2000))
SYNC_ATOL = 1e-5


def _scenes():
    one = awgn(synthesize_frame("K1ABC", "EM79", 37, start_sample=1200,
                                freq_offset=2.5),
               -18.0, rng=np.random.default_rng(5))
    two = awgn(synthesize_frame("K1ABC", "EM79", 37, start_sample=900,
                                freq_offset=3.0)
               + synthesize_frame("VE3EMB", "FN25", 30, start_sample=2000,
                                  freq_offset=-5.5),
               -14.0, rng=np.random.default_rng(6))
    rng = np.random.default_rng(9)
    noise = (0.1 * (rng.normal(size=45000) + 1j * rng.normal(size=45000))
             ).astype(np.complex64)
    return {"one": one, "two": two, "noise": noise}


SCENES = _scenes()
EXPECTED = {"one": ["K1ABC EM79 37"],
            "two": ["K1ABC EM79 37", "VE3EMB FN25 30"], "noise": []}


@pytest.fixture(scope="module")
def jax_dec():
    return jdecoder.WindowDecoder(jax_config(CFG))


@pytest.fixture(scope="module")
def port_dec():
    return tdecoder.WindowDecoder(CFG, device="cpu")


def _spots_match(got, ref):
    assert [s.message for s in got.spots] == [s.message for s in ref.spots]
    for key in ("n_candidates", "n_worth_a_try", "n_fano_attempts"):
        assert getattr(got, key) == getattr(ref, key), key
    for a, b in zip(got.spots, ref.spots):
        for f in ("payload", "candidate", "jiggle", "shift", "mode", "drift",
                  "slm_params", "freq", "fano_metric", "fano_cycles", "osd"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.snr == pytest.approx(b.snr, rel=1e-5)
        assert a.sync == pytest.approx(b.sync, abs=SYNC_ATOL)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_window_decoder_matches_jax(name, jax_dec, port_dec):
    ref = jax_dec(SCENES[name])
    got = port_dec(SCENES[name])
    assert sorted(s.message for s in got.spots) == EXPECTED[name]
    _spots_match(got, ref)


@pytest.mark.parametrize("name", ["one", "two"])
def test_fine_sync_matches_jax(name, jax_dec, port_dec):
    """Refined fields and soft symbols from the same candidates."""
    z = SCENES[name]
    cands = jax_dec.coarse(z)
    rj = jax_dec.fine.refine(z, cands)
    rt = port_dec.fine.refine(z, cands)
    for f in ("freq", "shift", "drift", "worth_a_try"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f),
                                      err_msg=f)
    np.testing.assert_allclose(rt.sync, rj.sync, atol=SYNC_ATOL)
    sj, syj, rmsj = jax_dec.fine.soft_symbols(z, cands, rj)
    st, syt, rmst = port_dec.fine.soft_symbols(z, cands, rj)
    assert st.shape == sj.shape == (13, 17, 162) and st.dtype == np.uint8
    d = np.abs(st.astype(np.int16) - sj.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    np.testing.assert_allclose(syt, syj, atol=SYNC_ATOL)
    np.testing.assert_allclose(rmst, rmsj, atol=1e-2)
    np.testing.assert_array_equal(port_dec.fine.jiggle_offsets(),
                                  jax_dec.fine.jiggle_offsets())


def _gated_lanes(port_dec):
    """The deinterleaved soft symbols of scene "two"'s first candidates,
    plus two noise lanes, as the decoder hands them to the Fano stage."""
    z = SCENES["two"]
    cands = port_dec.coarse(z)
    ref = port_dec.fine.refine(z, cands)
    syms, _, _ = port_dec.fine.soft_symbols(z, cands, ref)
    lanes = deinterleave(syms[:2, :3].reshape(-1, 162))
    noise = np.random.default_rng(2).integers(0, 256, (2, 162))
    return np.concatenate([lanes, noise.astype(np.uint8)])


def test_fano_backends_agree(port_dec):
    """native, the port's batched decoder ("jax", plain on the CPU) and the
    pure-Python reference: bit-exact, inactive lanes zero; and equal to the
    JAX package's own dispatcher."""
    from uwspr_tpu.fec import fano_decode_batch as jax_fano
    lanes = _gated_lanes(port_dec)
    active = np.ones(len(lanes), bool)
    active[1] = False
    outs = {b: fano_decode_batch_host(lanes, active, backend=b,
                                      device="cpu", maxcycles=150)
            for b in ("native", "jax", "ref")}
    ref = jax_fano(lanes, active=active, backend="native", maxcycles=150)
    assert outs["native"][0].any() and not outs["native"][0].all()
    for b, out in outs.items():
        for x, y in zip(out, ref):
            np.testing.assert_array_equal(x, y, err_msg=b)
    assert not outs["jax"][0][1] and not outs["jax"][1][1].any()
    with pytest.raises(ValueError, match="fano backend"):
        fano_decode_batch_host(lanes, backend="fast", device="cpu")


@pytest.mark.parametrize("backend", ["jax", "ref"])
def test_window_decoder_backends_give_same_spots(backend, port_dec):
    cfg = dataclasses.replace(CFG, fano_backend=backend)
    got = tdecoder.WindowDecoder(cfg, device="cpu")(SCENES["one"])
    _spots_match(got, port_dec(SCENES["one"]))


def test_osd_fallback_matches_jax():
    """tests/test_osd.py's crippled-Fano scene: every Fano retry fails
    (maxcycles 1) and the OSD rescues the frame, as in the JAX engine."""
    cfg = PipelineConfig(coarse=COARSE, demod=DemodConfig(
        maxcycles=1, n_jiggles=3, osd_depth=2))
    z = awgn(synthesize_frame("VE3EMB", "FN25", 30, start_sample=500,
                              freq_offset=1.0), -18.0,
             rng=np.random.default_rng(21))
    ref = jdecoder.WindowDecoder(jax_config(cfg))(z)
    got = tdecoder.WindowDecoder(cfg, device="cpu")(z)
    assert "VE3EMB FN25 30" in [s.message for s in got.spots]
    assert all(s.osd == 2 for s in got.spots)
    _spots_match(got, ref)


def test_decode_c2_file_roundtrip(tmp_path):
    z = synthesize_frame("K1ABC", "EM79", 37, start_sample=750,
                         freq_offset=1.0)
    p = tmp_path / "t.c2"
    write_c2(p, z, name="test")
    got = tdecoder.decode_c2_file(p, CFG, device="cpu")
    assert "K1ABC EM79 37" in [s.message for s in got.spots]
    _spots_match(got, jdecoder.decode_c2_file(p, jax_config(CFG)))


def test_state_read_off_jax_decodes_identically(jax_dec, port_dec):
    d = params.host_state_of(jax_dec.coarse, jax_dec.fine)
    own = params.host_state_numpy(CFG)
    assert set(d) == set(own) == set(params.HOST_STATE_KEYS)
    for k in own:
        np.testing.assert_array_equal(d[k], own[k], err_msg=k)
    dec = tdecoder.WindowDecoder(CFG, device="cpu", state=d)
    _spots_match(dec(SCENES["two"]), port_dec(SCENES["two"]))
    bad = dict(d, jiggles=d["jiggles"][:3])
    with pytest.raises(ValueError, match="jiggles"):
        tdecoder.WindowDecoder(CFG, device="cpu", state=bad)
    with pytest.raises(ValueError, match="missing"):
        tdecoder.WindowDecoder(CFG, device="cpu", state={
            k: v for k, v in d.items() if k != "is_nl"})


def test_result_types_and_timers_match_jax(port_dec):
    for a, b in ((tdecoder.Spot, jdecoder.Spot),
                 (tdecoder.DecodeResult, jdecoder.DecodeResult)):
        assert ([f.name for f in dataclasses.fields(a)]
                == [f.name for f in dataclasses.fields(b)])
    port_dec(SCENES["one"])
    assert set(port_dec.timers.summary()) == {"coarse", "finesync",
                                              "soft_symbols", "fano"}


def test_bad_config_raises():
    with pytest.raises(ValueError, match="fano backend"):
        tdecoder.WindowDecoder(dataclasses.replace(CFG, fano_backend="x"),
                               device="cpu")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdecoder.WindowDecoder(CFG, device="cuda")


def test_native_loader_builds_into_the_port_build_dir():
    """The native Fano library is built from the port's own fano_native.cc
    into the port's build directory, never beside the source."""
    from uwspr_tpu_torch.fec import host
    from uwspr_tpu_torch.utils import cuda_build
    lib = pathlib.Path(host.load_native_fano()._name)
    assert lib.parent == cuda_build.BUILD_DIR
    assert lib.parent != host.NATIVE_SOURCE.parent
    assert host.NATIVE_SOURCE.parent == pathlib.Path(host.__file__).parent
