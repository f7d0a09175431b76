"""The port's multipass cancellation (pipeline/multipass.py) and
StreamDecoder(passes > 1) against the JAX package's.

Scenes, made with numpy from a seed: tests/test_multipass.py's
``_masked_scene(seed=100)`` (a strong "VE3EMB FN25 30" at 0 Hz and a weak
"K1ABC FN42 37" 1.5 Hz away, 9 dB down, at -13 dB), a clean frame at
-15 dB, and one frame at -18 dB. The decoders run on the CPU at maxcycles
2000 (the port's kernels through their plain versions).

Tolerances: the subtracted window within 1e-6 of the largest sample of
the JAX module's (both are numpy; the port's copy is the same code, so it
comes out equal); channel symbols, drift offsets and lags equal; spots
equal in message and pass_index.
"""

import numpy as np
import pytest

import uwspr_tpu.pipeline.multipass as jmp
import uwspr_tpu.pipeline.stream as jstream
from test_multipass import STRONG, WEAK, _masked_scene
from test_torch_copies import jax_config
from uwspr_tpu.pipeline.decoder import WindowDecoder as JaxWindowDecoder
from uwspr_tpu_torch.config import DemodConfig, PipelineConfig
from uwspr_tpu_torch.demod.finesync import jiggle_offsets
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.pipeline import multipass as tmp
from uwspr_tpu_torch.pipeline.decoder import Spot, WindowDecoder
from uwspr_tpu_torch.pipeline.stream import StreamDecoder
from uwspr_tpu_torch.protocol.messages import pack_message
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

CFG = PipelineConfig(demod=DemodConfig(maxcycles=2000))
MASKED = _masked_scene(seed=100)


@pytest.fixture(scope="module")
def host():
    return WindowDecoder(CFG, device="cpu")


def spot(**kw):
    base = dict(message=STRONG[3],
                payload=bytes(pack_message(*STRONG[:3])[:7]), freq=1.2,
                snr=0.0, sync=0.5, shift=752, drift=0.0, mode=0, jiggle=0)
    return Spot(**{**base, **kw})


def test_helpers_match_jax():
    lin = spot(drift=1.5, jiggle=3)
    nl = spot(mode=1, slm_params=(1.0, -2.0, 0.0, 250.0), jiggle=5)
    for s in (lin, nl):
        np.testing.assert_array_equal(tmp.spot_channel_symbols(s.payload),
                                      jmp.spot_channel_symbols(s.payload))
        np.testing.assert_array_equal(tmp.spot_drift_offsets(s, 1500.0),
                                      jmp.spot_drift_offsets(s, 1500.0))
        assert tmp.spot_lag(s, CFG) == jmp.spot_lag(s, jax_config(CFG))
    assert tmp.spot_lag(lin, CFG) == 752 + int(jiggle_offsets(4, 8)[3])


def test_subtract_spot_matches_jax(host):
    """A decoded clean frame (tests/test_multipass.py:33-45): the port's
    subtraction equals the JAX module's and cancels the frame below
    -18 dB."""
    clean = synthesize_frame(*STRONG[:3], start_sample=750, freq_offset=1.23)
    noisy = awgn(clean, -15, rng=np.random.default_rng(0))
    spots = host(noisy).spots
    assert [s.message for s in spots] == [STRONG[3]]
    t = tmp.subtract_spot(noisy, spots[0], CFG)
    j = jmp.subtract_spot(noisy, spots[0], jax_config(CFG))
    assert t.dtype == j.dtype == np.complex64
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=1e-6 * float(np.abs(j).max()))
    residual = t - (noisy - clean)
    depth_db = 10 * np.log10(np.mean(np.abs(residual) ** 2)
                             / np.mean(np.abs(clean) ** 2))
    assert depth_db < -18.0, depth_db
    # a hand-made nonlinear spot goes through the SLM branch alike
    nl = spot(mode=1, slm_params=(1.0, -2.0, 0.0, 250.0))
    np.testing.assert_allclose(tmp.subtract_spot(noisy, nl, CFG),
                               jmp.subtract_spot(noisy, nl, jax_config(CFG)),
                               rtol=0, atol=1e-6 * float(np.abs(j).max()))


def test_multipass_unmasks_weak_cochannel_signal(host):
    spots = tmp.multipass_spots(MASKED, lambda w: host(w).spots, CFG,
                                passes=2)
    got = [(s.message, s.pass_index) for s in spots]
    assert got == [(STRONG[3], 0), (WEAK[3], 1)]
    jdec = JaxWindowDecoder(jax_config(CFG))
    jspots = jmp.multipass_spots(MASKED, lambda w: jdec(w).spots,
                                 jax_config(CFG), passes=2)
    assert [(s.message, s.pass_index) for s in jspots] == got
    assert tmp.multipass_spots(MASKED, lambda w: host(w).spots, CFG,
                               passes=1)[0].message == STRONG[3]


def test_multipass_single_signal_no_duplicates(host):
    rng = np.random.default_rng(7)
    z = awgn(synthesize_frame(*STRONG[:3], start_sample=1200,
                              freq_offset=-2.0), -18, rng=rng)
    spots = tmp.multipass_spots(z, lambda w: host(w).spots, CFG, passes=3)
    assert [(s.message, s.pass_index) for s in spots] == [(STRONG[3], 0)]


@pytest.mark.parametrize("engine", ["host", "device", "hybrid"])
def test_stream_decoder_passes(engine):
    """StreamDecoder(passes=2) finds the weak frame in pass 1, passes=1
    misses it; candidates are the most of any pass and Fano attempts the
    sum over passes. The host engine equals the JAX StreamDecoder's."""
    one = StreamDecoder(CFG, engine=engine, device="cpu").push(MASKED)
    two = StreamDecoder(CFG, engine=engine, passes=2,
                        device="cpu").push(MASKED)
    assert [[s.message for s in r.spots] for _, r in one] == [[STRONG[3]]]
    (_, r1), = one
    (_, r2), = two
    assert [(s.message, s.pass_index) for s in r2.spots] == [
        (STRONG[3], 0), (WEAK[3], 1)]
    assert r2.n_candidates >= r1.n_candidates
    assert r2.n_fano_attempts > r1.n_fano_attempts
    if engine == "host":
        (_, rj), = jstream.StreamDecoder(jax_config(CFG), engine="host",
                                         passes=2).push(MASKED)
        assert ([(s.message, s.pass_index) for s in rj.spots]
                == [(s.message, s.pass_index) for s in r2.spots])
        assert (rj.n_candidates, rj.n_fano_attempts) == (
            r2.n_candidates, r2.n_fano_attempts)
