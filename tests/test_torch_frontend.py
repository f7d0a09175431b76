"""The port's front end (``uwspr_tpu_torch.frontend.downconvert``) against
the JAX package's.

Signals are made with numpy from a seed: a noisy 1502.3 Hz tone, a frame
upconverted to 12 kS/s, and a length that is not a multiple of the
decimation. ``Downconverter`` runs the mix and the strided FIR with torch
on the CPU; the JAX one runs ``_mix_and_decimate`` (XLA on the CPU).

Tolerances: the two are f32 sums of 257 products in another order, so the
outputs agree to within 1e-5 of the JAX output's peak magnitude, with the
same length. ``StreamingDownconverter`` and ``upconvert`` are the same numpy
code in both packages and must be bitwise equal.
"""

import numpy as np
import pytest

from uwspr_tpu.frontend import downconvert as jdc
from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig, FrontendConfig,
                                    PipelineConfig)
from uwspr_tpu_torch.frontend import downconvert as tdc
from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

PEAK_RTOL = 1e-5
SMALL = PipelineConfig(coarse=CoarseConfig(maxfreqs=13),
                       demod=DemodConfig(maxcycles=300))


def _tone():
    rng = np.random.default_rng(0)
    t = np.arange(12000 * 20)
    return (np.cos(2 * np.pi * 1502.3 * t / 12000.0)
            + 0.1 * rng.normal(size=len(t))).astype(np.float32)


def _frame():
    return tdc.upconvert(synthesize_frame("VE3EMB", "FN25", 30,
                                          start_sample=900, freq_offset=2.5))


SIGNALS = {"tone": _tone, "frame": _frame,
           "ragged": lambda: _tone()[:12037]}


@pytest.mark.parametrize("name", list(SIGNALS))
def test_downconverter_matches_jax(name):
    audio = SIGNALS[name]()
    want = jdc.Downconverter()(audio)
    got = tdc.Downconverter(device="cpu")(audio)
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert len(got) == len(audio) // 32
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= PEAK_RTOL * peak


def test_downconverter_other_band_matches_jax():
    """A non-default band centre goes through the same float64 mixer."""
    from test_torch_copies import jax_config
    cfg = FrontendConfig(center_freq=1400.0)
    jcfg = jax_config(PipelineConfig(frontend=cfg)).frontend
    audio = _tone()
    want = jdc.downconvert(audio, jcfg)
    got = tdc.downconvert(audio, cfg, device="cpu")
    assert np.abs(got - want).max() <= PEAK_RTOL * np.abs(want).max()


def test_streaming_and_upconvert_bitwise_equal():
    audio = _tone()
    sj, st = jdc.StreamingDownconverter(), tdc.StreamingDownconverter()
    pos = 0
    for chunk in (1000, 37, 26000, 12345, 5, len(audio)):
        end = min(pos + chunk, len(audio))
        np.testing.assert_array_equal(st.push(audio[pos:end]),
                                      sj.push(audio[pos:end]))
        pos = end
    z = synthesize_frame("K1ABC", "FN42", 37, freq_offset=-1.5)
    np.testing.assert_array_equal(tdc.upconvert(z), jdc.upconvert(z))
    np.testing.assert_array_equal(tdc.upconvert(z, amplitude=0.3),
                                  jdc.upconvert(z, amplitude=0.3))
    np.testing.assert_array_equal(tdc.design_lowpass(257, 100.0, 12000.0),
                                  jdc.design_lowpass(257, 100.0, 12000.0))


def test_streaming_matches_oneshot():
    """The port's block-wise path equals its one-shot Downconverter up to
    the FIR's group delay (tests/test_live_io.py's tolerance)."""
    audio = _tone()[:12000 * 4]
    ref = tdc.Downconverter(device="cpu")(audio)
    sdc = tdc.StreamingDownconverter()
    got = np.concatenate([sdc.push(audio[i:i + 7001])
                          for i in range(0, len(audio), 7001)])
    delay = (len(sdc.taps) // 2) // sdc.cfg.decimation
    n = len(ref) - delay
    assert len(got) == len(ref)
    np.testing.assert_allclose(got[delay:delay + n], ref[:n], rtol=0,
                               atol=2e-3)


def test_downconverted_frame_decodes():
    z = tdc.downconvert(_frame(), device="cpu")
    spots = WindowDecoder(SMALL, device="cpu")(z[:45000]).spots
    assert [s.message for s in spots] == ["VE3EMB FN25 30"]
    assert spots[0].freq == pytest.approx(2.5, abs=0.1)


def test_downconverter_refuses_missing_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdc.Downconverter(device="cuda")
