"""The wideband grid (the upstream GNU Radio block's default halfbandwidth
187, hpbm 256: the whole 512-bin spectrum) in the port's DeviceDecoder
against the JAX DeviceDecoder.

Scene: tests/test_wideband.py's frames, "K1ABC FN42 37" at +80 and -150 Hz
at -18 dB (seed 0), one per window, decoded as one batch of two windows at
CoarseConfig(halfbandwidth=187, maxfreqs=32), maxcycles 200 and 3 jiggles;
both on the CPU (the port with its kernels' plain versions).

- grid_dtype "auto" resolves to bf16 planes, as where the JAX program
  takes the im2col einsum (f32 sums of bf16-rounded planes), and
  grid_dtype "f32" is honoured:
  messages, valid, success, fano counters, and on valid lanes the coarse
  selection (freq, shift, drift, mode of the selected model) equal; the
  decoded candidates' refined fields equal as in test_torch_decoder.py.
- coarse_score_grid(dtype="bf16", f_window=(-7, 519)) on one spectrum
  against the JAX function's einsum form, with candidate bins at both
  edges of the spectrum and a padded lane (bin 511, whose columns run past
  the top): within 1e-5 absolute (sums of 162 terms taken in another
  order; the grid is a ratio in [-1, 1]), NaN at the same cells; and
  sync_grid_plain (the card kernel's arithmetic) on the same lanes, f32
  and bf16 planes, against the JAX grid and coarse_score_grid to the same
  tolerance.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_copies import jax_config
from test_torch_decoder import assert_outputs_match
from uwspr_tpu.coarse.search import coarse_score_grid as jax_grid
from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder as JaxDecoder
from uwspr_tpu_torch import params
from uwspr_tpu_torch.coarse.search import (coarse_score_grid,
                                           grid_columns, sync_grid_plain)
from uwspr_tpu_torch.config import CoarseConfig, DemodConfig, PipelineConfig
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.ops.stft import stft_power
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

WIDEBAND = CoarseConfig(halfbandwidth=187, maxfreqs=32)
CFG = PipelineConfig(coarse=WIDEBAND,
                     demod=DemodConfig(maxcycles=200, n_jiggles=3))
MSG = "K1ABC FN42 37"


def windows():
    rng = np.random.default_rng(0)
    return np.stack([awgn(synthesize_frame("K1ABC", "FN42", 37,
                                           start_sample=700, freq_offset=f),
                          -18, rng=rng) for f in (80.0, -150.0)])


Z = windows()
RI = np.stack([Z.real, Z.imag], axis=1).astype(np.float32)


def coarse_fields(dec, z, jax_side):
    """The coarse stage of each window (peaks and the selected model)."""
    if jax_side:
        f = jax.jit(dec._coarse_stage)
        outs = [{k: np.asarray(v) for k, v in f(jnp.asarray(w)).items()}
                for w in z]
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}
    zt = torch.from_numpy(z.astype(np.complex64))
    with torch.no_grad():
        return {k: v.numpy() for k, v in dec._coarse_stage(zt).items()}


@pytest.mark.parametrize("grid_dtype", ["auto", "f32"])
def test_wideband_engine_matches_jax(grid_dtype):
    cfg = dc.replace(CFG, coarse=dc.replace(WIDEBAND, grid_dtype=grid_dtype))
    jdec = JaxDecoder(jax_config(cfg))
    tdec = DeviceDecoder(cfg, device="cpu")
    assert tdec.n_cand == 32
    j = jdec.decode_ri_batch(RI)
    t = tdec.decode_ri_batch(torch.from_numpy(RI))
    assert_outputs_match(t, j, tdec)
    assert [tdec.messages(t.window(w)) for w in range(2)] == [[MSG], [MSG]]
    freqs = [t.freq[w][t.success[w]][0] for w in range(2)]
    assert freqs == pytest.approx([80.0, -150.0], abs=0.4)
    jc, tc = coarse_fields(jdec, Z, True), coarse_fields(tdec, Z, False)
    v = jc["valid"]
    np.testing.assert_array_equal(tc["valid"], v)
    for key in ("freq", "shift", "drift", "mode"):
        np.testing.assert_array_equal(tc[key][v], jc[key][v], err_msg=key)


def test_wideband_grid_matches_jax():
    cfg = WIDEBAND
    m = cfg.fft_size // 2
    ps = stft_power(Z[0], n_ffts=cfg.n_ffts, size=cfg.fft_size,
                    hop=cfg.spb // 2, device="cpu")
    st = params.state_numpy(CFG)
    if0 = np.array([1, 2, 256, 300, 509, 510, 511, 0], np.int32)
    fw = (m - cfg.hpbm - 7, m + cfg.hpbm + 7)
    assert fw == (-7, 519)
    t = coarse_score_grid(ps[None], torch.from_numpy(if0)[None],
                          torch.from_numpy(st["offsets"]),
                          torch.from_numpy(st["sign"]),
                          f_window=fw, dtype="bf16")[0].numpy()
    j = np.asarray(jax_grid(jnp.asarray(ps.numpy()), jnp.asarray(if0),
                            jnp.asarray(st["offsets"]),
                            jnp.asarray(st["sign"]), impl="einsum",
                            f_window=fw, dtype="bf16"))
    assert t.shape == j.shape == (len(if0), 5, 26, st["offsets"].shape[0])
    # 0/0 where every term of a cell lies past the spectrum's edge: NaN in
    # both, at the same cells
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
    # the top lane's columns 512 and 513 read column 511, as JAX clamps
    np.testing.assert_array_equal(t[6, 3], t[6, 4])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_wideband_plain_grid_matches(dtype):
    """sync_grid_plain at the wideband window (-7, 519), clamped to the 512
    columns, on lanes at both edges (bin 0 wraps, bins 510 and 511 clamp
    past the top): within 1e-5 absolute of the JAX einsum grid (the same
    162 f32 terms a cell summed in another order) and of coarse_score_grid,
    NaN at the same cells."""
    cfg = WIDEBAND
    m = cfg.fft_size // 2
    ps = stft_power(Z[1], n_ffts=cfg.n_ffts, size=cfg.fft_size,
                    hop=cfg.spb // 2, device="cpu")[None]
    st = params.state_numpy(CFG)
    if0 = np.array([0, 1, 255, 510, 511], np.int32)
    fw = (m - cfg.hpbm - 7, m + cfg.hpbm + 7)
    offs = torch.from_numpy(st["offsets"])
    sign = torch.from_numpy(st["sign"])
    ifr = grid_columns(torch.from_numpy(if0)[None], 0, 512)
    assert ifr[0, 0].tolist() == [510, 511, 0, 1, 2]
    assert ifr[0, 4].tolist() == [509, 510, 511, 511, 511]
    got = sync_grid_plain(ps, ifr, offs, sign, lo=0, width=512,
                          dtype=dtype)[0].numpy()
    ein = coarse_score_grid(ps, torch.from_numpy(if0)[None], offs, sign,
                            f_window=fw, dtype=dtype)[0].numpy()
    j = np.asarray(jax_grid(jnp.asarray(ps[0].numpy()), jnp.asarray(if0),
                            jnp.asarray(st["offsets"]),
                            jnp.asarray(st["sign"]), impl="einsum",
                            f_window=fw, dtype=dtype))
    for ref in (j, ein):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[4, 3], got[4, 4])
