"""uwspr_tpu_torch.demod.finesync against uwspr_tpu.demod.finesync: shared
probe windows, phasor ramps, derotation and probe evaluation, in both the
complex64/f32 form and the bf16 real/imag-plane form.

Inputs are made with numpy from a seed. Tolerances: the window gathers are
pure data movement and must be equal (the bf16 planes round the same f32
values the same way); f32 math is held to 1e-5 relative (transcendentals
and summation order differ by ulps); bf16 elementwise chains round after
every op in torch while XLA on the CPU may keep f32 between ops, so bf16
results are held to a few bf16 ulps (2e-2 of the value range) and the
sync scores, averages over 162 symbols, to 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uwspr_tpu.demod import finesync as jfs
from uwspr_tpu_torch.demod import finesync as tfs

RNG = np.random.default_rng(21)
Z_ALL = (RNG.normal(size=(3, 45000))
         + 1j * RNG.normal(size=(3, 45000))).astype(np.complex64)
L = 5
WIDX = np.array([0, 2, 1, 2, 0], np.int32)
CENTER = np.array([0, 128, 1792, 640, 1100], np.int32)
DRIFT = RNG.uniform(-1.5, 1.5, size=(L, 162)).astype(np.float32)


def _jt(x):
    """jax array -> numpy, complex bf16 planes via f32."""
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


def _tt(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def test_jiggle_offsets_match():
    for n, ii in ((17, 8), (3, 8), (9, 4)):
        np.testing.assert_array_equal(tfs.jiggle_offsets(n, ii),
                                      jfs.jiggle_offsets(n, ii))


@pytest.mark.parametrize("dtype", ["c64", "bf16"])
@pytest.mark.parametrize("reach,W,block", [(128, 640, 128), (96, 640, 128),
                                           (224, 1024, 256)])
def test_shared_probe_lanes_match(dtype, reach, W, block):
    A_j, b_j = jfs.make_shared_probe_lanes(
        jnp.asarray(Z_ALL), jnp.asarray(WIDX), jnp.asarray(CENTER),
        reach=reach, W=W, block=block, dtype=dtype)
    A_t, b_t = tfs.make_shared_probe_lanes(
        torch.from_numpy(Z_ALL), torch.from_numpy(WIDX),
        torch.from_numpy(CENTER), reach=reach, W=W, block=block, dtype=dtype)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(_tt(A_t), _jt(A_j))           # exact


def test_shared_probe_single_window_matches():
    A_j, b_j = jfs.make_shared_probe(jnp.asarray(Z_ALL[1]),
                                     jnp.asarray(CENTER), reach=128, W=640,
                                     block=128, dtype="bf16")
    A_t, b_t = tfs.make_shared_probe(torch.from_numpy(Z_ALL[1]),
                                     torch.from_numpy(CENTER), reach=128,
                                     W=640, block=128, dtype="bf16")
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(_tt(A_t), _jt(A_j))


def test_phasor_ramps_match():
    theta_np = RNG.uniform(-0.05, 0.05, size=(4, 7)).astype(np.float32)
    theta = jnp.asarray(theta_np)
    ref = np.asarray(jfs.phasor_ramp(theta, 640))
    got = tfs.phasor_ramp(torch.from_numpy(theta_np), 640).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    cr_j, ci_j = jfs._phasor_ramp_ri(theta, 640, jnp.bfloat16)
    cr_t, ci_t = tfs._phasor_ramp_ri(torch.from_numpy(theta_np), 640,
                                     torch.bfloat16)
    np.testing.assert_allclose(_tt(cr_t), _jt(cr_j), atol=2e-2)  # bf16 ulps
    np.testing.assert_allclose(_tt(ci_t), _jt(ci_j), atol=2e-2)


def _windows(dtype):
    A_j, b_j = jfs.make_shared_probe_lanes(
        jnp.asarray(Z_ALL), jnp.asarray(WIDX), jnp.asarray(CENTER),
        reach=96, W=640, block=128, dtype=dtype)
    A_t, b_t = tfs.make_shared_probe_lanes(
        torch.from_numpy(Z_ALL), torch.from_numpy(WIDX),
        torch.from_numpy(CENTER), reach=96, W=640, block=128, dtype=dtype)
    return A_j, b_j, A_t, b_t


@pytest.mark.parametrize("dtype", ["c64", "bf16"])
def test_probe_derotate_matches(dtype):
    A_j, _, A_t, _ = _windows(dtype)
    ref = _jt(jfs.probe_derotate(A_j, jnp.asarray(DRIFT)))
    got = _tt(tfs.probe_derotate(A_t, torch.from_numpy(DRIFT)))
    scale = np.abs(ref).max()
    tol = 2e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got, ref, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["c64", "bf16"])
def test_shared_probe_eval_matches(dtype):
    A_j, b_j, A_t, b_t = _windows(dtype)
    zd_j = jfs.probe_derotate(A_j, jnp.asarray(DRIFT))
    zd_t = tfs.probe_derotate(A_t, torch.from_numpy(DRIFT))
    lags = CENTER[:, None] + np.arange(-32, 33, 16)[None, :]
    freqs = (RNG.uniform(-5, 5, size=(L, 1))
             + np.arange(-2, 3)[None, :] * 0.05).astype(np.float32)
    pdt = "bf16" if dtype == "bf16" else "f32"
    s_j, p_j = jfs.shared_probe_eval(zd_j, b_j, jnp.asarray(lags),
                                     jnp.asarray(freqs), n_lags=5,
                                     want_symbols=True, dtype=pdt)
    s_t, p_t = tfs.shared_probe_eval(zd_t, b_t, torch.from_numpy(lags),
                                     torch.from_numpy(freqs), n_lags=5,
                                     want_symbols=True, dtype=pdt)
    assert s_t.shape == s_j.shape and p_t.shape == p_j.shape
    p_ref = np.asarray(p_j)
    if dtype == "bf16":
        np.testing.assert_allclose(p_t.numpy(), p_ref,
                                   atol=2e-2 * p_ref.max())
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=2e-3)
    else:
        np.testing.assert_allclose(p_t.numpy(), p_ref,
                                   rtol=1e-4, atol=1e-5 * p_ref.max())
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                                   rtol=1e-4, atol=1e-6)
