"""The port's batched OSD (fec/osd_torch.py) against the JAX package's
osd2_decode_jax and the host fec/osd.osd_decode.

Inputs: u8 soft symbols made with numpy from a seed, as tests/test_osd.py's
``_quantized_soft`` makes them (a codeword with a few flipped positions),
plus pure-noise lanes. The JAX function decodes one lane at a time (jit,
on the CPU); the port decodes the whole batch on the CPU.

Tolerances: info bits, flips and payload bytes equal; quality and margin
within 1e-5 of the JAX function (with integer soft symbols every score is
an integer or a half-integer in float32, so they come out equal) and
within 1e-3 of the host decoder, which scores in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uwspr_tpu.fec.osd import generator_matrix as jax_generator_matrix
from uwspr_tpu.fec.osd import osd_decode
from uwspr_tpu.fec.osd_jax import bits_to_payload as jax_bits_to_payload
from uwspr_tpu.fec.osd_jax import osd2_decode_jax
from uwspr_tpu.protocol.fec_encode import bits_to_bytes, encode_frame_bits
from uwspr_tpu_torch.fec import osd_torch
from uwspr_tpu_torch.fec.osd import generator_matrix

G_T = torch.from_numpy(generator_matrix().astype(np.float32))


def quantized_soft(rng, nerr):
    """tests/test_osd.py::_quantized_soft."""
    bits = rng.integers(0, 2, 50).astype(np.uint8)
    cw = encode_frame_bits(bits)
    rel = rng.uniform(5, 100, 162)
    soft = np.where(cw, 128 + rel, 128 - rel)
    err = rng.choice(162, nerr, replace=False)
    soft[err] = 256 - soft[err]
    return np.clip(np.round(soft), 0, 255).astype(np.uint8), bits


def lanes(seed, n, max_err):
    rng = np.random.default_rng(seed)
    out = [quantized_soft(rng, int(rng.integers(0, max_err)))[0]
           for _ in range(n)]
    out.append(np.clip(np.round(128 + rng.normal(0, 30, 162)), 0,
                       255).astype(np.uint8))               # noise only
    return np.stack(out)


def port(soft, order):
    u, q, m, nf = osd_torch.osd_decode_lanes(
        torch.from_numpy(soft.astype(np.float32)), G_T, order)
    return u.numpy(), q.numpy(), m.numpy(), nf.numpy()


def test_generator_is_the_jax_decoders():
    np.testing.assert_array_equal(G_T.numpy(),
                                  jax_generator_matrix().astype(np.float32))


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_matches_osd_jax(order):
    soft = lanes(100 + order, 5 if order < 4 else 3, 16)
    f = jax.jit(lambda s: osd2_decode_jax(s, jax_generator_matrix(), order))
    u, q, m, nf = port(soft, order)
    for i, lane in enumerate(soft):
        ju, jq, jm, jnf = f(jnp.asarray(lane, jnp.float32))
        np.testing.assert_array_equal(u[i], np.asarray(ju), err_msg=str(i))
        assert nf[i] == int(jnf)
        assert abs(q[i] - float(jq)) <= 1e-5
        assert abs(m[i] - float(jm)) <= 1e-5
    np.testing.assert_array_equal(
        osd_torch.bits_to_payload(torch.from_numpy(u)).numpy(),
        np.asarray(jax_bits_to_payload(jnp.asarray(u))))


@pytest.mark.parametrize("order", [2, 3, 4])
def test_matches_host_osd(order):
    """The cases of tests/test_osd.py (device OSD against the host walk)."""
    soft = lanes(order * 7, 6 if order < 4 else 4, 14)
    u, q, m, nf = port(soft, order)
    for i, lane in enumerate(soft):
        ref = osd_decode(lane, order=order)
        np.testing.assert_array_equal(u[i], ref.info_bits, err_msg=str(i))
        assert nf[i] == ref.flips
        assert abs(q[i] - ref.quality) < 1e-3
        assert abs(m[i] - ref.margin) < 1e-3
        pl = osd_torch.bits_to_payload(torch.from_numpy(u[i]))
        assert bytes(pl.numpy()) == bytes(bits_to_bytes(ref.info_bits)[:7])


def test_batch_equals_lanes_one_at_a_time():
    soft = lanes(5, 4, 12)
    u, q, m, nf = port(soft, 3)
    for i in range(len(soft)):
        ui, qi, mi, nfi = port(soft[i:i + 1], 3)
        np.testing.assert_array_equal(ui[0], u[i])
        assert (qi[0], mi[0], nfi[0]) == (q[i], m[i], nf[i])


def test_corrects_three_hard_errors():
    """tests/test_osd.py's planted hard errors: order 3 recovers them."""
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 50).astype(np.uint8)
    coded = encode_frame_bits(bits)
    soft = (128 + (2 * coded.astype(int) - 1) * 60).astype(np.int64)
    soft += rng.integers(-20, 21, 162)
    flip = [10, 70, 140]
    soft[flip] = 256 - soft[flip]
    soft = np.clip(soft, 0, 255).astype(np.uint8)
    u, q, _, nf = port(soft[None], 3)
    np.testing.assert_array_equal(u[0], bits)
    assert q[0] > 0.5


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="order"):
        osd_torch.osd_decode_lanes(torch.zeros(1, 162), G_T, 5)
    with pytest.raises(ValueError, match="162"):
        osd_torch.osd_decode_lanes(torch.zeros(1, 50), G_T, 2)
