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

The CUDA kernel's lane logic (csrc/osd_lane.cuh: the counting rank, the
information set by column operations, the integer flip search split into
the kernel's 256 thread ranges and merged) is built with g++ and held to
osd2_decode_jax at orders 1 to 4 on the same scenes plus three edge lanes
(every symbol at 128: r = 0, the total clamped, every score tied; heavy
ties in r; noise): bits and flips equal, quality and margin bit for bit
the plain version's and within 1e-5 of JAX; inactive lanes give the
documented zeros. The kernel itself is checked on the card by the test
marked ``cuda``.
"""

import ctypes
import pathlib
import subprocess

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


def test_bad_kernel_inputs_raise():
    with pytest.raises(ValueError, match="G must be"):
        osd_torch.osd_decode_lanes(torch.zeros(1, 162), G_T[:, :10], 2)
    with pytest.raises(ValueError, match="active"):
        osd_torch.osd_decode_lanes(torch.zeros(2, 162), G_T, 2,
                                   torch.ones(3, dtype=torch.bool))


def test_plain_active_decodes_the_active_lanes_alone():
    """With ``active`` the plain version equals itself on the active lanes
    alone and gives each inactive lane bits 0, quality 0, margin 0 and
    flips 0, the kernel's contract; the wrapper counts one plain call."""
    soft = torch.from_numpy(lanes(31, 5, 14))
    active = torch.tensor([True, False, True, True, False, False])
    osd_torch.reset_counters()
    got = osd_torch.osd_decode_lanes(soft, G_T, 3, active)
    assert osd_torch.PLAIN_CALLS == 1 and osd_torch.KERNEL_LAUNCHES == 0
    want = osd_torch.osd_decode_lanes(soft[active], G_T, 3)
    for g, w in zip(got, want):
        assert torch.equal(g[active], w)
        assert not g[~active].any()
    none = osd_torch.osd_decode_lanes(soft, G_T, 3,
                                      torch.zeros(6, dtype=torch.bool))
    assert [tuple(x.shape) for x in none] == [(6, 50), (6,), (6,), (6,)]
    assert not any(x.any() for x in none)


# ---------------------------------------------- the kernel's lane logic

CSRC = pathlib.Path(__file__).resolve().parents[1] / "uwspr_tpu_torch" / "csrc"
SPLIT = (8, 32)         # osd.cu's block: 8 warps of 32 lanes

_SHIM = r"""
#include "osd_lane.cuh"
using namespace uwspr::osd;
extern "C" void lane_osd(const unsigned char* soft, const unsigned char* act,
                         const float* G, int L, int order, int ngroups,
                         int width, int* bits, float* quality,
                         float* margin, int* flips) {
  for (int l = 0; l < L; ++l) {
    if (!act[l]) {              /* osd.cu: an inactive lane starts done */
      for (int x = 0; x < kK; ++x) bits[l * kK + x] = 0;
      quality[l] = 0.0f; margin[l] = 0.0f; flips[l] = 0;
      continue;
    }
    OsdScratch s;
    osd_lane_host(s, soft + l * kN, G, order, ngroups, width, bits + l * kK,
                  quality + l, margin + l, flips + l);
  }
}
"""


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    """The kernel's lane header compiled for the host with g++."""
    d = tmp_path_factory.mktemp("osd_lane")
    src = d / "shim.cc"
    src.write_text(_SHIM)
    lib = d / "libshim.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", str(src), "-o", str(lib)], check=True)
    return ctypes.CDLL(str(lib))


def lane_decode(lib, soft, order, active=None, split=SPLIT):
    L = len(soft)
    soft = np.ascontiguousarray(soft, np.uint8)
    act = np.ascontiguousarray(np.ones(L, bool) if active is None
                               else active, np.uint8)
    G = np.ascontiguousarray(G_T.numpy())
    bits = np.zeros((L, 50), np.int32)
    q = np.zeros(L, np.float32)
    m = np.zeros(L, np.float32)
    f = np.zeros(L, np.int32)
    ptr = [ctypes.c_void_p(a.ctypes.data) for a in (soft, act, G)]
    out = [ctypes.c_void_p(a.ctypes.data) for a in (bits, q, m, f)]
    lib.lane_osd(*ptr, ctypes.c_int(L), ctypes.c_int(order),
                 ctypes.c_int(split[0]), ctypes.c_int(split[1]), *out)
    return bits, q, m, f


def edge_lanes(seed=3):
    """Every symbol at 128 (r = 0: the total clamped to 1e-9, every score
    0), a lane whose r takes three values (heavy ties), and a noise
    lane."""
    rng = np.random.default_rng(seed)
    flat = np.full(162, 128, np.uint8)
    ties = (128 + rng.choice([-2, -1, 0, 1, 2], 162)).astype(np.uint8)
    noise = rng.integers(0, 256, 162).astype(np.uint8)
    return np.stack([flat, ties, noise])


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_kernel_lane_logic_matches_osd_jax(lane_lib, order):
    soft = np.concatenate([lanes(100 + order, 5 if order < 4 else 3, 16),
                           edge_lanes()])
    u, q, m, nf = lane_decode(lane_lib, soft, order)
    pu, pq, pm, pnf = port(soft, order)
    np.testing.assert_array_equal(u, pu)
    np.testing.assert_array_equal(nf, pnf)
    np.testing.assert_array_equal(q.view(np.int32), pq.view(np.int32))
    np.testing.assert_array_equal(m.view(np.int32), pm.view(np.int32))
    f = jax.jit(lambda s: osd2_decode_jax(s, jax_generator_matrix(), order))
    for i, lane in enumerate(soft):
        ju, jq, jm, jnf = f(jnp.asarray(lane, jnp.float32))
        np.testing.assert_array_equal(u[i], np.asarray(ju), err_msg=str(i))
        assert nf[i] == int(jnf)
        assert abs(q[i] - float(jq)) <= 1e-5
        assert abs(m[i] - float(jm)) <= 1e-5
    assert q[-3] == 1.0 and m[-3] == 0.0 and nf[-3] == 0   # all tied


def test_kernel_lane_logic_thread_split_and_inactive(lane_lib):
    """The flip search's split over threads does not change a result (one
    thread; 3 groups of 5 lanes; the kernel's 8 warps of 32; order 4), and
    inactive lanes give the documented zeros."""
    soft = np.concatenate([lanes(41, 2, 16), edge_lanes(4)])
    one = lane_decode(lane_lib, soft, 4, split=(1, 1))
    for split in ((3, 5), SPLIT):
        for a, b in zip(one, lane_decode(lane_lib, soft, 4, split=split)):
            np.testing.assert_array_equal(a, b)
    active = np.array([True, False, True, False, True, False])
    got = lane_decode(lane_lib, soft, 4, active)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a[active], b[active])
        assert not a[~active].any()


@pytest.mark.cuda
def test_osd_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel-against-plain check)")
    soft = np.concatenate([lanes(50, 40, 16), edge_lanes()])
    active = np.random.default_rng(51).random(len(soft)) > 0.2
    for order in (1, 2, 3, 4):
        got = osd_torch.osd_decode_lanes(
            torch.from_numpy(soft).cuda(), G_T.cuda(), order,
            torch.from_numpy(active).cuda())
        want = osd_torch.osd_decode_lanes(
            torch.from_numpy(soft), G_T, order, torch.from_numpy(active))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
