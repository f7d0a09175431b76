"""uwspr_tpu_torch.fec.fano against the JAX package's Fano decoders.

Tolerance: bit-exact on every result field (success, data, metric,
cycles, maxnp). The port's plain lockstep version (used for CPU tensors) is
held against the Pallas kernel in interpret mode and against the Python
oracle fec.fano_ref on the cases of tests/test_fano_pallas.py, plus
inactive lanes. The CUDA kernel's own walk (the template fano_walk of
csrc/fano_lane.cuh, on the metric table its prologue builds with
node_metrics) is built with g++ and held against the native C++ decoder
at the full budget and the plain version here; the kernel itself is
checked on the card by the tests marked ``cuda``. The plain loop costs one Python step per primitive move, so the
cases that time out keep maxcycles small.
"""

import ctypes
import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fano_pallas import _lanes
from uwspr_tpu.fec.fano_jax import branch_metrics as jax_branch_metrics
from uwspr_tpu.fec.fano_pallas import fano_decode_batch_pallas
from uwspr_tpu.fec.fano_ref import fano_decode
from uwspr_tpu.fec.native import fano_decode_batch_native
from uwspr_tpu.protocol.constants import FANO_METTAB
from uwspr_tpu_torch.fec import fano

CSRC = pathlib.Path(__file__).resolve().parents[1] / "uwspr_tpu_torch" / "csrc"
KEYS = ("success", "data", "metric", "cycles", "maxnp")


def _port(symbols, active=None, maxcycles=10000):
    out = fano.fano_decode_batch(
        torch.from_numpy(symbols), torch.from_numpy(FANO_METTAB),
        None if active is None else torch.from_numpy(active),
        maxcycles=maxcycles)
    return {k: v.numpy() for k, v in out.items()}


def _case(name):
    rng = np.random.default_rng(["clean", "noisy", "timeout", "mixed",
                                 "inactive"].index(name))
    if name == "clean":
        return _lanes(rng, 6, sigma=10.0), None, 10000
    if name == "noisy":
        return _lanes(rng, 6, sigma=48.0), None, 60
    if name == "timeout":
        return rng.integers(0, 256, size=(4, 162)).astype(np.uint8), None, 40
    if name == "mixed":
        lanes = np.concatenate([
            _lanes(rng, 3, sigma=45.0),
            rng.integers(0, 256, size=(3, 162)).astype(np.uint8)])
        return lanes, None, 25
    lanes = _lanes(rng, 5, sigma=25.0)
    return lanes, np.array([True, False, True, False, True]), 10000


@pytest.mark.parametrize("name", ["clean", "noisy", "timeout", "mixed",
                                  "inactive"])
def test_fano_matches_pallas_and_oracle(name):
    symbols, active, maxcycles = _case(name)
    got = _port(symbols, active, maxcycles)
    ref = fano_decode_batch_pallas(
        jnp.asarray(symbols, jnp.int32), jnp.asarray(FANO_METTAB),
        None if active is None else jnp.asarray(active),
        maxcycles=maxcycles, interpret=True)
    for key in KEYS:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]),
                                      err_msg=key)
    for i in range(len(symbols)):
        if active is not None and not active[i]:
            # inactive lanes start done (fano_pallas.py:131-140)
            assert (not got["success"][i] and got["metric"][i] == 0
                    and got["cycles"][i] == 1 and got["maxnp"][i] == 0
                    and not got["data"][i].any())
            continue
        r = fano_decode(symbols[i], FANO_METTAB, maxcycles=maxcycles)
        assert got["success"][i] == r.success
        assert got["metric"][i] == r.metric
        assert got["cycles"][i] == r.cycles
        assert got["maxnp"][i] == r.maxnp
        if r.success:
            np.testing.assert_array_equal(got["data"][i], r.data)


@pytest.mark.parametrize("L", [1, 129])
def test_fano_lane_count_off_block(L):
    rng = np.random.default_rng(6)
    lanes = _lanes(rng, L, sigma=15.0)
    got = _port(lanes, maxcycles=200)
    assert got["success"].shape == (L,) and got["success"].all()
    s, d, m, c, n = fano_decode_batch_native(lanes, FANO_METTAB,
                                             maxcycles=200)
    for key, ref in zip(KEYS, (s, d, m, c, n)):
        np.testing.assert_array_equal(got[key], ref, err_msg=key)


def test_branch_metrics_match_jax():
    rng = np.random.default_rng(8)
    sym = rng.integers(0, 256, size=(7, 162)).astype(np.uint8)
    got = fano.branch_metrics(torch.from_numpy(sym),
                              torch.from_numpy(FANO_METTAB))
    ref = jax_branch_metrics(jnp.asarray(sym, jnp.int32),
                             jnp.asarray(FANO_METTAB), 81)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fano_cpu_uses_plain_and_counts():
    fano.reset_counters()
    _port(_case("clean")[0])
    assert fano.PLAIN_CALLS == 1 and fano.KERNEL_LAUNCHES == 0


# The kernel's walk on the host: the prologue's metric table built with
# node_metrics, node state zeroed as the kernel zeroes it in shared memory,
# then fano_walk on the lane.
_SHIM = r"""
#include "fano_lane.cuh"
using namespace uwspr;
extern "C" void lane_decode(const unsigned char* sym, const unsigned char* act,
                            const int* mettab, int L, int delta, int budget,
                            int* out /* L x 4 */, unsigned char* data) {
  for (int l = 0; l < L; ++l) {
    NodeMetrics met[kNbits];
    NodeRec rec[kNodes] = {};
    int32_t branch[kNodes];
    for (int k = 0; k < kNbits; ++k) {
      const unsigned char* p = sym + l * 162 + 2 * k;
      met[k] = node_metrics(mettab, p[0], p[1]);
    }
    const LaneNodes nd{rec, branch, met};
    FanoLaneResult r = fano_walk(nd, delta, budget, act[l] != 0,
                                 data + l * 10);
    out[4 * l] = r.success; out[4 * l + 1] = r.metric;
    out[4 * l + 2] = r.cycles; out[4 * l + 3] = r.maxnp;
  }
}
"""


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    """The kernel's lane header compiled for the host with g++."""
    d = tmp_path_factory.mktemp("fano_lane")
    src = d / "shim.cc"
    src.write_text(_SHIM)
    lib = d / "libshim.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", str(src), "-o", str(lib)], check=True)
    return ctypes.CDLL(str(lib))


def _lane_decode(lib, symbols, active, maxcycles):
    L = len(symbols)
    sym = np.ascontiguousarray(symbols, np.uint8)
    act = np.ascontiguousarray(active, np.uint8)
    met = np.ascontiguousarray(FANO_METTAB, np.int32)
    out = np.zeros((L, 4), np.int32)
    data = np.zeros((L, 10), np.uint8)
    lib.lane_decode(ctypes.c_void_p(sym.ctypes.data),
                    ctypes.c_void_p(act.ctypes.data),
                    ctypes.c_void_p(met.ctypes.data), ctypes.c_int(L),
                    ctypes.c_int(60), ctypes.c_int(maxcycles * 81),
                    ctypes.c_void_p(out.ctypes.data),
                    ctypes.c_void_p(data.ctypes.data))
    return {"success": out[:, 0] != 0, "data": data, "metric": out[:, 1],
            "cycles": out[:, 2], "maxnp": out[:, 3]}


def test_kernel_lane_logic_matches_native_full_budget(lane_lib):
    """fano_lane.cuh on the host against fano_native.cc at the full
    10,000-cycle budget, timeouts included."""
    rng = np.random.default_rng(9)
    lanes = np.concatenate([_lanes(rng, 8, sigma=10.0),
                            _lanes(rng, 8, sigma=48.0),
                            rng.integers(0, 256, (8, 162)).astype(np.uint8)])
    got = _lane_decode(lane_lib, lanes, np.ones(len(lanes), bool), 10000)
    s, d, m, c, n = fano_decode_batch_native(lanes, FANO_METTAB,
                                             maxcycles=10000)
    assert (c == 810002).sum() >= 8          # the noise lanes time out
    for key, ref in zip(KEYS, (s, d, m, c, n)):
        np.testing.assert_array_equal(got[key], ref, err_msg=key)


def test_kernel_lane_logic_matches_plain(lane_lib):
    symbols, active, _ = _case("inactive")
    mixed, _, _ = _case("mixed")
    symbols = np.concatenate([symbols, mixed])
    active = np.concatenate([active, np.ones(len(mixed), bool)])
    got = _lane_decode(lane_lib, symbols, active, 30)
    ref = _port(symbols, active, 30)
    for key in KEYS:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.cuda
def test_fano_kernel_matches_plain_and_native_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel-against-plain check)")
    rng = np.random.default_rng(10)
    lanes = np.concatenate([_lanes(rng, 40, sigma=10.0),
                            _lanes(rng, 40, sigma=45.0),
                            rng.integers(0, 256, (50, 162)).astype(np.uint8)])
    active = rng.random(len(lanes)) > 0.2
    met = torch.from_numpy(FANO_METTAB)
    k = fano.fano_decode_batch(torch.from_numpy(lanes).cuda(), met.cuda(),
                               torch.from_numpy(active).cuda(), maxcycles=30)
    p = _port(lanes, active, 30)
    for key in KEYS:
        np.testing.assert_array_equal(k[key].cpu().numpy(), p[key],
                                      err_msg=key)
    k = fano.fano_decode_batch(torch.from_numpy(lanes).cuda(), met.cuda(),
                               maxcycles=10000)
    s, d, m, c, n = fano_decode_batch_native(lanes, FANO_METTAB,
                                             maxcycles=10000)
    for key, ref in zip(KEYS, (s, d, m, c, n)):
        np.testing.assert_array_equal(k[key].cpu().numpy(), ref,
                                      err_msg=key)
