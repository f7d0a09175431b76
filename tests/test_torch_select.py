"""uwspr_tpu_torch.ops.select against the JAX package's selection.

The port's plain version (used for CPU tensors) must be bit-identical to
the literal sequential fold (coarse.search.select_best_scan) and to the
Pallas kernel in interpret mode on every adversarial case of
tests/test_select_pallas.py, on a lane count off the TPU kernel's 16-lane
chunk and on an all-linear bank. Tolerance: exact (best compared bitwise,
index equal). The CUDA kernel is held against the plain version on the
card by the tests marked ``cuda``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_copies import jax_coarse
from uwspr_tpu.coarse.search import build_drift_models, select_best_scan
from uwspr_tpu.ops.select_pallas import select_best_pallas
from uwspr_tpu_torch.config import CoarseConfig
from uwspr_tpu_torch.ops import select as sel

_BANK = build_drift_models(jax_coarse(CoarseConfig()))
_M = _BANK.offsets.shape[0]


def _cases():
    rng = np.random.default_rng(17)
    cases = {f"noise{i}": rng.normal(size=(13, 5, 26, _M)).astype(np.float32)
             * 0.1 for i in range(3)}
    nanc = cases["noise0"].copy()
    nanc[0, 2, 3, :] = np.nan
    nanc[1, :, :, 40:] = np.nan
    nanc[2] = np.nan
    cases["nan"] = nanc
    neg = np.full((2, 5, 26, _M), -100.0, np.float32)
    neg[0, 0, 0, 0] = -5.0       # linear seed
    neg[0, 0, 2, 1] = -80.0      # nl decrease (ratio 16 > 10)
    neg[0, 0, 4, 3] = -60.0      # linear accept against -80
    cases["negative_best"] = neg
    esc = np.full((1, 5, 26, _M), 1e-6, np.float32)
    esc[0, 0, 0, [0, 4, 7, 10]] = [1e-4, 2e-3, 0.3, 40.0]   # 3-accept chain
    cases["chain3"] = esc
    deep = np.full((1, 5, 26, _M), 1e-9, np.float32)
    deep[0, 1, 3, [0, 3, 5, 8, 11]] = [1e-7, 5e-6, 1e-4, 9e-3, 0.7]
    cases["chain4"] = deep                   # forces the group revisit
    cases["c21"] = rng.normal(size=(21, 5, 26, _M)).astype(np.float32) * 0.1
    return cases


CASES = _cases()


def _port(sync, is_nl):
    best, idx = sel.select_best(torch.from_numpy(sync),
                                torch.from_numpy(is_nl), threshold=10.0)
    return best.numpy(), idx.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_matches_scan_and_pallas(name):
    sync = CASES[name]
    is_nl = np.asarray(_BANK.is_nonlinear)
    b, i = _port(sync, is_nl)
    bs, is_ = select_best_scan(jnp.asarray(sync), jnp.asarray(is_nl),
                               threshold=10.0)
    np.testing.assert_array_equal(i, np.asarray(is_))
    np.testing.assert_array_equal(b.view(np.int32),
                                  np.asarray(bs).view(np.int32))
    bp, ip = select_best_pallas(jnp.asarray(sync), jnp.asarray(is_nl),
                                threshold=10.0, interpret=True)
    np.testing.assert_array_equal(i, np.asarray(ip))
    np.testing.assert_array_equal(b.view(np.int32),
                                  np.asarray(bp).view(np.int32))


def test_select_all_linear_bank():
    """An all-linear bank: the nonlinear jump test must stay off (the
    any(is_nonlinear) gate), and the result is the plain strict max walk."""
    sync = CASES["nan"]
    is_nl = np.zeros(_M, bool)
    b, i = _port(sync, is_nl)
    bs, is_ = select_best_scan(jnp.asarray(sync), jnp.asarray(is_nl),
                               threshold=10.0)
    np.testing.assert_array_equal(i, np.asarray(is_))
    np.testing.assert_array_equal(b.view(np.int32),
                                  np.asarray(bs).view(np.int32))


def test_select_cpu_uses_plain_and_counts():
    sel.reset_counters()
    _port(CASES["noise1"], np.asarray(_BANK.is_nonlinear))
    assert sel.PLAIN_CALLS == 1 and sel.KERNEL_LAUNCHES == 0


def test_select_plain_rejects_unordered_bank():
    is_nl = np.asarray(_BANK.is_nonlinear)[::-1].copy()
    with pytest.raises(ValueError, match="linear-first"):
        _port(CASES["noise1"], is_nl)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_select_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel-against-plain check)")
    is_nl = torch.from_numpy(np.asarray(_BANK.is_nonlinear)).cuda()
    sync = torch.from_numpy(CASES[name]).cuda()
    bk, ik = sel.select_best(sync, is_nl, threshold=10.0)
    bp, ip = sel.select_best_plain(sync, is_nl, threshold=10.0)
    assert torch.equal(bk.view(torch.int32), bp.view(torch.int32))
    assert torch.equal(ik, ip)
