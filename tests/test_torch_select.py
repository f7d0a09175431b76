"""uwspr_tpu_torch.ops.select against the JAX package's selection.

The port's plain version (used for CPU tensors) must be bit-identical to
the literal sequential fold (coarse.search.select_best_scan) and to the
Pallas kernel in interpret mode on every adversarial case of
tests/test_select_pallas.py, on a lane count off the TPU kernel's 16-lane
chunk and on an all-linear bank. Tolerance: exact (best compared bitwise,
index equal). The CUDA kernel is held against the plain version on the
card by the tests marked ``cuda``; its algorithm (per-group extremes
table, ballot jump over 32 groups, 32-wide chunk scan, division-free
nonlinear test) is modelled in numpy here (``_kernel_model``) and held to
the literal scan, also on a bank that is not linear-first, on accepts
at chunk edges and on accepts of -0, +0, subnormals, infinities and
near-threshold quotients (chip_smoke.special_lanes); the division-free test is also held to f32 division on
special values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import literal_scan, special_lanes
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


def _unordered_bank():
    """The default bank's flags shuffled: linear models fall inside and at
    the edges of the 32-model chunks."""
    nl = np.asarray(_BANK.is_nonlinear).copy()
    np.random.default_rng(4).shuffle(nl)
    nl[[0, 31, 63]] = False
    nl[[32, 64, 125]] = True
    return nl


def _chunk_edges():
    """Accept chains whose steps fall on models 31, 32, 63 and 64, across
    groups, so that a chunk's last or first model accepts."""
    x = np.full((3, 5, 26, _M), 1e-9, np.float32)
    x[0, 0, 0, [31, 32, 63, 64]] = [1e-7, 2e-6, 3e-5, 5e-4]
    x[0, 2, 7, [63, 95, 96]] = [7e-3, 0.09, 1.0]
    x[1, 1, 4, [31, 63]] = [1e-7, 2e-6]
    x[1, 1, 5, [32, 33]] = [3e-5, 4e-4]
    x[2, 4, 25, [30, 31, 32]] = [1e-7, 2e-6, 3e-5]
    x[2, 4, 25, 125] = 5e-4
    return x


_F32 = np.float32
_FMAX = np.finfo(np.float32).max
_TINY = np.nextafter(_F32(0), _F32(1))


def _nl_bounds(best, mid, tie_up):
    """numpy mirror of select_best.cu::nl_bounds: (a, b, c) such that a
    nonlinear model with value v passes, fl(v / best) > T, iff
    a <= v <= c or v <= b."""
    a, b, c = _F32(np.nan), _F32(np.nan), _F32(np.inf)
    best = _F32(best)
    with np.errstate(all="ignore"):
        if np.isnan(best):
            return a, b, c
        if np.isinf(best):
            if mid < 0:
                a, c = -_FMAX, _FMAX
            return a, b, c
        if best == 0:
            if np.signbit(best):
                b = -_TINY
            else:
                a = _TINY
            return a, b, c
        d = mid * float(best)
        f = _F32(d)
        if best > 0:
            if float(f) < d:
                f = np.nextafter(f, _F32(np.inf))
            if float(f) == d and not tie_up:
                f = np.nextafter(f, _F32(np.inf))
            a = f
        else:
            if float(f) > d:
                f = np.nextafter(f, _F32(-np.inf))
            if float(f) == d and not tie_up:
                f = np.nextafter(f, _F32(-np.inf))
            b = f
    return a, b, c


def _nl_passes(bounds, v):
    a, b, c = bounds
    return ((v >= a) & (v <= c)) | (v <= b)


def _special_floats(rng, n):
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, _FMAX, -_FMAX,
                        _TINY, -_TINY, 1e-40, -1e-40, 1.0, -1.0, 10.0,
                        -10.0, 1e-30, -1e30, 3e38, 0.1, -0.1], np.float32)
    mag = np.exp2(rng.uniform(-149, 128, n)).astype(np.float32)
    sign = np.where(rng.random(n) < 0.5, -1, 1).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    near = (_F32(10.0) * rng.uniform(0.9, 1.1, n)).astype(np.float32)
    return np.concatenate([special, mag * sign, bits, near, -near])


@pytest.mark.parametrize("thr", [10.0, 0.5, -3.0, 1e-30, 3e38,
                                 float(_FMAX), -float(_FMAX), 0.0, -0.0,
                                 float(_TINY), -float(_TINY), 1.0000001,
                                 float(np.nextafter(_F32(7.0), _F32(8.0))),
                                 5e-39])
def test_division_free_test_equals_f32_division(thr):
    """The kernel's nonlinear test (per-best bounds from the threshold's
    midpoint, no division) equals fl(v / best) > T, IEEE f32 division, on
    zeros, infinities, NaN, subnormals, random bit patterns and values
    near the threshold, for thresholds of either sign and mantissa
    parity."""
    rng = np.random.default_rng(11)
    vals = _special_floats(rng, 600)
    bests = _special_floats(rng, 150)
    mid, tie_up = sel.threshold_midpoint(thr)
    t = _F32(thr)
    with np.errstate(all="ignore"):
        for best in bests:
            want = (vals / best) > t
            got = _nl_passes(_nl_bounds(best, mid, tie_up), vals)
            bad = np.flatnonzero(want != got)
            assert bad.size == 0, (thr, best, vals[bad[:5]])
        # ties: quotients of exactly mid (possible for zero and subnormal T)
        for e in range(-20, 21, 5):
            best = _F32(2.0 ** e)
            v = _F32(mid * float(best))
            if float(v) == mid * float(best):
                got = _nl_passes(_nl_bounds(best, mid, tie_up), np.array([v]))
                assert bool(got[0]) == bool((v / best) > t)


def test_threshold_must_be_finite():
    with pytest.raises(ValueError, match="finite"):
        sel.threshold_midpoint(float("inf"))


def _kernel_model(sync, is_nl, thr):
    """numpy model of csrc/select_best.cu: a per-group table of linear max
    and nonlinear max and min (NaN excluded; a group holds a nonlinear
    value iff min <= max), then per lane a walk that tests 32 groups at a
    time against the running best and jumps to the first that can accept,
    and resolves it 32 models at a time, the first accepting model of a
    chunk (at or after the scan position) being the next accept. The
    nonlinear test goes through the per-best bounds of _nl_bounds."""
    L, M = sync.shape[0], sync.shape[-1]
    g3 = sync.reshape(L, -1, M)
    G = g3.shape[1]
    nl = np.asarray(is_nl, bool)
    mid, tie_up = sel.threshold_midpoint(thr)
    lmax = np.fmax.reduce(np.where(nl, -np.inf, g3), axis=2)
    nmax = np.fmax.reduce(np.where(nl, g3, -np.inf), axis=2)
    nmin = np.fmin.reduce(np.where(nl, g3, np.inf), axis=2)
    best_out = np.zeros(L, np.float32)
    idx_out = np.zeros(L, np.int32)
    with np.errstate(all="ignore"):
        for l in range(L):
            best, bidx, g = np.float32(-1e30), 0, 0
            nb = _nl_bounds(best, mid, tie_up)
            while True:
                nxt = G
                for g0 in range(g, G, 32):
                    gg = slice(g0, min(g0 + 32, G))
                    can = ((lmax[l, gg] > best)
                           | ((nmin[l, gg] <= nmax[l, gg])
                              & (_nl_passes(nb, nmax[l, gg])
                                 | _nl_passes(nb, nmin[l, gg]))))
                    if can.any():
                        nxt = g0 + int(np.argmax(can))
                        break
                if nxt >= G:
                    break
                g = nxt
                pos = 0
                for c0 in range(0, M, 32):
                    m = np.arange(c0, min(c0 + 32, M))
                    v = g3[l, g, m]
                    while True:
                        acc = (m >= pos) & np.where(nl[m], _nl_passes(nb, v),
                                                    v > best)
                        if not acc.any():
                            break
                        t = int(np.argmax(acc))
                        best, pos = v[t], int(m[t]) + 1
                        nb = _nl_bounds(best, mid, tie_up)
                        bidx = g * M + pos - 1
                g += 1
            best_out[l], idx_out[l] = best, bidx
    return best_out, idx_out


def _scan(sync, is_nl):
    """The literal scan: JAX's, or for grids holding subnormals the IEEE
    numpy scan, since XLA on the CPU reads subnormal inputs as zero (the
    kernel, like the reference's C walk, does not)."""
    with np.errstate(all="ignore"):
        tiny = np.finfo(np.float32).tiny
        subnormal = bool(((sync != 0) & (np.abs(sync) < tiny)).any())
    if subnormal:
        return literal_scan(sync, np.asarray(is_nl, bool), 10.0)
    bs, is_ = select_best_scan(jnp.asarray(sync), jnp.asarray(is_nl),
                               threshold=10.0)
    return np.asarray(bs), np.asarray(is_)


MODEL_CASES = {**{f"default bank, {k}": (v, np.asarray(_BANK.is_nonlinear))
                  for k, v in CASES.items()},
               "unordered bank, noise0": (CASES["noise0"], _unordered_bank()),
               "unordered bank, nan": (CASES["nan"], _unordered_bank()),
               "unordered bank, chunk edges": (_chunk_edges(),
                                               _unordered_bank()),
               "default bank, chunk edges": (
                   _chunk_edges(), np.asarray(_BANK.is_nonlinear)),
               "default bank, special values": (
                   special_lanes(np.asarray(_BANK.is_nonlinear))[0],
                   np.asarray(_BANK.is_nonlinear)),
               "unordered bank, special values": (
                   special_lanes(_unordered_bank())[0], _unordered_bank())}


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


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_kernel_model_matches_scan(name):
    """The kernel's algorithm equals the literal scan, for any bank order."""
    sync, is_nl = MODEL_CASES[name]
    b, i = _kernel_model(sync, is_nl, 10.0)
    bs, is_ = _scan(sync, is_nl)
    np.testing.assert_array_equal(i, is_)
    np.testing.assert_array_equal(b.view(np.int32), bs.view(np.int32))


def test_chunk_edge_cases_accept_on_the_edges():
    """The chunk-edge lanes' accept chains (a literal scan in Python) really
    step on models 31, 32, 63 and 64, with both banks."""
    sync = _chunk_edges()
    for nl in (np.asarray(_BANK.is_nonlinear), _unordered_bank()):
        seen = set()
        for lane in sync:
            best = np.float32(-1e30)
            with np.errstate(all="ignore"):
                for j, v in enumerate(lane.reshape(-1)):
                    m = j % _M
                    if (v / best > np.float32(10.0)) if nl[m] else v > best:
                        best = v
                        seen.add(m)
        assert {31, 32, 63, 64} <= seen


@pytest.mark.parametrize("bank", ["default", "unordered"])
def test_special_lanes_accept_the_special_values(bank):
    """The special-value lanes' accept chains (a literal scan in Python)
    step on -0, +0, subnormals, +inf, -inf and the near-threshold values,
    and pass over a value whose quotient is above the threshold only
    before rounding."""
    nl = (np.asarray(_BANK.is_nonlinear) if bank == "default"
          else _unordered_bank())
    sync, want = special_lanes(nl)
    seen = set()
    with np.errstate(all="ignore"):
        for lane in sync:
            best = np.float32(-1e30)
            for j, v in enumerate(lane.reshape(-1)):
                if (v / best > np.float32(10.0)) if nl[j % _M] else v > best:
                    best = v
                    seen.add(int(v.view(np.uint32)))
    assert {int(np.float32(v).view(np.uint32)) for v in want} <= seen


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_select_kernel_matches_scan_on_card_any_bank(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel-against-scan check)")
    sync, is_nl = MODEL_CASES[name]
    bk, ik = sel.select_best(torch.from_numpy(sync).cuda(),
                             torch.from_numpy(is_nl).cuda(), threshold=10.0)
    bs, is_ = _scan(sync, is_nl)
    np.testing.assert_array_equal(ik.cpu().numpy(), is_)
    np.testing.assert_array_equal(bk.cpu().numpy().view(np.int32),
                                  bs.view(np.int32))


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
