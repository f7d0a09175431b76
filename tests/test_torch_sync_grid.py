"""uwspr_tpu_torch.coarse.search.sync_grid: the coarse sync grid as one
gather-sum kernel (csrc/sync_grid.cu) and its plain version.

On the CPU ``sync_grid`` is ``sync_grid_plain`` (counted in PLAIN_CALLS),
and the wrapper refuses what the kernel does not take. On a card (tests
marked ``cuda``) the kernel is held bit for bit to ``sync_grid_plain`` at
each benchmark cell's shape (narrowband W = 128 and W = 32, 42 columns of
a 48-column spectrum, C = 13, f32 planes; wideband W = 32, the whole
512-column spectrum, C = 200, bf16 planes), with lanes that wrap at
column 0 and lanes that clamp past the top column; two models with equal
offset rows score bit-equal; a decode launches the kernel once and none
of the library convolution or matrix product, and a captured replay
gives the bits of its eager run.

Imports nothing of JAX or the JAX package, so that the card's tests run
where only the port is installed:

    python3 -m pytest --noconftest tests/test_torch_sync_grid.py -m cuda
"""

import numpy as np
import pytest
import torch

from uwspr_tpu_torch.coarse import search
from uwspr_tpu_torch.config import CoarseConfig, PipelineConfig
from uwspr_tpu_torch.config import with_serving_defaults
from uwspr_tpu_torch.demod.finesync import complex_to_ri
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.pipeline import captured
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.constants import SYNC_VECTOR
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

NARROW = CoarseConfig()
WIDE = CoarseConfig(halfbandwidth=187)


def bank(cfg=NARROW):
    offs = torch.from_numpy(search.build_drift_models(cfg).offsets)
    sign = torch.from_numpy(2.0 * SYNC_VECTOR.astype(np.float32) - 1.0)
    return offs, sign


def case(W, C, wide, seed):
    """(ps, if0, lo, width) of a cell's shape: exponential powers over the
    decoder's column window; candidate bins drawn over the passband, with
    the first window's lanes at the spectrum's edges (bin 0 wraps, the top
    bin clamps) and a repeated bin (a padded lane)."""
    rng = np.random.default_rng(seed)
    cfg = WIDE if wide else NARROW
    m, hp = cfg.fft_size // 2, cfg.hpbm
    cb0 = max(0, m - hp - 10)
    size = min(cfg.fft_size, m + hp + 10) - cb0
    lo, width = search.grid_window(size,
                                   (m - hp - 7 - cb0, m + hp + 7 - cb0))
    ps = rng.exponential(1.0, size=(W, cfg.n_ffts, size)).astype(np.float32)
    if0 = rng.integers(m - hp + 1, m + hp - 1, size=(W, C)) - cb0
    edge = [lo, lo + width - 1, lo + 1, lo + width - 2][:C]
    if0[0, :len(edge)] = edge
    if0[-1, -3:] = if0[-1, -1]
    return torch.from_numpy(ps), torch.from_numpy(if0), lo, width


def test_cpu_sync_grid_is_the_plain_version():
    ps, if0, lo, width = case(2, 5, False, 0)
    offs, sign = bank()
    ifr = search.grid_columns(if0, lo, width)
    search.reset_counters()
    got = search.sync_grid(ps, ifr, offs, sign, lo=lo, width=width)
    assert (search.KERNEL_LAUNCHES, search.PLAIN_CALLS) == (0, 1)
    want = search.sync_grid_plain(ps, ifr, offs, sign, lo=lo, width=width)
    assert got.shape == (2, 5, 5, 26, offs.shape[0])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("bad", ["dtype", "ps", "ifr", "offsets", "window",
                                 "rows"])
def test_sync_grid_refuses_bad_inputs(bad):
    ps, if0, lo, width = case(1, 3, False, 1)
    offs, sign = bank()
    ifr = search.grid_columns(if0, lo, width)
    kw = dict(lo=lo, width=width, dtype="f32")
    if bad == "dtype":
        kw["dtype"] = "f16"
    elif bad == "ps":
        ps = ps.double()
    elif bad == "ifr":
        ifr = ifr[..., :4]
    elif bad == "offsets":
        offs = offs[:, :100]
    elif bad == "window":
        kw["width"] = ps.shape[-1]
    else:
        ps = ps[:, :300]
    with pytest.raises(ValueError):
        search.sync_grid(ps, ifr, offs, sign, **kw)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel-against-plain check)")
    return torch.device("cuda", 0)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("W, C, wide", [(128, 13, False), (32, 13, False),
                                        (32, 200, True)])
def test_kernel_matches_plain_on_card(W, C, wide, monkeypatch):
    card = _card()
    ps, if0, lo, width = case(W, C, wide, 2)
    offs, sign = bank(WIDE if wide else NARROW)
    dtype = "bf16" if wide else "f32"
    ps, if0, offs, sign = (t.to(card) for t in (ps, if0, offs, sign))
    ifr = search.grid_columns(if0, lo, width)
    assert bool((ifr[0, 0] == 0).any() and (ifr[0, 1] == width - 1).any())
    search.reset_counters()
    got = search.sync_grid(ps, ifr, offs, sign, lo=lo, width=width,
                           dtype=dtype)
    torch.cuda.synchronize()
    assert search.KERNEL_LAUNCHES == 1
    want = search.sync_grid_plain(ps, ifr, offs, sign, lo=lo, width=width,
                                  dtype=dtype)
    assert got.shape == want.shape == (W, C, 5, 26, offs.shape[0])
    assert torch.equal(_bits(got), _bits(want))
    # coarse_score_grid takes the kernel, and neither the library
    # convolution nor the einsum
    def refuse(*a, **k):
        raise AssertionError("library call on the card's grid path")
    monkeypatch.setattr(search.F, "conv2d", refuse)
    monkeypatch.setattr(search.torch, "einsum", refuse)
    g = search.coarse_score_grid(ps, if0, offs, sign, dtype=dtype,
                                 f_window=(lo, lo + width))
    assert torch.equal(_bits(g), _bits(want))
    assert search.KERNEL_LAUNCHES == 2


@pytest.mark.cuda
def test_equal_offset_rows_score_equal_on_card():
    card = _card()
    ps, if0, lo, width = case(4, 13, False, 3)
    offs, sign = bank()
    offs = offs.clone()
    offs[7] = offs[90]
    ps, if0, offs, sign = (t.to(card) for t in (ps, if0, offs, sign))
    g = search.sync_grid(ps, search.grid_columns(if0, lo, width), offs,
                         sign, lo=lo, width=width)
    assert torch.equal(_bits(g[..., 7]), _bits(g[..., 90]))


def _windows(n, seed=4):
    rng = np.random.default_rng(seed)
    z = [awgn(synthesize_frame("K1ABC", "FN42", 37,
                               start_sample=int(rng.integers(0, 2000)),
                               freq_offset=float(rng.uniform(-5, 5))),
              -18, rng=rng) for _ in range(n)]
    return np.stack([complex_to_ri(x.astype(np.complex64)) for x in z])


@pytest.mark.cuda
def test_decode_launches_the_kernel_once_on_card():
    """An eager decode launches the kernel once; a captured replay's output
    is bitwise its eager run's."""
    card = _card()
    W = 8
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), W),
                        device=card)
    ri = torch.from_numpy(_windows(W)).to(card)
    search.reset_counters()
    with captured.eager():
        eager_out = dec.decode_windows_ri(ri).cpu()
    assert (search.KERNEL_LAUNCHES, search.PLAIN_CALLS) == (1, 0)
    first = dec.decode_windows_ri(ri).cpu()       # captures
    replay = dec.decode_windows_ri(ri).cpu()      # replays
    assert torch.equal(_bits(first), _bits(eager_out))
    assert torch.equal(_bits(replay), _bits(eager_out))
    assert dec.unpack_output(eager_out).success.any()
