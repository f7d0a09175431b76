"""uwspr_tpu_torch.demod.finesync.lane_probe: the device engine's probe
calls as one kernel (csrc/probe_lanes.cu) and its plain chain.

On the CPU ``lane_probe`` is the plain chain (``lane_probe_plain``; the
bf16 form's calls counted in PLAIN_CALLS): the gather of
make_shared_probe_lanes at the lanes' window starts, probe_derotate and
shared_probe_eval, bit for bit what the device engine ran before the
kernel, phase B's slice [96, 480) included. The kernel's lane arithmetic (csrc/probe_lane.cuh) is built for
the host with g++ (utils/gxx_build.py) and held to that chain: the
derotated bf16 samples bit for bit, with the f32 phasor factors handed
in; each tone power bit for bit to the same sums taken in ascending order
by torch, and within f32 sum-order tolerance of shared_probe_eval's
products. The wrapper refuses what the kernel does not take.

On a card (tests marked ``cuda``) the kernel is held to the plain chain at
the four cells' shapes of each probe call (phase A, phase B's two drift
sets, the fine grid, the jiggles; 512, 256 and 64 lanes), with lanes
whose window crosses sample 0 or the window's end and lags clamped at
both ends of the window: bit for bit to the ascending-order sums of the
chain's own derotated samples and bank, and to the chain itself within
the tolerance stated below; a decode launches it once a probe call, eager
and in a captured replay's graph, and none of the chain's matrix products,
and the replay gives the bits of its eager run.

Imports nothing of JAX or the JAX package, so that the card's tests run
where only the port is installed:

    python3 -m pytest --noconftest tests/test_torch_probe_lanes.py -m cuda
"""

import ctypes
import pathlib

import numpy as np
import pytest
import torch

from uwspr_tpu_torch.config import PipelineConfig, with_serving_defaults
from uwspr_tpu_torch.demod import finesync as fs
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.pipeline import captured
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.modulate import synthesize_frame
from uwspr_tpu_torch.utils.gxx_build import load_gxx_library

CSRC = pathlib.Path(fs.__file__).resolve().parents[1] / "csrc"
N = 45000
DT = -2.0 * np.pi * (1.0 / 375.0)

# the four probe calls of a decode: (offsets of the lags about the lane's
# centre, freqs a lane, columns [off, off + width) of its 640-wide window
# at reach, drift sets)
CALLS = {
    "phase A": (tuple(range(-128, 129, 64)), 5, 0, 640, 128, 1),
    "phase B": ((0,), 1, 96, 384, 96, 2),
    "fine grid": (tuple(range(-32, 33, 16)), 5, 0, 640, 96, 1),
    "jiggles": (tuple(int(x) for x in fs.jiggle_offsets(17, 8)), 1, 0, 640,
                96, 1),
}


def _windows(W, seed):
    """(W, 2, N) f32: a frame at -18 dB in each window, noise around it."""
    rng = np.random.default_rng(seed)
    z = [awgn(synthesize_frame("K1ABC", "FN42", 37,
                               start_sample=int(rng.integers(0, 2000)),
                               freq_offset=float(rng.uniform(-5, 5))),
              -18, rng=rng) for _ in range(W)]
    return torch.from_numpy(np.stack([fs.complex_to_ri(x.astype(np.complex64))
                                      for x in z]))


def case(W, L, call, seed, device="cpu"):
    """The inputs of one probe call over L lanes of W windows: lane
    centres across the window (the first lanes at the start, where the
    window crosses sample 0 and the low lags clamp at b = 0, the last at
    the end, where the high lags clamp at width - 256), freqs within the
    passband, linear drifts of +-2 Hz."""
    offs, F, off, width, reach, D = CALLS[call]
    rng = np.random.default_rng(seed)
    ri = _windows(W, seed).to(device)
    widx = torch.from_numpy(rng.integers(0, W, L)).to(device)
    center = rng.integers(-160, 26 * 128 + 160, L)
    center[:3] = (-5000, -300, 0)
    center[-3:] = (N - 41472 - 64, N - 41472 + 128, N)
    center = torch.from_numpy(center).to(device)
    base = fs.lane_window_base(center, N, reach=reach, W=640, block=128)
    lags = center[:, None] + torch.tensor(offs, device=device)[None, :]
    freqs = torch.from_numpy(
        rng.uniform(-6, 6, (L, 1)) + 0.25 * np.arange(F)[None, :]
        ).float().to(device)
    i = torch.arange(162, dtype=torch.float32, device=device)
    dsyms = [(torch.from_numpy(rng.uniform(-2, 2, (L, 1))).float().to(
        device) / 2.0) * (i[None, :] - 81.0) / 81.0 for _ in range(D)]
    span = max(offs) - min(offs)
    return (ri, widx, base, dsyms, lags, freqs), dict(width=width, off=off,
                                                      span=span)


def chain(args, kw, dtype="bf16"):
    """The chain of the device engine before the kernel: one 640-wide
    window a lane from make_shared_probe_lanes' gather, sliced to the
    call's columns, derotated and probed once a drift set."""
    ri, widx, base, dsyms, lags, freqs = args
    z_all = torch.complex(ri[:, 0], ri[:, 1])
    pdt = "bf16" if dtype == "bf16" else "c64"
    A = fs._lane_windows(z_all, widx, base, 640, pdt)
    A = A[..., kw["off"]:kw["off"] + kw["width"]]
    return [fs.shared_probe_eval(fs.probe_derotate(A, d), base + kw["off"],
                                 lags, freqs, n_lags=lags.shape[1],
                                 want_symbols=True, dtype=dtype)
            for d in dsyms]


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_cpu_lane_probe_is_the_chain():
    """On the CPU lane_probe is the plain chain, bit for bit what the
    decoder computed before (a window gathered at the call's columns is
    the 640-wide window's slice), in both dtypes."""
    for call in ("phase A", "phase B"):
        args, kw = case(2, 6, call, 1)
        for dtype in ("bf16", "f32"):
            fs.reset_counters()
            got = fs.lane_probe(*args, dtype=dtype, **kw)
            # the f32 form is no kernel's plain version
            assert (fs.KERNEL_LAUNCHES, fs.PLAIN_CALLS) == (
                0, int(dtype == "bf16"))
            want = chain(args, kw, dtype)
            assert len(got) == len(want) == len(args[3])
            for (s, p), (s0, p0) in zip(got, want):
                assert p.shape == p0.shape
                assert p.stride() == p0.stride() or p.shape[2] == 1
                assert torch.equal(_bits(p), _bits(p0))
                assert torch.equal(_bits(s), _bits(s0))


def test_cpu_decode_runs_four_plain_probe_calls():
    """A decode makes four probe calls: phase A, phase B (both drifts in
    one), the fine grid and the jiggles."""
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), 2),
                        device="cpu")
    fs.reset_counters()
    dec.prefano(_windows(2, 3))
    assert (fs.KERNEL_LAUNCHES, fs.PLAIN_CALLS) == (0, 4)


@pytest.mark.parametrize("bad", ["ri", "lags", "freqs", "width", "columns",
                                 "dsym", "sets", "span", "device"])
def test_probe_lanes_refuses_bad_inputs(bad):
    args, kw = case(1, 3, "phase A", 2)
    ri, widx, base, dsyms, lags, freqs = args
    if bad == "ri":
        ri = ri.double()
    elif bad == "lags":
        lags = lags.repeat(1, 7)                 # 35 lags
    elif bad == "freqs":
        freqs = freqs.repeat(1, 2)               # 10 freqs
    elif bad == "width":
        kw["width"] = 600
    elif bad == "columns":
        kw["off"] = 64
    elif bad == "dsym":
        dsyms = [dsyms[0][:, :100]]
    elif bad == "sets":
        dsyms = dsyms * 3
    elif bad == "span":
        kw["span"] = -1
    with pytest.raises(ValueError):
        fs.probe_lanes(ri, widx, base, dsyms, lags, freqs, **kw)


# --- the lane header on the host ---------------------------------------

_SHIM = r"""
#include <stdint.h>
extern "C" {
// (n,) f32 samples (re, im), guard, f32 factors -> (n,) derotated
void derotate_n(const float* re, const float* im, const uint8_t* inside,
                const float* f, int n, float* zr, float* zi) {
  using namespace uwspr_probe;
  for (int k = 0; k < n; ++k) {
    const uint32_t a = inside[k] ? pack_bf16x2(re[k], im[k]) : 0u;
    const uint32_t z = derotate(a, pack_bf16x2(f[4 * k], f[4 * k + 1]),
                                pack_bf16x2(f[4 * k + 2], f[4 * k + 3]));
    zr[k] = lo_of(z);
    zi[k] = hi_of(z);
  }
}
// derotated rows zr, zi (L, 162, W), tone rows br, bi (L, M, W), offsets
// b (L, NL) -> powers p (L, 162, NL, M)
void powers_n(const float* zr, const float* zi, const float* br,
              const float* bi, const int32_t* b, int L, int M, int NL,
              int W, float* p) {
  using namespace uwspr_probe;
  for (int l = 0; l < L; ++l)
    for (int i = 0; i < kNSym; ++i)
      for (int g = 0; g < NL; ++g)
        for (int m = 0; m < M; ++m) {
          const size_t z = (static_cast<size_t>(l) * kNSym + i) * W;
          const size_t t = (static_cast<size_t>(l) * M + m) * W;
          p[((static_cast<size_t>(l) * kNSym + i) * NL + g) * M + m] =
              probe_power(zr + z, zi + z, br + t, bi + t, b[l * NL + g]);
        }
}
}
"""


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    """csrc/probe_lane.cuh with a C shim, built by utils/gxx_build.py (the
    header's text is in the source, so an edited header is rebuilt)."""
    src = tmp_path_factory.mktemp("probe_lane") / "probe_lane_shim.cc"
    src.write_text((CSRC / "probe_lane.cuh").read_text() + _SHIM)

    def configure(lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.derotate_n.argtypes = [vp, vp, vp, vp, ci, vp, vp]
        lib.powers_n.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    return load_gxx_library(src, configure)


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _derotate_host(lib, re, im, inside, factors):
    n = re.size
    zr, zi = np.empty(n, np.float32), np.empty(n, np.float32)
    lib.derotate_n(_ptr(re), _ptr(im), _ptr(inside), _ptr(factors), n,
                   _ptr(zr), _ptr(zi))
    return zr, zi


def test_lane_header_derotates_as_the_chain(lane_lib):
    """The header's derotation of each sample, from the f32 input and the
    f32 cos/sin factors torch computes, is probe_derotate's bf16 sample
    bit for bit (signed zeros and the samples outside 1 <= n < N
    included)."""
    (ri, widx, base, dsyms, lags, freqs), kw = case(2, 6, "jiggles", 4)
    W = kw["width"]
    z_all = torch.complex(ri[:, 0], ri[:, 1])
    A = fs._lane_windows(z_all, widx, base, W, "bf16")
    want = fs.probe_derotate(A, dsyms[0])                # (L, 2, 162, W)
    # the inputs the kernel reads: f32 samples, the guard, the factors
    pos = (base[:, None, None] - 4096 + 256 * torch.arange(162)[None, :, None]
           + torch.arange(W)[None, None, :])
    inside = (pos >= 1) & (pos < N)
    wi = widx[:, None, None].expand_as(pos)
    posc = pos.clamp(0, N - 1)
    re, im = ri[wi, 0, posc], ri[wi, 1, posc]
    theta = DT * dsyms[0]
    a1, a2 = fs._ramp_angles(theta, W)
    j = torch.arange(W)
    f = torch.stack([torch.cos(a1)[..., j % 64], torch.sin(a1)[..., j % 64],
                     torch.cos(a2)[..., j // 64], torch.sin(a2)[..., j // 64]],
                    dim=-1)                               # (L, 162, W, 4)
    zr, zi = _derotate_host(
        lane_lib, np.ascontiguousarray(re.numpy(), np.float32),
        np.ascontiguousarray(im.numpy(), np.float32),
        np.ascontiguousarray(inside.numpy(), np.uint8),
        np.ascontiguousarray(f.numpy(), np.float32))
    got = np.stack([zr, zi]).reshape((2,) + tuple(pos.shape))
    want = want.float().numpy().transpose(1, 0, 2, 3)
    assert not inside.all() and inside.any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def sequential_powers(zd, bank, b):
    """Tone powers (L, 162, NL, M) from derotated rows zd (L, 2, 162, W)
    and tone rows bank (L, 2, M, W), each probe's four sums taken over its
    256 samples [b, b + 256) in ascending order by torch (b (L, NL)): the
    kernel's order and rounding."""
    L, _, _, W = zd.shape
    M = bank.shape[2]
    NL = b.shape[1]
    zr, zi = zd[:, 0].float(), zd[:, 1].float()
    br, bi = bank[:, 0].float(), bank[:, 1].float()
    acc = [torch.zeros((L, 162, NL, M), device=zd.device) for _ in range(4)]
    for k in range(256):
        j = b + k                                        # (L, NL)
        zrk = torch.gather(zr, 2, j[:, None, :].expand(L, 162, NL))
        zik = torch.gather(zi, 2, j[:, None, :].expand(L, 162, NL))
        brk = torch.gather(br, 2, j[:, None, :].expand(L, M, NL))
        bik = torch.gather(bi, 2, j[:, None, :].expand(L, M, NL))
        zrk, zik = zrk[..., None], zik[..., None]        # (L, 162, NL, 1)
        brk, bik = brk.transpose(1, 2)[:, None], bik.transpose(1, 2)[:, None]
        acc[0] = acc[0] + zrk * brk
        acc[1] = acc[1] + zik * bik
        acc[2] = acc[2] + zrk * bik
        acc[3] = acc[3] + zik * brk
    re = acc[0] - acc[1]
    im = acc[2] + acc[3]
    # the IEEE f32 root (an f64 root of an f32 rounds to it), as sqrtf on
    # the card computes it; torch's f32 sqrt on the CPU misses it by an
    # ulp at times
    return torch.sqrt((re * re + im * im).double()).float()


def chain_operands(args, kw, d=0):
    """The derotated rows, the bf16 bank and the offsets of the chain."""
    ri, widx, base, dsyms, lags, freqs = args
    W, off = kw["width"], kw["off"]
    z_all = torch.complex(ri[:, 0], ri[:, 1])
    zd = fs.probe_derotate(fs._lane_windows(z_all, widx, base + off, W,
                                            "bf16"), dsyms[d])
    ft = freqs[..., None] + fs.probe_constants(ri.device)["tones"]
    bank = fs.phasor_ramp(DT * ft, W).reshape(len(widx), -1, W)
    bank = torch.stack([bank.real.to(torch.bfloat16),
                        bank.imag.to(torch.bfloat16)], dim=1)
    b = torch.clamp(lags + 4096 - (base + off)[:, None], 0, W - 256)
    return zd, bank, b


def test_lane_header_sums_as_torch_in_order(lane_lib):
    """The header's tone power is the ascending-order sums bit for bit, and
    shared_probe_eval's products within f32 sum-order tolerance."""
    args, kw = case(2, 6, "fine grid", 5)
    zd, bank, b = chain_operands(args, kw)
    L, _, _, W = zd.shape
    M, NL = bank.shape[2], b.shape[1]
    host = [np.ascontiguousarray(x.float().numpy(), np.float32)
            for x in (zd[:, 0], zd[:, 1], bank[:, 0], bank[:, 1])]
    bo = np.ascontiguousarray(b.numpy(), np.int32)
    p = np.empty((L, 162, NL, M), np.float32)
    lane_lib.powers_n(*map(_ptr, host), _ptr(bo), L, M, NL, W, _ptr(p))
    seq = sequential_powers(zd, bank, b).numpy()
    np.testing.assert_array_equal(p.view(np.int32), seq.view(np.int32))
    [(_, p0)] = chain(args, kw)                          # (L, F, NL, 162, 4)
    p0 = p0.permute(0, 3, 2, 1, 4).reshape(L, 162, NL, M).numpy()
    np.testing.assert_allclose(p, p0, rtol=2e-5, atol=2e-5 * p0.max())


# --- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel-against-plain check)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("W, L", [(32, 512), (128, 256), (32, 64)])
@pytest.mark.parametrize("call", list(CALLS))
def test_kernel_matches_the_chain_on_card(W, L, call, monkeypatch):
    card = _card()
    args, kw = case(W, L, call, 6, card)
    lags, base = args[4], args[2]
    b = lags + 4096 - (base + kw["off"])[:, None]
    assert bool((b <= 0).any() and (b >= kw["width"] - 256).any())
    fs.reset_counters()
    got = fs.lane_probe(*args, **kw)
    torch.cuda.synchronize()
    assert (fs.KERNEL_LAUNCHES, fs.PLAIN_CALLS) == (1, 0)
    want = fs.lane_probe_plain(*args, width=kw["width"], off=kw["off"])
    for d, ((s, p), (s0, p0)) in enumerate(zip(got, want)):
        assert p.shape == p0.shape
        assert [st for st, n in zip(p.stride(), p.shape) if n > 1] == \
            [st for st, n in zip(p0.stride(), p0.shape) if n > 1]
        zd, bank, bo = chain_operands(args, kw, d)
        seq = sequential_powers(zd, bank, bo)
        Lp, F, NL = p.shape[:3]
        assert torch.equal(_bits(p.permute(0, 3, 2, 1, 4).reshape(seq.shape)),
                           _bits(seq))
        # against the library chain: the same bits where cuBLAS sums each
        # product in ascending order; stated otherwise
        dp = (p - p0).abs().max().item()
        ds = (s - s0).abs().max().item()
        print(f"{call} W={W} L={L} d={d}: max |p - chain| {dp:.3g} "
              f"(p max {p0.max().item():.3g}), max |sync - chain| {ds:.3g}")
        assert dp <= 2e-5 * p0.max().item() and ds <= 1e-5
    # no matrix product of the chain on the kernel's path
    def refuse(*a, **k):
        raise AssertionError("library product on the kernel's path")
    monkeypatch.setattr(fs.torch, "bmm", refuse)
    fs.lane_probe(*args, **kw)


@pytest.mark.cuda
def test_decode_launches_the_kernel_once_a_call_on_card():
    """An eager decode launches the kernel once a probe call (four), a
    captured graph holds four of its nodes, and a replay's output is
    bitwise its eager run's."""
    card = _card()
    W = 8
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), W),
                        device=card)
    ri = _windows(W, 7).to(card)
    fs.reset_counters()
    with captured.eager():
        eager_out = dec.decode_windows_ri(ri).cpu()
    assert (fs.KERNEL_LAUNCHES, fs.PLAIN_CALLS) == (4, 0)
    captured.reset_replay_launches()
    first = dec.decode_windows_ri(ri).cpu()       # captures
    replay = dec.decode_windows_ri(ri).cpu()      # replays
    assert captured.REPLAY_LAUNCHES["probe_lanes"] == 4
    assert torch.equal(_bits(first), _bits(eager_out))
    assert torch.equal(_bits(replay), _bits(eager_out))
    assert dec.unpack_output(eager_out).success.any()
