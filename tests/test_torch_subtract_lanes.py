"""The device multipass: the subtraction kernel's CPU twin
(ops/subtract.py, csrc/subtract_lanes_host.cc + csrc/subtract_lane.cuh)
against pipeline/multipass.py::subtract_spot, and DeviceDecoder's batch
program at ``multipass.passes`` > 1 against multipass_spots.

Scenes, made with numpy from a seed: tests/test_multipass.py's masked
scene (a strong "VE3EMB FN25 30" at 0 Hz and a weak "K1ABC FN42 37" 1.5 Hz
away, 9 dB down, at -13 dB; seed 100), rebuilt here from the port's own
synthesis so that no JAX is imported, and a clean frame at -15 dB. The
decoders run on the CPU at maxcycles 2000 with module-scoped decoders and
at most two windows.

Tolerance of a subtracted window: every sample within 1e-6 of the largest
sample of subtract_spot's, and the polished lags equal. Why: both sides
compute in float64 and round the replica and the fitted frame to
complex64 (2**-24 of a sample), and the kernel's phase, P_i + k d_i a
symbol, differs from numpy's running sum over the frame by under 1e-9
rad: a residual sample then differs by a float32 ulp or two of the
fitted frame at most (about 1e-7 of the largest sample). A replica whose
phase runs in float32, as a float32 ramp would, is off by about 1e-4 rad
at the frame's end and fails it (checked below).

On a card (``cuda``) the kernel is held to the twin and to subtract_spot
at the same tolerance, with several lanes a window, inactive lanes and
lags past both ends of the window; a multipass decode launches it once a
subtraction stage, and a captured replay gives its eager run's bits. This
file imports nothing of JAX or the JAX package:

    python3 -m pytest --noconftest tests/test_torch_subtract_lanes.py -m cuda
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

from uwspr_tpu_torch import cli
from uwspr_tpu_torch.config import (DemodConfig, MultipassConfig,
                                    PipelineConfig, with_serving_defaults)
from uwspr_tpu_torch.demod.finesync import complex_to_ri
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.ops import marks
from uwspr_tpu_torch.ops import subtract as S
from uwspr_tpu_torch.pipeline import captured, device_decoder
from uwspr_tpu_torch.pipeline import multipass as mp
from uwspr_tpu_torch.pipeline import stream
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.fec_encode import channel_symbols
from uwspr_tpu_torch.protocol.modulate import synthesize_frame
from wsprbench import gen

STRONG = ("VE3EMB", "FN25", 30, "VE3EMB FN25 30")
WEAK = ("K1ABC", "FN42", 37, "K1ABC FN42 37")
CFG = PipelineConfig(demod=DemodConfig(maxcycles=2000))
TOL = 1e-6


def masked_scene(seed, sep_hz=1.5, weak_rel_db=-9.0, strong_snr=-13.0):
    """tests/test_multipass.py::_masked_scene on the port's synthesis."""
    rng = np.random.default_rng(seed)
    strong = synthesize_frame(*STRONG[:3],
                              start_sample=int(rng.integers(500, 2500)),
                              freq_offset=0.0)
    weak = synthesize_frame(*WEAK[:3],
                            start_sample=int(rng.integers(500, 2500)),
                            freq_offset=sep_hz)
    a = 10.0 ** (weak_rel_db / 20.0)
    return awgn(strong + a * weak, strong_snr, rng=rng)


MASKED = masked_scene(100)
CLEAN = awgn(synthesize_frame(*STRONG[:3], start_sample=750,
                              freq_offset=1.23),
             -15, rng=np.random.default_rng(0))


def passes_config(p, serving_w=None):
    cfg = dc.replace(CFG, multipass=MultipassConfig(passes=p))
    return with_serving_defaults(cfg, serving_w) if serving_w else cfg


@pytest.fixture(scope="module")
def single():
    return DeviceDecoder(CFG, device="cpu")


@pytest.fixture(scope="module")
def spots(single):
    """The first spot of each scene (the strong frame), decoded by the
    single-pass program, and a hand-made SLM spot on its payload."""
    out = {name: single.spots(single(z))[0]
           for name, z in (("clean", CLEAN), ("masked", MASKED))}
    assert [s.message for s in out.values()] == [STRONG[3]] * 2
    s = out["clean"]
    out["slm"] = dc.replace(s, mode=1, slm_params=(1.0, -2.0, 0.0, 250.0),
                            drift=0.0, jiggle=3)
    return out


def lanes(spots_by_window, cfg=CFG, device="cpu"):
    """The subtract_lanes arguments of spots, a list of lists by window."""
    flat = [(w, s) for w, ss in enumerate(spots_by_window) for s in ss]
    t = torch.tensor
    return dict(
        widx=t([w for w, _ in flat]),
        active=t([True] * len(flat)),
        payload=t([list(s.payload[:7]) for _, s in flat], dtype=torch.uint8),
        freq=t([s.freq for _, s in flat], dtype=torch.float32),
        lag=t([mp.spot_lag(s, cfg) for _, s in flat]),
        mode=t([s.mode for _, s in flat]),
        drift=t([s.drift for _, s in flat], dtype=torch.float32),
        slm=t([list(s.slm_params) if s.mode else [0.0] * 4
               for _, s in flat], dtype=torch.float32))


def ri_of(zs):
    return torch.from_numpy(np.stack([complex_to_ri(
        np.asarray(z, np.complex64)) for z in zs]))


def run_lanes(zs, spots_by_window, device="cpu", **kw):
    ri = ri_of(zs).to(device)
    a = {k: v.to(device) for k, v in lanes(spots_by_window).items()}
    info = S.subtract_lanes(ri, a["widx"], a["active"], a["payload"],
                            a["freq"], a["lag"], a["mode"], a["drift"],
                            a["slm"], cf=1500.0, **kw)
    ri = ri.cpu().numpy()
    return ri[:, 0] + 1j * ri[:, 1], info.cpu().numpy()


def numpy_lags(z, spot):
    """subtract_spot's two polished lags, by its own steps."""
    sym = mp.spot_channel_symbols(spot.payload)
    dsym = mp.spot_drift_offsets(spot, 1500.0)
    z = np.asarray(z)

    def polish(ref, lag):
        def captured_energy(lg):
            c, cnt = mp._symbol_gains(z, ref, lg)
            return float(np.sum(cnt * np.abs(c) ** 2))
        return max(range(lag - 16, lag + 17), key=captured_energy)
    freq = float(spot.freq)
    ramp = (np.arange(162) - 81.0) / 162.0
    lag1 = lag = polish(mp._replica(sym, freq, dsym), mp.spot_lag(spot, CFG))
    for _ in range(3):
        c, cnt = mp._symbol_gains(z, mp._replica(sym, freq, dsym), lag)
        df, dd = mp._residual_freq_drift(c, cnt)
        if abs(df) < 1e-4 and abs(dd) < 1e-3:
            break
        freq += df
        dsym = dsym + dd * ramp
    return lag1, polish(mp._replica(sym, freq, dsym), lag)


def within(got, want):
    return float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())


@pytest.mark.parametrize("scene,spot", [("clean", "clean"),
                                        ("masked", "masked"),
                                        ("clean", "slm"), ("masked", "slm")])
def test_twin_matches_subtract_spot(scene, spot, spots, monkeypatch):
    z = {"clean": CLEAN, "masked": MASKED}[scene]
    s = spots[spot]
    want = mp.subtract_spot(z, s, CFG)
    S.reset_counters()
    got, info = run_lanes([z], [[s]])
    assert S.PLAIN_CALLS == 1 and S.KERNEL_LAUNCHES == 0
    assert got.shape == (1, 45000)
    assert within(got[0].astype(np.complex64), want)
    assert tuple(info[0, :2].astype(int)) == numpy_lags(z, s)
    if spot != "slm":       # a decoded frame cancels below -18 dB
        assert float(np.abs(got[0]).max()) < float(np.abs(z).max())

    def f32_replica(symbols, freq, dsym):
        tone = (mp.TONE_OFFSETS[symbols] * mp.TONE_SPACING + freq + dsym)
        dphi = (2.0 * np.pi * np.repeat(tone, 256) / 375.0).astype(
            np.float32)
        phase = np.concatenate([[0.0], np.cumsum(dphi, dtype=np.float32)
                                [:-1]])
        return np.exp(1j * phase).astype(np.complex64)
    monkeypatch.setattr(mp, "_replica", f32_replica)
    assert not within(mp.subtract_spot(z, s, CFG), want)


def test_two_windows_lanes_in_order(spots):
    """Two spots of one window are subtracted in lane order, the second
    fitted against the first's residual (multipass_spots' loop); an
    inactive lane changes nothing; windows are independent."""
    s1, s2 = spots["masked"], dc.replace(spots["masked"], freq=1.5,
                                         shift=spots["masked"].shift + 64)
    seq = mp.subtract_spot(mp.subtract_spot(MASKED, s1, CFG), s2, CFG)
    got, _ = run_lanes([MASKED, CLEAN], [[s1, s2], [spots["clean"]]])
    assert within(got[0].astype(np.complex64), seq)
    assert within(got[1].astype(np.complex64),
                  mp.subtract_spot(CLEAN, spots["clean"], CFG))
    ri = ri_of([CLEAN])
    a = lanes([[spots["clean"]]])
    a["active"][:] = False
    S.subtract_lanes(ri, *(a[k] for k in ("widx", "active", "payload",
                                          "freq", "lag", "mode", "drift",
                                          "slm")), cf=1500.0)
    assert torch.equal(ri, ri_of([CLEAN]))


def test_channel_symbols_match_the_encoder():
    """The lane's re-encoding of every benchmark message and of random
    payloads equals fec_encode.channel_symbols."""
    import ctypes
    _, pays, syms = gen.message_table()
    rng = np.random.default_rng(3)
    rand = rng.integers(0, 256, (20, 7)).astype(np.uint8)
    rand[:, 6] &= 0xC0                   # 50 bits
    pays = np.ascontiguousarray(np.concatenate([pays, rand]))
    want = np.stack([channel_symbols(np.unpackbits(p)[:50]) for p in pays])
    assert np.array_equal(want[:100], syms)
    lib = S.load_twin()
    got = np.zeros_like(want)
    lib.uwspr_subtract_symbols_host.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int,
                                                ctypes.c_void_p]
    lib.uwspr_subtract_symbols_host(pays.ctypes.data, len(pays),
                                    got.ctypes.data)
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def two_pass():
    return DeviceDecoder(passes_config(2), device="cpu")


def test_two_passes_unmask_the_weak_frame(two_pass, single):
    """DeviceDecoder at passes 2 on the masked scene: the strong frame in
    pass 1, the weak one in pass 2, as multipass_spots on the
    single-pass program gives them; one subtraction, a window each pass,
    fano_attempts the sum of the passes'."""
    host = mp.multipass_spots(MASKED, lambda z: single.spots(single(z)),
                              CFG, passes=2)
    want = [(s.message, s.pass_index) for s in host]
    assert want == [(STRONG[3], 0), (WEAK[3], 1)]
    S.reset_counters()
    two_pass.mp_counts.zero_()
    out = two_pass.decode_batch(np.stack([MASKED, MASKED]))
    assert S.PLAIN_CALLS == 1
    C = two_pass.n_cand
    assert out.success.shape == (2, 2 * C)
    for w in range(2):
        got = two_pass.spots(out.window(w))
        assert [(s.message, s.pass_index) for s in got] == want
        assert all(s.candidate < C for s in got)
    assert two_pass.mp_tally() == {
        "decodes": 1, "subtracted": 2, "over_cap": 0, "duplicates": 0,
        "windows_pass1": 2, "spots_pass1": 2, "windows_pass2": 2,
        "spots_pass2": 2}
    one = single.decode_batch(np.stack([MASKED]))
    assert out.fano_attempts[0] > one.fano_attempts[0]


def test_later_pass_only_where_subtracted_and_no_duplicates(spots,
                                                            monkeypatch):
    """A window with nothing decoded is not decoded again (no gated lane
    in pass 2), a frame decoded again in a later pass is reported once
    (a residual that still holds it), and a frame over the cap is counted
    in fano_overflow and not subtracted."""
    noise = awgn(np.zeros(45000, np.complex64), -13,
                 rng=np.random.default_rng(5))
    # no lag or frequency polish: what is subtracted does not matter here
    monkeypatch.setattr(device_decoder, "LAG_SEARCH", 0)
    monkeypatch.setattr(device_decoder, "FREQ_ITERS", 0)
    cfg = dc.replace(passes_config(2), multipass=MultipassConfig(
        passes=2, subtract_max_lanes=1))
    dec = DeviceDecoder(cfg, device="cpu")
    out = dec.decode_batch(np.stack([CLEAN, noise]))
    C = dec.n_cand
    got = [[(s.message, s.pass_index) for s in dec.spots(out.window(w))]
           for w in range(2)]
    assert got == [[(STRONG[3], 0)], []]
    t = dec.mp_tally()
    assert (t["windows_pass2"], t["spots_pass2"]) == (1, 0)
    assert not out.valid[1, C:].any()
    # the cap: two windows with a decode each, one subtracted
    dec.mp_counts.zero_()
    out = dec.decode_batch(np.stack([CLEAN, CLEAN]))
    t = dec.mp_tally()
    assert (t["subtracted"], t["over_cap"], t["windows_pass2"]) == (1, 1, 1)
    assert list(out.fano_overflow) == [0, 1]
    assert t["duplicates"] + t["spots_pass2"] <= 1
    # a later decode of an earlier payload within DUP_FREQ_HZ is dropped
    w1 = [(s.message, s.pass_index) for s in dec.spots(out.window(1))]
    assert w1 == [(STRONG[3], 0)]


def test_one_pass_is_the_single_pass_program(single, two_pass):
    """At passes 1 the batch program is the parent's body (prefano, the
    Fano and OSD, the pack) and nothing else: bit for bit, the same
    markers, no subtraction, an untouched tally, (W, C, 23); and a
    multipass program's first C slots are that program's output but the
    per-window sums."""
    ri = ri_of([MASKED, CLEAN])
    seen = []
    real = marks.mark
    with pytest.MonkeyPatch.context() as m:
        m.setattr(marks, "mark", lambda s, x: (seen.append(s), real(s, x)))
        m.setattr(DeviceDecoder, "_decode_passes", None)
        got = single.decode_windows_ri(ri)
    with torch.no_grad():
        want = single._pack(single._fano_select_batch(single.prefano(ri)))
    assert torch.equal(got, want)
    assert seen == [s for s in marks.STAGES if s not in ("osd", "subtract")]
    assert not single.mp_counts.any()
    C = single.n_cand
    multi = two_pass.decode_windows_ri(ri)
    assert multi.shape == (2, 2 * C, 23) and got.shape == (2, C, 23)
    cols = [c for c in range(23) if c not in (20, 21)]
    assert torch.equal(multi[:, :C, cols], got[:, :, cols])


def test_refusals():
    with pytest.raises(ValueError):
        DeviceDecoder(passes_config(0), device="cpu")
    with pytest.raises(ValueError):
        DeviceDecoder(passes_config(2), device="cpu", fano_mode="host")
    assert with_serving_defaults(passes_config(3), 32) \
        .multipass.subtract_max_lanes == 64


def test_serve_native_device_passes_builds_its_decoder(monkeypatch):
    """serve --runtime native --engine device --passes 2 parses and builds
    a BatchedStreamDecoder whose device decoder runs two passes; the
    hybrid engine is refused."""
    built = []

    class Built(Exception):
        pass
    init = stream.BatchedStreamDecoder.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        built.append(self)
        raise Built
    monkeypatch.setattr(stream.BatchedStreamDecoder, "__init__", keep)
    with pytest.raises(Built):
        cli.main(["--device", "cpu", "serve", "--runtime", "native",
                  "--engine", "device", "--passes", "2", "--maxcycles", "500",
                  "--osd-depth", "4", "--batch", "2"])
    dcfg = built[0]._device.config
    assert dcfg.multipass.passes == 2
    assert (dcfg.demod.maxcycles, dcfg.demod.osd_depth) == (500, 4)
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "serve", "--runtime", "ring",
                  "--engine", "hybrid", "--passes", "2"])


# ------------------------------------------------------------- on a card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_twin_and_subtract_spot(spots):
    card = _card()
    far = dc.replace(spots["clean"], shift=45000 - 41472 + 300)
    early = dc.replace(spots["clean"], shift=-400)
    wins = [MASKED, CLEAN, CLEAN, MASKED]
    by_window = [[spots["masked"], spots["slm"]], [spots["clean"], far],
                 [early], []]
    S.reset_counters()
    dev_out, dev_info = run_lanes(wins, by_window, device=card)
    assert S.KERNEL_LAUNCHES == 1
    cpu_out, cpu_info = run_lanes(wins, by_window)
    for w in range(4):
        assert within(dev_out[w], cpu_out[w])
        want = np.asarray(wins[w], np.complex64)
        for s in by_window[w]:
            want = mp.subtract_spot(want, s, CFG)
        assert within(dev_out[w].astype(np.complex64), want)
    assert np.array_equal(dev_info[:, :2], cpu_info[:, :2])
    assert np.allclose(dev_info[:, 2], cpu_info[:, 2], rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_multipass_decode_on_a_card():
    card = _card()
    dec = DeviceDecoder(passes_config(3, serving_w=2), device=card)
    ri = ri_of([MASKED, MASKED])
    first = dec.decode_ri_batch(ri)          # captures the shape
    S.reset_counters()
    with captured.eager():
        eager = dec.decode_windows_ri(ri.to(card))
    assert S.KERNEL_LAUNCHES == 2            # one a subtraction stage
    replay = dec.decode_windows_ri(ri)
    torch.cuda.synchronize()
    assert torch.equal(eager, replay)
    for w in range(2):
        got = [(s.message, s.pass_index)
               for s in dec.spots(first.window(w))]
        assert got == [(STRONG[3], 0), (WEAK[3], 1)]
