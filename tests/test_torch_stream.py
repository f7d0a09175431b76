"""The port's streaming runtimes against the JAX package's.

- windowing: the port's SlidingWindow and its native windower (the port's
  own stream_native.cc) against the JAX SlidingWindow and NativeWindower on
  random multichannel streams: emission timing, overlap content, ring
  overflow and partial pops; exact (the same float32 samples are copied).
- StreamDecoder: the host and device engines on a one-channel stream of 16
  hops (three windows, one "VE3EMB FN25 30" frame at -18 dB, maxcycles
  2000) against the JAX StreamDecoder with the same engine; the hybrid
  engine against the port's device engine. Spots equal in message,
  candidate, jiggle, shift and mode; freq to 1e-4 Hz and sync to 1e-3
  (sums taken in another order).
- BatchedStreamDecoder at batch_windows 2 against the JAX one on three
  channels (two frames, one noise), whose third window is the padded flush:
  the same channels, messages, candidate and Fano-attempt counts.
- checkpoint and resume, SpotAggregator.

Every port runtime runs on the CPU with the kernels' plain versions; the
config is used as given there (no serving defaults), as the JAX runtimes
do off a TPU.
"""

import numpy as np
import pytest
import torch

import uwspr_tpu.pipeline.native as jnative
import uwspr_tpu.pipeline.stream as jstream
import uwspr_tpu_torch.pipeline.native as tnative
import uwspr_tpu_torch.pipeline.stream as tstream
from test_torch_copies import jax_config
from uwspr_tpu_torch.config import DemodConfig, PipelineConfig, StreamConfig
from uwspr_tpu_torch.io.channel import awgn, noise_sigma
from uwspr_tpu_torch.pipeline.decoder import Spot
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

CFG = PipelineConfig(demod=DemodConfig(maxcycles=2000))
HOP = 9 * 375
MSG = "VE3EMB FN25 30"


# ---------------------------------------------------------------- windowing

def _emitted(sw, blocks):
    return [sw.push(b) for b in blocks]


@pytest.mark.parametrize("case", ["timing", "overlap", "overflow"])
def test_sliding_window_matches_jax(case):
    """The cases of tests/test_stream.py, on both packages' windows."""
    if case == "timing":         # 13 hops to the first window, then 1 each
        cfg = StreamConfig()
        blocks = [np.full(HOP, i + 1, np.complex64) for i in range(20)]
    elif case == "overlap":      # 5 windows, each advanced by one hop
        cfg = StreamConfig()
        blocks = [np.arange(60000, dtype=np.float32).astype(np.complex64)]
    else:                        # a push of 3 fl into a 2 fl ring
        cfg = StreamConfig(capacity_windows=2)
        blocks = [np.arange(3 * cfg.fl, dtype=np.float32
                            ).astype(np.complex64)]
    t = _emitted(tstream.SlidingWindow(cfg), blocks)
    j = _emitted(jstream.SlidingWindow(jax_config(PipelineConfig(
        stream=cfg)).stream), blocks)
    assert [len(x) for x in t] == [len(x) for x in j]
    for a, b in zip(sum(t, []), sum(j, [])):
        np.testing.assert_array_equal(a, b)
    wins = sum(t, [])
    if case == "timing":
        assert [len(x) for x in t] == [0] * 13 + [1] * 7
    elif case == "overlap":
        assert [w[0].real for w in wins] == [i * HOP for i in range(5)]
    else:
        assert wins[0][0].real == cfg.fl


def test_native_windower_matches_jax():
    """Random multi-push patterns, one of them overflowing the ring: the
    port's native windower emits the windows of the JAX NativeWindower and
    of the SlidingWindow, in the same channel order, and drops as many
    samples."""
    cfg = StreamConfig(fl=500, shift=1, fs=50)          # fl 500, hop 50
    rng = np.random.default_rng(0)
    C = 3
    args = (C, cfg.fl, cfg.shift * cfg.fs, cfg.capacity_windows)
    tw, jw = tnative.NativeWindower(*args), jnative.NativeWindower(*args)
    py = [tstream.SlidingWindow(cfg) for _ in range(C)]
    total = 0
    for it in range(40):
        n = int(rng.integers(1, 400)) if it != 20 else 1500
        block = (rng.normal(size=(C, n))
                 + 1j * rng.normal(size=(C, n))).astype(np.complex64)
        assert tw.push(block) == jw.push(block)
        exp = [(c, w) for c in range(C) for w in py[c].push(block[c])]
        t_ri, t_ch = tw.pop_batch(64)
        j_ri, j_ch = jw.pop_batch(64)
        np.testing.assert_array_equal(t_ri, j_ri)
        np.testing.assert_array_equal(t_ch, j_ch)
        assert len(exp) == len(t_ri), it
        for (ec, ew), gri, gc in zip(exp, t_ri, t_ch):
            assert ec == gc
            np.testing.assert_array_equal(ew, gri[0] + 1j * gri[1])
        total += len(exp)
    assert total > 100
    assert tw.dropped == jw.dropped > 0
    assert tnative.num_threads() >= 1


def test_native_windower_partial_pop():
    """pop_batch smaller than ready leaves the other windows intact."""
    fl, hop = 400, 100
    x = np.arange(1, 1201, dtype=np.float32)
    out = []
    for mod in (tnative, jnative):
        nw = mod.NativeWindower(1, fl, hop, capacity_windows=4)
        nw.push(np.stack([x, -x])[None])
        assert nw.ready == (1200 - fl) // hop + 1           # 9 windows
        first, _ = nw.pop_batch(4)
        rest, _ = nw.pop_batch(16)
        assert len(first) == 4 and len(rest) == 5 and nw.ready == 0
        assert nw.buffered(0) == 1200 - 9 * hop
        out.append(np.concatenate([first, rest]))
    np.testing.assert_array_equal(out[0], out[1])
    for w in range(9):
        np.testing.assert_array_equal(out[0][w, 0], x[w * hop:w * hop + fl])
        np.testing.assert_array_equal(out[0][w, 1], -x[w * hop:w * hop + fl])


def test_native_build_failure_raises(tmp_path):
    """No fallback: a source g++ cannot build raises, with its log."""
    from uwspr_tpu_torch.utils.gxx_build import load_gxx_library
    bad = tmp_path / "broken_windower.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        load_gxx_library(bad, lambda lib: None)


def test_native_windower_rejects_bad_blocks():
    nw = tnative.NativeWindower(2, 400, 100)
    with pytest.raises(ValueError, match="channels"):
        nw.push(np.zeros((3, 10), np.complex64))
    with pytest.raises(ValueError, match="planar"):
        nw.push(np.zeros((2, 10), np.float32))


# ---------------------------------------------------------------- decoders

def stream(n_hops=16, seed=7, start=1000):
    """(n_hops*HOP,) complex: noise at -18 dB with one frame from
    ``start``."""
    rng = np.random.default_rng(seed)
    s = noise_sigma(-18.0)
    z = (rng.normal(scale=s, size=n_hops * HOP)
         + 1j * rng.normal(scale=s, size=n_hops * HOP)).astype(np.complex64)
    frame = synthesize_frame("VE3EMB", "FN25", 30, pad_to=None,
                             freq_offset=1.0)
    z[start:start + len(frame)] += frame
    return z


def hops(z):
    return [z[..., i * HOP:(i + 1) * HOP] for i in range(z.shape[-1] // HOP)]


def feed(dec, z):
    return [r for b in hops(z) for r in dec.push(b)]


def spot_keys(results):
    return [(ch, [(s.message, s.candidate, s.jiggle, s.shift, s.mode)
                  for s in r.spots]) for ch, r in results]


def assert_spots_close(a, b):
    for (_, ra), (_, rb) in zip(a, b):
        for sa, sb in zip(ra.spots, rb.spots):
            assert abs(sa.freq - sb.freq) <= 1e-4
            assert abs(sa.sync - sb.sync) <= 1e-3


@pytest.fixture(scope="module")
def one_channel():
    return stream()


@pytest.fixture(scope="module")
def port_device_run(one_channel):
    sd = tstream.StreamDecoder(CFG, engine="device", device="cpu")
    return sd, feed(sd, one_channel)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_stream_decoder_matches_jax(engine, one_channel, port_device_run):
    if engine == "device":
        tsd, got = port_device_run
    else:
        tsd = tstream.StreamDecoder(CFG, engine=engine, device="cpu")
        got = feed(tsd, one_channel)
    jsd = jstream.StreamDecoder(jax_config(CFG), engine=engine)
    exp = feed(jsd, one_channel)
    assert tsd.engine == jsd.engine == engine
    assert spot_keys(got) == spot_keys(exp)
    assert [m for _, ms in spot_keys(got) for m in ms][0][0] == MSG
    assert_spots_close(got, exp)
    assert [(r.n_candidates, r.n_fano_attempts) for _, r in got] == [
        (r.n_candidates, r.n_fano_attempts) for _, r in exp]
    assert tsd.stats.windows == jsd.stats.windows == 3


def test_hybrid_engine_matches_device_engine(one_channel, port_device_run):
    _, dev = port_device_run
    hyb = tstream.StreamDecoder(CFG, engine="hybrid", device="cpu")
    got = feed(hyb, one_channel)
    assert spot_keys(got) == spot_keys(dev)
    assert_spots_close(got, dev)


def test_engine_follows_the_device():
    """"auto" is the device engine on CUDA and the host engine on the CPU:
    it follows the device asked for, never what is installed."""
    assert tstream.StreamDecoder(CFG, device="cpu").engine == "host"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tstream.StreamDecoder(CFG, device="cuda")
    assert tstream.StreamDecoder(CFG, passes=2, device="cpu").passes == 2
    with pytest.raises(ValueError, match="engine"):
        tstream.StreamDecoder(CFG, engine="tpu", device="cpu")


def test_device_engine_runs_the_per_window_program(one_channel,
                                                   port_device_run):
    """The device engine decodes each window with DeviceDecoder.__call__,
    which ignores the batch knobs (as the JAX StreamDecoder's does): set to
    caps that would drop lanes in a batch, they change no spot and no
    count."""
    _, base = port_device_run
    cfg = PipelineConfig(demod=DemodConfig(
        maxcycles=2000, cand_compact_lanes=1, refine_max_lanes=1,
        fano_compact_lanes=4))
    got = feed(tstream.StreamDecoder(cfg, engine="device", device="cpu"),
               one_channel)
    assert spot_keys(got) == spot_keys(base)
    assert [(r.n_candidates, r.n_fano_attempts) for _, r in got] == [
        (r.n_candidates, r.n_fano_attempts) for _, r in base]


def test_checkpoint_resume(tmp_path, one_channel, port_device_run):
    """13 hops (no window yet), a checkpoint, and a fresh decoder resumed
    from it decodes the 14th hop's window as the uninterrupted run did."""
    _, full = port_device_run
    z = one_channel
    sd1 = tstream.StreamDecoder(CFG, engine="device", device="cpu")
    for b in hops(z)[:13]:
        assert sd1.push(b) == []
    sd1.save_checkpoint(tmp_path)
    sd2 = tstream.StreamDecoder(CFG, engine="device", device="cpu")
    sd2.load_checkpoint(tmp_path)
    tail = [r for b in hops(z)[13:] for r in sd2.push(b)]
    assert spot_keys(tail) == spot_keys(full)
    assert sd2.stats.windows == 3
    # the JAX runtime reads the port's checkpoint
    jsd = jstream.StreamDecoder(jax_config(CFG), engine="host")
    jsd.load_checkpoint(tmp_path)
    np.testing.assert_array_equal(jsd.windows[0].state(),
                                  sd1.windows[0].state())


def test_spot_aggregator_matches_jax():
    def spot(f):
        return Spot(message="M", payload=b"x", freq=f, snr=0, sync=0,
                    shift=0, drift=0, mode=0)
    freqs = [1.0, 1.2, 5.0, 2.49, 2.51, 6.4, -3.0, -1.6]
    t, j = tstream.SpotAggregator(), jstream.SpotAggregator()
    assert ([t.add(spot(f)) for f in freqs]
            == [j.add(spot(f)) for f in freqs])
    assert [s.freq for s in t.unique] == [s.freq for s in j.unique]
    assert [s.freq for s in t.unique][:2] == [1.0, 5.0]


def test_batched_stream_decoder_matches_jax():
    """Three channels (frames in 0 and 1, noise in 2) in hop blocks at
    batch width 2: push decodes one full batch, flush the third window
    zero-padded; the padding yields no result."""
    rng = np.random.default_rng(3)
    frames = [awgn(synthesize_frame("VE3EMB", "FN25", 30, start_sample=700,
                                    freq_offset=1.5), -18, rng=rng),
              awgn(synthesize_frame("K1ABC", "FN42", 37, start_sample=300,
                                    freq_offset=-3.0), -18, rng=rng)]
    s = noise_sigma(-18.0)
    noise = rng.normal(scale=s, size=45000) + 1j * rng.normal(scale=s,
                                                               size=45000)
    z = np.stack(frames + [noise]).astype(np.complex64)
    t = tstream.BatchedStreamDecoder(CFG, n_channels=3, batch_windows=2,
                                     device="cpu")
    j = jstream.BatchedStreamDecoder(jax_config(CFG), n_channels=3,
                                     batch_windows=2)
    got, exp = [], []
    for b in [z[:, lo:lo + HOP] for lo in range(0, 45000, HOP)]:
        got.extend(t.push(b))
        exp.extend(j.push(b))
    assert len(got) == len(exp) == 2                    # one full batch
    got.extend(t.flush())
    exp.extend(j.flush())
    assert len(got) == 3                                # padded flush
    assert spot_keys(got) == spot_keys(exp)
    assert [(r.n_candidates, r.n_fano_attempts) for _, r in got] == [
        (r.n_candidates, r.n_fano_attempts) for _, r in exp]
    assert [[s.message for s in r.spots] for _, r in got] == [
        [MSG], ["K1ABC FN42 37"], []]
    assert_spots_close(got, exp)
    assert t.windower.dropped == 0 and t.stats.windows == 3
