"""The port's device-resident ring (DeviceRingDecoder, RingServe).

- the four tests of tests/test_device_ring.py on the port: streamed frames
  decode, checkpoint/resume, int16 ingest, push_hops against push_hop;
- each hop's packed output equals, bitwise, the port's DeviceDecoder on the
  same windows sliced from the stream at the ring's boundaries (the newest
  fl samples; an f32 ring copy is exact), also for staged ingest, push_hops
  and a resumed ring;
- the int16 quantiser gives the blocks and scales of the JAX ring's
  ``_as_blocks`` bit for bit;
- the hybrid engine (fano_mode "host") fetches a push_hops result of K > 1
  hops with the spots of the device engine.

The ring runs on the CPU with the kernels' plain versions and, as the JAX
ring's tests do, without serving defaults (apply_serving_defaults False),
at maxcycles 20.
"""

import numpy as np
import pytest
import torch

from test_torch_copies import jax_config
from uwspr_tpu.pipeline.device_ring import DeviceRingDecoder as JaxRing
from uwspr_tpu_torch.config import DemodConfig, PipelineConfig
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.pipeline.device_ring import DeviceRingDecoder, RingServe
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

# maxcycles 20 (a budget of 1620 forward looks) decodes these frames; a
# lane that never decodes, as in windows that cut a frame, costs the plain
# Fano loop its whole budget
CFG = PipelineConfig(demod=DemodConfig(maxcycles=20))
HOP, FL = 3375, 45000
MSG = "VE3EMB FN25 30"


def streams(n_channels=2, seconds=150, snr_db=-18, seed=5):
    """(C, n) complex: continuous streams, one frame per channel placed a
    few hops into the stream (tests/test_device_ring.py:17-33)."""
    rng = np.random.default_rng(seed)
    n = seconds * 375
    out = np.zeros((n_channels, n), np.complex64)
    for c in range(n_channels):
        z = synthesize_frame("VE3EMB", "FN25", 30,
                             start_sample=int(rng.integers(0, 2000)),
                             freq_offset=float(rng.uniform(-4, 4)),
                             pad_to=45000)
        start = 6750 + c * 3375
        out[c, start:start + 45000] = z
        out[c] = awgn(out[c], snr_db, rng=rng)
    return out


def ring(n_channels=1, **kw):
    return DeviceRingDecoder(CFG, n_channels=n_channels,
                             apply_serving_defaults=False, device="cpu", **kw)


def block(z, k):
    return z[:, k * HOP:(k + 1) * HOP]


def sliced(z, k):
    """The ring's window after hop k: the newest FL samples, as (C, 2, FL)
    float32."""
    w = z[:, (k + 1) * HOP - FL:(k + 1) * HOP]
    return torch.from_numpy(np.stack([w.real, w.imag], axis=1)
                            .astype(np.float32))


def messages(r, handle):
    return {s.message for _, s in r.spots(r.fetch(handle))}


@pytest.fixture(scope="module")
def two_channel_run():
    """Handles of a 2-channel ring over 16 hops, by hop index."""
    z = streams()
    r = ring(2)
    handles = {}
    for k in range(z.shape[1] // HOP):
        h = r.push_hop(block(z, k))
        if h is not None:
            handles[k] = h
    return z, r, handles


def test_ring_decodes_streamed_frames(two_channel_run):
    z, r, handles = two_channel_run
    # no handle until the ring holds a full window: 13 prefill hops
    assert sorted(handles) == list(range(13, z.shape[1] // HOP))
    found = [set(), set()]
    for h in handles.values():
        for c, s in r.spots(r.fetch(h)):
            found[c].add(s.message)
    assert found == [{MSG}, {MSG}]


def test_ring_equals_decoder_on_sliced_windows(two_channel_run):
    z, r, handles = two_channel_run
    for k, h in handles.items():
        assert torch.equal(h, r.decoder.decode_windows_ri(sliced(z, k))), k


def test_ring_checkpoint_roundtrip():
    """A ring restored from the state halfway gives the uninterrupted run's
    tail bitwise."""
    z = streams(n_channels=1, seconds=160, seed=9)
    n_hops = z.shape[1] // HOP
    split = n_hops // 2
    r = ring()
    full, state = {}, None
    for k in range(n_hops):
        if k == split:
            state = r.state()
        h = r.push_hop(block(z, k))
        if h is not None:
            full[k] = h
    r2 = ring()
    r2.restore(state)
    tail = {}
    for k in range(split, n_hops):
        h = r2.push_hop(block(z, k))
        if h is not None:
            tail[k] = h
    assert sorted(tail) == sorted(full) and len(full) == n_hops - 13
    for k in full:
        assert torch.equal(tail[k], full[k]), k
    assert MSG in set().union(*(messages(r2, h) for h in tail.values()))
    with pytest.raises(ValueError, match="shape"):
        r2.restore({"ring": state["ring"][:, :, 1:], "filled": 0})


def test_ring_int16_ingest_decodes():
    z = streams(n_channels=1, seconds=160, seed=5)
    r = ring(ingest_dtype="int16")
    msgs = set()
    for k in range(z.shape[1] // HOP):
        h = r.push_hop(block(z, k))
        if h is not None:
            msgs |= messages(r, h)
    assert MSG in msgs


def test_int16_blocks_equal_jax():
    """Blocks and scales of the int16 quantiser bit for bit against the JAX
    ring's _as_blocks: complex, planar f32, a silent channel, and a
    pre-quantised int16 block (unit scale)."""
    rng = np.random.default_rng(1)
    C = 3
    cplx = (rng.normal(size=(C, HOP)) + 1j * rng.normal(size=(C, HOP))
            ).astype(np.complex64) * np.float32(0.37)
    cplx[2] = 0
    planar = np.stack([cplx.real, cplx.imag], axis=1)
    pre = rng.integers(-32767, 32768, size=(C, 2, HOP)).astype(np.int16)
    t = DeviceRingDecoder(CFG, n_channels=C, ingest_dtype="int16",
                          apply_serving_defaults=False, device="cpu")
    j = JaxRing(jax_config(CFG), n_channels=C, ingest_dtype="int16",
                apply_serving_defaults=False)
    for blk in (cplx, planar, pre):
        (tb, ts), (jb, js) = t._as_blocks(blk), j._as_blocks(blk)
        assert tb.dtype == jb.dtype == np.int16
        np.testing.assert_array_equal(tb, jb)
        assert ts.dtype == js.dtype == np.float32
        np.testing.assert_array_equal(ts.view(np.int32), js.view(np.int32))
    with pytest.raises(ValueError, match="hop block"):
        t._as_blocks(cplx[:, :10])


def test_ring_multi_hop_step_matches_single():
    """push_hops (K hops, one host-to-device copy) equals K push_hop calls
    bitwise, and its spots are their union."""
    z = streams(n_channels=1, seconds=170, seed=13)
    single, multi = ring(), ring()
    for k in range(13):
        assert single.push_hop(block(z, k)) is None
        assert multi.push_hop(block(z, k)) is None
    with pytest.raises(RuntimeError, match="prefill"):
        ring().push_hops(np.stack([block(z, 0)]))
    K = 4
    singles = [single.push_hop(block(z, 13 + i)) for i in range(K)]
    out = multi.push_hops(np.stack([block(z, 13 + i) for i in range(K)]))
    assert out.shape[0] == K
    for i in range(K):
        assert torch.equal(out[i], singles[i]), i
    typed = multi.fetch(out)
    assert typed.success.shape == (K, 1, multi.decoder.n_cand)
    assert ({s.message for _, s in multi.spots(typed)}
            == set().union(*(messages(single, h) for h in singles)))


def test_staged_ingest_equals_push():
    """stage() then push_hop(staged) equals push_hop(block) bitwise, in f32
    and int16 ingest."""
    z = streams(n_channels=1, seconds=150, seed=5)
    for dtype in ("f32", "int16"):
        a, b = ring(ingest_dtype=dtype), ring(ingest_dtype=dtype)
        for k in range(15):
            ha = a.push_hop(block(z, k))
            hb = b.push_hop(b.stage(block(z, k)))
            assert (ha is None) == (hb is None) == (k < 13)
            if ha is not None:
                assert torch.equal(ha, hb), (dtype, k)


def test_hybrid_fetch_of_several_hops():
    """fano_mode "host": a push_hops handle (K, C, ...) is Fano-decoded on
    the host with the spots of the device engine, hop by hop."""
    z = streams()
    dev, hyb = ring(2), ring(2, fano_mode="host")
    for k in range(13):
        dev.push_hop(block(z, k))
        hyb.push_hop(block(z, k))
    K = 3
    blocks = np.stack([block(z, 13 + i) for i in range(K)])
    d = dev.fetch(dev.push_hops(blocks))
    h = hyb.fetch(hyb.push_hops(blocks))
    assert h.success.shape == d.success.shape == (K, 2, dev.decoder.n_cand)
    for key in ("success", "valid", "fano_attempts", "jiggle", "shift"):
        np.testing.assert_array_equal(getattr(h, key), getattr(d, key),
                                      err_msg=key)
    np.testing.assert_array_equal(h.payload[h.success], d.payload[d.success])
    for k in range(K):
        assert ([(c, s.message) for c, s in hyb.spots(h.window(k))]
                == [(c, s.message) for c, s in dev.spots(d.window(k))])
    assert {m for _, m in ((c, s.message) for c, s in hyb.spots(h))} == {MSG}


def test_ring_serve_results():
    """RingServe buffers arbitrary pushes to hops and reports per channel
    per decoded window."""
    z = streams()
    rs = RingServe(CFG, n_channels=2, apply_serving_defaults=False,
                   device="cpu")
    results = []
    for lo in range(0, z.shape[1], 5000):           # not hop-aligned
        results.extend(rs.push(z[:, lo:lo + 5000]))
    n_windows = z.shape[1] // HOP - 13
    assert [c for c, _ in results] == [0, 1] * n_windows
    assert rs.stats.windows == 2 * n_windows
    assert {s.message for _, r in results for s in r.spots} == {MSG}
    assert rs.flush() == []
