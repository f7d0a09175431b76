"""The device engine's asynchronous contract, on the CPU.

``DeviceDecoder.decode_windows_ri`` and the ring's ``push_hop``,
``push_hops`` and ``stage`` queue a batch's work and return without
waiting for the card, as the JAX decoder's dispatch does: no Python value
may depend on a tensor's contents between a batch's input and its packed
handle, in any config.

- The guard: with ``Tensor.__bool__``, ``__int__``, ``__float__``,
  ``__index__``, ``item`` and ``tolist`` made to raise (except inside the
  plain versions of the selection, Fano and OSD kernels, which stand in
  for the CUDA kernels here), the serving config, the config without
  compaction (with and without refine_max_lanes), the pallas-STFT config,
  the device OSD at osd_depth 2 and 4 (the JAX program's fixed shape:
  osd_max_lanes lanes a batch, the failed mask as the kernel's active)
  and the ring (a numpy hop, a staged hop, push_hops) decode on the CPU.
- The never-drop Fano, now one call per phase over every lane with
  ``active`` the gate, against the JAX package's chunked ``_compact_fano``
  at fano_compact_lanes 1, 3 and 64 (more gated lanes than the first two
  caps): the packed (W, C, 23) output bit-identical. The JAX side runs its
  Fano as the Pallas kernel in interpret mode.

Toy budgets (3 jiggles, a Fano budget of 4 cycles a bit) keep the plain
Fano short on lanes that never decode.
"""

import contextlib
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_copies import jax_config
from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder as JaxDecoder
from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig,
                                    PipelineConfig, with_serving_defaults)
from uwspr_tpu_torch.fec import fano
from uwspr_tpu_torch.io.channel import awgn, noise_sigma
from uwspr_tpu_torch.pipeline import device_decoder
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.pipeline.device_ring import DeviceRingDecoder
from uwspr_tpu_torch.protocol.fec_encode import encode_bits
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

TOY = DemodConfig(n_jiggles=3, maxcycles=4)
HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
              "tolist")


def frame_windows(n, seed=0):
    """n (2, 45000) windows, each one "VE3EMB FN25 30" frame at -18 dB."""
    rng = np.random.default_rng(seed)
    wins = [awgn(synthesize_frame("VE3EMB", "FN25", 30,
                                  start_sample=int(rng.integers(0, 2000)),
                                  freq_offset=float(rng.uniform(-5, 5))),
                 -18, rng=rng) for _ in range(n)]
    z = np.stack(wins)
    return np.stack([z.real, z.imag], axis=1).astype(np.float32)


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Every host read of a tensor's value raises, except inside the plain
    versions of the kernels the decoder calls."""
    inside = [0]

    def guard(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            if not inside[0]:
                raise AssertionError(f"Tensor.{name}: a host read of a "
                                     f"tensor's value before the handle")
            return orig(self, *a, **k)
        return read

    def allowed(fn):
        def call(*a, **k):
            inside[0] += 1
            try:
                return fn(*a, **k)
            finally:
                inside[0] -= 1
        return call
    with monkeypatch.context() as m:
        for name in ("select_best", "fano_decode_batch", "osd_decode_lanes"):
            m.setattr(device_decoder, name,
                      allowed(getattr(device_decoder, name)))
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, guard(name))
        yield


def test_guard_catches_a_host_read(monkeypatch):
    with no_host_reads(monkeypatch), pytest.raises(AssertionError):
        int(torch.ones(2).sum())


SERVING = with_serving_defaults(PipelineConfig(demod=TOY), 2)
CONFIGS = {
    "serving": SERVING,
    "no compaction": PipelineConfig(demod=TOY),
    "refine_max_lanes": PipelineConfig(demod=dc.replace(
        TOY, refine_max_lanes=4)),
    "pallas STFT": dc.replace(SERVING, coarse=CoarseConfig(
        stft_impl="pallas")),
    "osd_depth 2": dc.replace(SERVING, demod=dc.replace(
        SERVING.demod, osd_depth=2)),
    "osd_depth 4": dc.replace(SERVING, demod=dc.replace(
        SERVING.demod, osd_depth=4)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_windows_ri_reads_nothing_on_the_host(name, monkeypatch):
    ri = frame_windows(2)
    dec = DeviceDecoder(CONFIGS[name], device="cpu")
    want = dec.decode_windows_ri(torch.from_numpy(ri))
    with no_host_reads(monkeypatch):
        got = dec.decode_windows_ri(ri)
    assert torch.equal(got, want)
    assert dec.unpack_output(got).fano_attempts.sum() > 0


def test_ring_reads_nothing_on_the_host(monkeypatch):
    ring = DeviceRingDecoder(PipelineConfig(demod=TOY), n_channels=2,
                             apply_serving_defaults=True, device="cpu")
    rng = np.random.default_rng(4)
    s = noise_sigma(-18.0)
    hops = [(rng.normal(scale=s, size=(2, ring.hop))
             + 1j * rng.normal(scale=s, size=(2, ring.hop))
             ).astype(np.complex64) for _ in range(17)]
    frame = synthesize_frame("VE3EMB", "FN25", 30, pad_to=None)
    z = np.concatenate(hops, axis=1)
    z[:, 3000:3000 + frame.shape[0]] += frame      # whole in hop 13
    hops = np.split(z, 17, axis=1)
    prefill = -(-ring.fl // ring.hop) - 1
    for h in hops[:prefill]:
        assert ring.push_hop(h) is None
    with no_host_reads(monkeypatch):
        outs = [ring.push_hop(hops[prefill]),
                ring.push_hop(ring.stage(hops[prefill + 1]))]
        outs.append(ring.push_hops(np.stack(hops[prefill + 2:])))
    assert [tuple(o.shape) for o in outs] == [
        (2, ring.decoder.n_cand, 23)] * 2 + [(2, 2, ring.decoder.n_cand, 23)]
    found = {s.message for o in outs for _, s in ring.spots(ring.fetch(o))}
    assert "VE3EMB FN25 30" in found


# ---------------------------------------------------- one-call Fano phases

W, C, J = 2, 3, 3


def fano_scene(seed=7):
    """Fields of a (W, C, J) batch as _fano_select_batch takes them: every
    lane gated but one a window; the jiggle-0 lanes of one candidate a
    window decodable (phase 2 then skips its jiggles), the other lanes
    noise that never decodes at the toy budget."""
    rng = np.random.default_rng(seed)
    deint = rng.integers(0, 256, size=(W, C, J, 162)).astype(np.uint8)
    for w in range(W):
        bits = rng.integers(0, 2, size=50).astype(np.uint8)
        coded = encode_bits(np.concatenate([bits, np.zeros(31, np.uint8)]))
        soft = np.where(coded == 1, 178.0, 78.0) + rng.normal(0, 8, 162)
        deint[w, w, 0] = np.clip(soft, 0, 255).astype(np.uint8)
    gate = np.ones((W, C, J), bool)
    gate[:, C - 1, 1] = False
    return {
        "valid": np.ones((W, C), bool),
        "worth": np.ones((W, C), bool),
        "freq": rng.uniform(-5, 5, (W, C)).astype(np.float32),
        "snr": rng.uniform(-20, 0, (W, C)).astype(np.float32),
        "shift": rng.integers(0, 26, (W, C)).astype(np.int32) * 128,
        "drift": rng.uniform(-1, 1, (W, C)).astype(np.float32),
        "mode": np.zeros((W, C), np.int32),
        "slm_params": np.zeros((W, C, 4), np.float32),
        "sync2": rng.uniform(0, 1, (W, C, J)).astype(np.float32),
        "gate": gate,
        "deint": deint,
    }


@pytest.mark.parametrize("cap", [1, 3, 64])
def test_one_call_fano_matches_jax_chunks(cap):
    pre = fano_scene()
    n_gated = pre["gate"][:, :, 0].sum()
    assert cap >= W * C * (J - 1) or n_gated > cap
    cfg = PipelineConfig(demod=dc.replace(TOY, fano_compact_lanes=cap))
    jcfg = jax_config(cfg)
    jcfg = dc.replace(jcfg, demod=dc.replace(jcfg.demod, fano_impl="pallas"))
    jdec = JaxDecoder(jcfg)
    jpre = {k: jnp.asarray(v) for k, v in pre.items()}
    want = np.asarray(jax.jit(
        lambda p: jdec._pack(jdec._fano_select_batch(p)))(jpre))

    tdec = DeviceDecoder(cfg, device="cpu")
    fano.reset_counters()
    got = tdec._pack(tdec._fano_select_batch(
        {k: torch.from_numpy(v) for k, v in pre.items()})).numpy()
    assert fano.PLAIN_CALLS == 2            # one call a phase
    assert got.shape == want.shape == (W, C, 23)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    out = tdec.unpack_output(got)
    assert out.success.sum() == W and (out.fano_overflow == 0).all()
