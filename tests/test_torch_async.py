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
- The never-drop Fano, now one call over every jiggle of every lane with
  ``active`` the gate (the JAX program's two phases, jiggle 0 and then the
  other jiggles of the candidates it did not decode, give the same first
  success), against the JAX package's chunked ``_compact_fano`` at
  fano_compact_lanes 1, 3 and 64 (more gated lanes than the first two
  caps), and on scenes where gated later jiggles of a decoded candidate
  hold codewords of their own, where only later jiggles decode, and where
  nothing decodes: the packed (W, C, 23) output bit-identical, and the
  decoder's tally of speculative lanes the scalar oracle's. The capped
  per-window Fano (fano_compact_lanes 0) stays two calls, equal to the
  JAX program's. The JAX side runs its Fano as the Pallas kernel in
  interpret mode.

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
from uwspr_tpu.fec.fano_ref import fano_decode
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
        for name in ("select_best", "fano_decode_batch",
                     "fano_decode_jiggles", "osd_decode_lanes"):
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
BUDGET = TOY.maxcycles * 81
# lanes (window, candidate, jiggle) that hold a codeword, by scene; every
# other lane is noise that never decodes at the toy budget
SCENES = {
    # jiggle 0 of one candidate a window decodes (the two phases then
    # skip its other jiggles)
    "default": [(0, 0, 0), (1, 1, 0)],
    # jiggle 0 decodes and gated later jiggles of the same candidate hold
    # other codewords: speculative lanes that decode, kept out
    "speculative": [(0, 0, 0), (0, 0, 1), (0, 0, 2), (1, 1, 0), (1, 1, 2)],
    # jiggle 0 fails and jiggles 1 and 2 both decode: the first is kept;
    # candidate C - 1 decodes at jiggle 2 only, its jiggle 1 not gated
    "later_jiggles": [(0, 1, 1), (0, 1, 2), (1, 0, 1), (1, 0, 2),
                      (1, 2, 1), (1, 2, 2)],
    "none": [],
}


def fano_scene(seed=7, decodable=SCENES["default"]):
    """Fields of a (W, C, J) batch as _fano_select_batch takes them: every
    lane gated but jiggle 1 of the last candidate a window; the
    ``decodable`` lanes each hold a codeword of its own, the other lanes
    noise that never decodes at the toy budget."""
    rng = np.random.default_rng(seed)
    deint = rng.integers(0, 256, size=(W, C, J, 162)).astype(np.uint8)
    for w, c, j in decodable:
        bits = rng.integers(0, 2, size=50).astype(np.uint8)
        coded = encode_bits(np.concatenate([bits, np.zeros(31, np.uint8)]))
        soft = np.where(coded == 1, 178.0, 78.0) + rng.normal(0, 8, 162)
        deint[w, c, j] = np.clip(soft, 0, 255).astype(np.uint8)
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
        "refine_overflow": np.zeros(W, np.int64),
    }


def jax_packed(cfg, pre):
    """The JAX program's _fano_select_batch on ``pre``, packed, its Fano
    the Pallas kernel in interpret mode."""
    jcfg = jax_config(cfg)
    jcfg = dc.replace(jcfg, demod=dc.replace(jcfg.demod, fano_impl="pallas"))
    jdec = JaxDecoder(jcfg)
    jpre = {k: jnp.asarray(v) for k, v in pre.items()}
    return np.asarray(jax.jit(
        lambda p: jdec._pack(jdec._fano_select_batch(p)))(jpre))


def port_packed(cfg, pre):
    """(the port's packed _fano_select_batch on ``pre`` on the CPU, its
    Fano calls, its decoder)."""
    tdec = DeviceDecoder(cfg, device="cpu")
    fano.reset_counters()
    got = tdec._pack(tdec._fano_select_batch(
        {k: torch.from_numpy(v) for k, v in pre.items()})).numpy()
    return got, fano.PLAIN_CALLS, tdec


def want_tally(pre):
    """The fano_tally of one decode of ``pre`` on the CPU, from the JAX
    package's scalar oracle: the gated jiggles >= 1 of candidates whose
    jiggle 0 decodes, none stopped (the plain version walks every lane),
    and their forward looks."""
    lanes, looks = 0, 0
    for w in range(W):
        for c in range(C):
            if not (pre["gate"][w, c, 0] and fano_decode(
                    pre["deint"][w, c, 0], maxcycles=TOY.maxcycles).success):
                continue
            for j in range(1, J):
                if pre["gate"][w, c, j]:
                    r = fano_decode(pre["deint"][w, c, j],
                                    maxcycles=TOY.maxcycles)
                    lanes += 1
                    looks += min(r.cycles - 1, BUDGET)
    return {"decodes": 1, "speculative_lanes": lanes,
            "speculative_aborted": 0, "speculative_looks": looks}


@pytest.mark.parametrize("cap", [1, 3, 64])
def test_one_call_fano_matches_jax_chunks(cap):
    pre = fano_scene()
    n_gated = pre["gate"][:, :, 0].sum()
    assert cap >= W * C * (J - 1) or n_gated > cap
    cfg = PipelineConfig(demod=dc.replace(TOY, fano_compact_lanes=cap))
    want = jax_packed(cfg, pre)
    got, calls, tdec = port_packed(cfg, pre)
    assert calls == 1                       # every jiggle in one call
    assert got.shape == want.shape == (W, C, 23)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    out = tdec.unpack_output(got)
    assert out.success.sum() == W and (out.fano_overflow == 0).all()
    assert tdec.fano_tally() == want_tally(pre) == {
        "decodes": 1, "speculative_lanes": 4, "speculative_aborted": 0,
        "speculative_looks": 4 * BUDGET}


@pytest.mark.parametrize("scene", ["speculative", "later_jiggles", "none"])
def test_one_call_fano_keeps_the_first_success(scene):
    pre = fano_scene(11, SCENES[scene])
    cfg = PipelineConfig(demod=dc.replace(TOY, fano_compact_lanes=3))
    want = jax_packed(cfg, pre)
    got, calls, tdec = port_packed(cfg, pre)
    assert calls == 1
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    out = tdec.unpack_output(got)
    first = {}
    for w, c, j in SCENES[scene]:
        if pre["gate"][w, c, j]:
            first.setdefault((w, c), j)
    assert {(w, c): int(out.jiggle[w, c]) for w, c in zip(
        *np.nonzero(out.success))} == first
    tally = tdec.fano_tally()
    assert tally == want_tally(pre)
    assert (tally["speculative_lanes"] > 0) == (scene == "speculative")


@pytest.mark.parametrize("cap", [1, 64])
def test_one_jiggle_fano_is_one_call(cap):
    """J == 1 on the compact path: the one-call Fano over jiggle 0 alone
    (no lane to stop) equals the JAX program's single phase."""
    pre = fano_scene()
    pre = {k: v[:, :, :1] if k in ("sync2", "gate", "deint") else v
           for k, v in pre.items()}
    cfg = PipelineConfig(demod=dc.replace(TOY, n_jiggles=1,
                                          fano_compact_lanes=cap))
    want = jax_packed(cfg, pre)
    got, calls, tdec = port_packed(cfg, pre)
    assert calls == 1
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert tdec.unpack_output(got).success.sum() == W
    assert tdec.fano_tally() == {"decodes": 1, "speculative_lanes": 0,
                                 "speculative_aborted": 0,
                                 "speculative_looks": 0}


def test_capped_fano_keeps_two_calls():
    """fano_compact_lanes 0 (the per-window program): phase 2's lanes are
    chosen under fano_max_lanes from what phase 1 left, so the two phases
    stay two calls, equal to the JAX program's, and add nothing to the
    tally."""
    pre = fano_scene(11, SCENES["later_jiggles"])
    cfg = PipelineConfig(demod=dc.replace(TOY, fano_max_lanes=2))
    assert cfg.demod.fano_compact_lanes == 0
    want = jax_packed(cfg, pre)
    got, calls, tdec = port_packed(cfg, pre)
    assert calls == 2
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert tdec.unpack_output(got).fano_overflow.sum() > 0
    assert tdec.fano_tally() == dict.fromkeys(tdec.fano_tally(), 0)
