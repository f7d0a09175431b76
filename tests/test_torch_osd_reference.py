"""The benchmark's plain OSD (wsprbench/reference/osd.py) and its rescue
(wsprbench/checks/device_plain_osd.py) against the port.

The plain OSD is written from the published description and imports
nothing of the port; on u8 soft symbols every score is an integer, so its
winner bits, flip count, quality and margin equal the port's bit for bit:
the tensor version (``osd_decode_lanes`` on the CPU) and the kernel's lane
logic (csrc/osd_lane.cuh built with g++, as tests/test_torch_osd.py builds
it). Lanes: codewords with 0 to 15 flipped symbols, noise, and the edge
lanes (every symbol 128, heavy ties). Orders 1 to 3 on 32 lanes, order 4 on
4.

The rescue: ``DeviceDecoder._osd_rescue`` on a small eager batch (the
failed candidates compacted to osd_max_lanes in lane order, the rest
dropped; each decoded on its two most-synced gated jiggle lanes; the
calibrated acceptance) equals the reference's rescue on the same fields,
and the decoder's ``osd_counts`` tally what the reference did.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_osd import edge_lanes, lane_decode, lane_lib, lanes  # noqa: F401

from uwspr_tpu_torch.config import DemodConfig, PipelineConfig
from uwspr_tpu_torch.fec import osd_torch
from uwspr_tpu_torch.fec.osd import generator_matrix
from uwspr_tpu_torch.pipeline.device_decoder import OSD_TALLY, DeviceDecoder
from wsprbench.checks import device_plain_osd
from wsprbench.reference import osd as plain

G_T = torch.from_numpy(generator_matrix().astype(np.float32))


def _bits_equal(a, b):
    return np.array_equal(np.asarray(a, np.float32).view(np.int32),
                          np.asarray(b, np.float32).view(np.int32))


def test_generator_is_the_ports():
    np.testing.assert_array_equal(plain.generator(), generator_matrix())


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_plain_osd_equals_the_port_bit_for_bit(lane_lib, order):  # noqa: F811
    soft = np.concatenate([lanes(500 + order, 29, 16), edge_lanes(order)])
    if order == 4:
        soft = soft[[0, 1, -3, -2]]
    ref = plain.decode_lanes(soft, order)
    u, q, m, nf = osd_torch.osd_decode_lanes(
        torch.from_numpy(soft.astype(np.float32)), G_T, order)
    ku, kq, km, knf = lane_decode(lane_lib, soft, order)
    for bits, quality, margin, flips in ((u.numpy(), q.numpy(), m.numpy(),
                                          nf.numpy()), (ku, kq, km, knf)):
        np.testing.assert_array_equal(ref["bits"], bits)
        np.testing.assert_array_equal(ref["flips"], flips)
        assert _bits_equal(ref["quality"], quality)
        assert _bits_equal(ref["margin"], margin)
    np.testing.assert_array_equal(
        plain.payload(ref["bits"]),
        osd_torch.bits_to_payload(torch.from_numpy(ref["bits"])).numpy())


def _rescue_scene(seed, W=3, C=5, J=3):
    """Prefano fields of a small batch: candidates that carry a codeword
    (noisy on each jiggle lane), candidates of noise, gates, worth and the
    Fano's result, drawn from the seed."""
    rng = np.random.default_rng(seed)
    deint = np.clip(np.round(128 + rng.normal(0, 40, (W, C, J, 162))), 0,
                    255).astype(np.uint8)
    sig = rng.random((W, C)) < 0.5
    for w, c in zip(*np.nonzero(sig)):
        cw = plain.encode(rng.integers(0, 2, 50))
        for j in range(J):
            rel = rng.uniform(5, 100, 162)
            s = np.where(cw, 128 + rel, 128 - rel)
            err = rng.choice(162, int(rng.integers(0, 12)), replace=False)
            s[err] = 256 - s[err]
            deint[w, c, j] = np.clip(np.round(s), 0, 255)
    gate = rng.random((W, C, J)) < 0.6
    gate[0, 0] = [True, False, False]          # one gated lane: no agreement
    pre = {"gate": gate, "worth": rng.random((W, C)) < 0.85,
           "sync2": rng.uniform(0.1, 0.9, (W, C, J)).astype(np.float32),
           "deint": deint}
    fano = {"success": rng.random((W, C)) < 0.2,
            "payload": rng.integers(0, 256, (W, C, 7)).astype(np.uint8),
            "jiggle": rng.integers(0, J, (W, C))}
    fano["jiggle"] = np.where(fano["success"], fano["jiggle"], 0)
    return pre, fano


@pytest.mark.parametrize("cap", [3, 64])
def test_rescue_and_its_tally_equal_the_reference(cap):
    """The decoder's rescue (compaction at ``cap``, the two jiggle lanes,
    acceptance) against the reference's on the same fields, twice: the
    tally adds up over decodes."""
    demod = {"osd_depth": 3, "osd_max_lanes": cap, "osd_min_quality": 0.6,
             "osd_min_margin": 0.02, "osd_margin_agree": 0.011}
    dec = DeviceDecoder(PipelineConfig(demod=DemodConfig(**demod)),
                        device="cpu")
    want = dict.fromkeys(OSD_TALLY, 0)
    for seed in (1, 2):
        pre, fano = _rescue_scene(seed)
        ref = device_plain_osd.rescue(pre, fano, demod)
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in pre.items()}
        succ, pay, jb, osd, dropped = dec._osd_rescue(
            t, torch.from_numpy(fano["success"]),
            torch.from_numpy(fano["payload"]), torch.from_numpy(
                fano["jiggle"]))
        succ = succ.numpy() & pre["worth"]
        np.testing.assert_array_equal(succ, ref["success"])
        np.testing.assert_array_equal(osd.numpy(), ref["osd"])
        np.testing.assert_array_equal(pay.numpy()[succ], ref["payload"][succ])
        np.testing.assert_array_equal(jb.numpy()[succ], ref["jiggle"][succ])
        np.testing.assert_array_equal(dropped.numpy().sum(axis=1),
                                      ref["dropped"])
        fail = pre["worth"] & pre["gate"].any(axis=2) & ~fano["success"]
        L = fail.size
        active = min(int(fail.sum()), cap)
        acc = np.flatnonzero(ref["osd"].reshape(L))
        j1 = np.argmax(np.where(pre["gate"], pre["sync2"], -np.inf),
                       axis=2).reshape(L)
        lanes_ = pre["deint"].reshape(L, 3, 162)[acc, j1[acc]]
        margin = plain.decode_lanes(lanes_, 3)["margin"] if len(acc) \
            else np.zeros(0, np.float32)
        by_margin = int((margin >= np.float32(0.02)).sum())
        for k, v in (("decodes", 1), ("active_lanes", active),
                     ("accepted_margin", by_margin),
                     ("accepted_agreement", len(acc) - by_margin),
                     ("dropped", int(fail.sum()) - active)):
            want[k] += v
        assert dec.osd_tally() == want
    assert want["accepted_margin"] > 0
    assert (want["dropped"] > 0) == (cap == 3)


def test_rescue_takes_failed_lanes_in_lane_order():
    """At a cap of one the first failed candidate in window-major order is
    the one decoded; the others are dropped."""
    pre, fano = _rescue_scene(7)
    fano["success"][:] = False
    pre["worth"][:] = True
    pre["gate"][:] = True
    demod = {"osd_depth": 1, "osd_max_lanes": 1, "osd_min_quality": 0.0,
             "osd_min_margin": 0.0, "osd_margin_agree": 0.0}
    ref = device_plain_osd.rescue(pre, fano, demod)
    assert ref["osd"].reshape(-1).tolist() == [1] + [0] * 14
    assert ref["dropped"].tolist() == [4, 5, 5]
    cfg = PipelineConfig(demod=dataclasses.replace(DemodConfig(), **demod))
    dec = DeviceDecoder(cfg, device="cpu")
    out = dec._osd_rescue(
        {k: torch.from_numpy(np.asarray(v)) for k, v in pre.items()},
        torch.from_numpy(fano["success"]), torch.from_numpy(fano["payload"]),
        torch.from_numpy(fano["jiggle"]))
    np.testing.assert_array_equal(out[3].numpy(), ref["osd"])
    assert dec.osd_tally() == {"decodes": 1, "active_lanes": 1,
                               "accepted_margin": 1, "accepted_agreement": 0,
                               "dropped": 14}
