"""uwspr_tpu_torch.fec.fano.fano_decode_jiggles: every gated (candidate,
jiggle) lane of a batch in one call, a lane of jiggle j >= 1 stopped once a
lower jiggle of its candidate has decoded.

On the CPU the call is one plain lockstep call over all the lanes, none
stopped. On a card (tests marked ``cuda``) the kernel is held to the two
launches it replaces (jiggle 0 of every candidate, then the other jiggles
of the candidates it did not decode): the same first success, payload and
count, on a scene with timeouts at a toy budget; every lane it does not
stop bit-identical to one ``fano_decode_batch`` launch and to
``fano_native.cc``; every lane it stops is one whose candidate decoded at
a lower jiggle. The decoder's tally counts the speculative lanes and the
stopped ones.

Imports nothing of JAX or the JAX package, so that the card's tests run
where only the port is installed:

    python3 -m pytest --noconftest tests/test_torch_fano_jiggles.py -m cuda
"""

import numpy as np
import pytest
import torch

from uwspr_tpu_torch.config import DemodConfig, PipelineConfig
from uwspr_tpu_torch.fec import fano
from uwspr_tpu_torch.fec.host import fano_decode_batch_host
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.constants import FANO_METTAB
from uwspr_tpu_torch.protocol.fec_encode import encode_bits

FIELDS = ("success", "data", "metric", "cycles", "maxnp")


def codeword(rng, sigma=8.0):
    """The 162 soft symbols of a random payload's codeword plus noise."""
    bits = rng.integers(0, 2, size=50).astype(np.uint8)
    coded = encode_bits(np.concatenate([bits, np.zeros(31, np.uint8)]))
    soft = np.where(coded == 1, 178.0, 78.0) + rng.normal(0, sigma, 162)
    return np.clip(soft, 0, 255).astype(np.uint8)


def scene(N, J, seed):
    """(N, J, 162) symbols and (N, J) gate: a third of the candidates hold
    a codeword at jiggle 0 and more at some later jiggles (speculative
    lanes, some of which decode), a third at some later jiggles only, a
    third none; every other lane is noise, which runs to the budget."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 256, size=(N, J, 162)).astype(np.uint8)
    gate = rng.random((N, J)) < 0.7
    for n in range(N):
        kind = n % 3
        if kind == 0:
            gate[n, 0] = True
            sym[n, 0] = codeword(rng)
        if kind < 2:
            for j in rng.choice(np.arange(1, J), size=min(3, J - 1),
                                replace=False):
                sym[n, j] = codeword(rng)
    return sym, gate


def first_success(success, data):
    """(any, first jiggle, its 10 bytes) of (N, J) success, (N, J, 10)."""
    success = np.asarray(success)
    jbest = np.argmax(success, axis=1)
    return (success.any(axis=1), jbest,
            np.asarray(data)[np.arange(len(jbest)), jbest])


def test_plain_jiggles_are_one_plain_call():
    sym, gate = scene(12, 4, 1)
    met = torch.from_numpy(FANO_METTAB)
    fano.reset_counters()
    got = fano.fano_decode_jiggles(torch.from_numpy(sym),
                                   torch.from_numpy(gate), met, maxcycles=3)
    assert fano.PLAIN_CALLS == 1 and fano.KERNEL_LAUNCHES == 0
    flat = fano.fano_decode_batch(torch.from_numpy(sym.reshape(-1, 162)),
                                  met, torch.from_numpy(gate.reshape(-1)),
                                  maxcycles=3)
    for k in FIELDS:
        np.testing.assert_array_equal(
            got[k].numpy(), flat[k].numpy().reshape(got[k].shape),
            err_msg=k)
    assert got["success"].shape == (12, 4) and got["data"].shape == (12, 4,
                                                                    10)
    assert not got["aborted"].any() and got["aborted"].dtype == torch.bool
    assert not got["success"][~torch.from_numpy(gate)].any()
    assert got["success"].any()


@pytest.mark.parametrize("N,J", [(1, 1), (7, 3), (40, 17)])
def test_gated_first_orders_the_blocks(N, J):
    """The kernel's block order: every lane b = j*N + n once, the gated
    lanes first, each part in jiggle-major order."""
    gate = torch.from_numpy(np.random.default_rng(N).random((N, J)) < 0.3)
    order = fano.gated_first(gate).numpy()
    flat = gate.t().reshape(-1).numpy()
    n = int(flat.sum())
    assert order.dtype == np.int32
    assert sorted(order) == list(range(N * J))
    np.testing.assert_array_equal(order[:n], np.flatnonzero(flat))
    np.testing.assert_array_equal(order[n:], np.flatnonzero(~flat))


@pytest.mark.parametrize("symbols,gate", [
    ((6, 162), (6,)),           # not (N, J, 162)
    ((3, 2, 160), (3, 2)),      # a short row
    ((3, 2, 162), (2, 3)),      # a gate of another shape
], ids=["flat", "short_row", "gate_shape"])
def test_jiggles_refuses_bad_shapes(symbols, gate):
    with pytest.raises(ValueError):
        fano.fano_decode_jiggles(torch.zeros(symbols, dtype=torch.uint8),
                                 torch.ones(gate, dtype=torch.bool),
                                 torch.from_numpy(FANO_METTAB))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel-against-launches check)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_jiggles_kernel_matches_two_launches_on_card():
    dev = _card()
    N, J, MC = 96, 17, 300
    sym, gate = scene(N, J, 2)
    met = torch.from_numpy(FANO_METTAB).to(dev)
    s, g = torch.from_numpy(sym).to(dev), torch.from_numpy(gate).to(dev)
    fused = fano.fano_decode_jiggles(s, g, met, maxcycles=MC)
    fused = {k: v.cpu().numpy() for k, v in fused.items()}

    # the two launches: jiggle 0, then the other jiggles of the
    # candidates it did not decode
    p1 = fano.fano_decode_batch(s[:, 0], met, g[:, 0], maxcycles=MC)
    succ0 = p1["success"] & g[:, 0]
    rest = g[:, 1:] & ~succ0[:, None]
    p2 = fano.fano_decode_batch(s[:, 1:].reshape(-1, 162), met,
                                rest.reshape(-1), maxcycles=MC)
    two = first_success(
        torch.cat([succ0[:, None], p2["success"].reshape(N, J - 1)
                   & rest], 1).cpu(),
        torch.cat([p1["data"][:, None], p2["data"].reshape(N, J - 1, 10)],
                  1).cpu())
    one = first_success(fused["success"] & gate, fused["data"])
    for a, b, name in zip(one, two, ("any", "jbest", "bytes")):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert one[0].sum() >= N // 2

    # lanes not stopped: one launch over every gated lane, and the native
    # decoder, bit for bit
    full = fano.fano_decode_batch(s.reshape(-1, 162), met, g.reshape(-1),
                                  maxcycles=MC)
    full = {k: v.cpu().numpy().reshape((N, J) + v.shape[1:])
            for k, v in full.items()}
    nat = dict(zip(FIELDS, fano_decode_batch_host(
        sym.reshape(-1, 162), gate.reshape(-1), backend="native",
        device="cpu", maxcycles=MC)))
    stopped = fused["aborted"]
    keep = gate & ~stopped
    for k in FIELDS:
        np.testing.assert_array_equal(fused[k][~stopped], full[k][~stopped],
                                      err_msg=k)
        np.testing.assert_array_equal(
            fused[k][keep], np.asarray(nat[k]).reshape(full[k].shape)[keep]
            .astype(fused[k].dtype), err_msg=k)
    assert (full["cycles"][gate] == MC * 81 + 2).sum() >= N // 2

    # stopped lanes: gated, jiggle >= 1, no success, and a lower jiggle of
    # the candidate decodes
    n, j = np.nonzero(stopped)
    assert len(n) > 0 and gate[n, j].all() and (j >= 1).all()
    assert not fused["success"][n, j].any()
    lower = np.arange(J)[None, :] < j[:, None]
    assert (full["success"][n] & lower).any(axis=1).all()
    # those whose jiggle 0 decodes are among them
    assert (full["success"][n, 0]).any()


@pytest.mark.cuda
def test_decoder_tally_counts_stopped_lanes_on_card():
    dev = _card()
    W, C, J, MC = 2, 12, 17, 60
    sym, gate = scene(W * C, J, 3)
    rng = np.random.default_rng(4)
    pre = {
        "valid": np.ones((W, C), bool), "worth": np.ones((W, C), bool),
        "freq": rng.uniform(-5, 5, (W, C)).astype(np.float32),
        "snr": rng.uniform(-20, 0, (W, C)).astype(np.float32),
        "shift": rng.integers(0, 26, (W, C)).astype(np.int32) * 128,
        "drift": rng.uniform(-1, 1, (W, C)).astype(np.float32),
        "mode": np.zeros((W, C), np.int32),
        "slm_params": np.zeros((W, C, 4), np.float32),
        "sync2": rng.uniform(0, 1, (W, C, J)).astype(np.float32),
        "gate": gate.reshape(W, C, J),
        "deint": sym.reshape(W, C, J, 162),
        "refine_overflow": np.zeros(W, np.int64),
    }
    cfg = PipelineConfig(demod=DemodConfig(n_jiggles=J, maxcycles=MC,
                                           fano_compact_lanes=2 * W))
    out = {}
    for d in ("cpu", dev):
        dec = DeviceDecoder(cfg, device=d)
        with torch.no_grad():
            packed = dec._pack(dec._fano_select_batch(
                {k: torch.from_numpy(v).to(d) for k, v in pre.items()}))
        out[str(d)] = (packed.cpu().numpy(), dec.fano_tally())
    (p_cpu, t_cpu), (p_card, t_card) = out["cpu"], out[str(dev)]
    np.testing.assert_array_equal(p_card.view(np.int32),
                                  p_cpu.view(np.int32))
    assert t_card["decodes"] == t_cpu["decodes"] == 1
    assert t_card["speculative_lanes"] == t_cpu["speculative_lanes"] > 0
    assert t_cpu["speculative_aborted"] == 0
    assert 0 < t_card["speculative_aborted"] <= t_card["speculative_lanes"]
    assert t_card["speculative_looks"] < t_cpu["speculative_looks"]
