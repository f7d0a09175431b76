"""The port's multi-device layer (``uwspr_tpu_torch/parallel/``) against the
JAX package's, on the CPU.

One gloo world of four CPU ranks (tests/torch_mesh_world.py), spawned once
for the module over a ``file://`` store under tmp_path, runs every check
that needs ranks and writes what each rank saw; the JAX references are
built in this process meanwhile (the JAX mesh is the 8-device virtual CPU
grid of conftest.py). This spawner is the port's counterpart of JAX's
``cpu_mesh``.

- The halo: ``assemble_halo`` (the pure half of the exchange) in one
  process against JAX's ``extend_with_halo`` under ``shard_map`` in its
  four cases of tests/test_mesh_stream.py; the chained exchange in the 2x2
  world, halo longer (3 rounds) and shorter (1 round) than the block.
  Element-exact.
- ``ShardedDecoder`` on the 2x2 world against JAX's on a 2x2 mesh at
  tests/test_device.py::test_sharded_decoder_mesh's config, on
  tests/test_multihost.py's frame across both time blocks and the tail, at
  the tolerances of tests/test_torch_decoder.py: messages, valid and
  success equal; freq, shift, drift and mode equal on decoded lanes; snr
  to rel 1e-4, sync to 1e-3; the all-reduced count equal on every rank
  (also with local rows). Each rank's output is bitwise
  ``decode_windows_ri`` on its own window.
- ``ShardedStreamDecoder`` (device and hybrid engines) at (n_channel,
  n_time, wins_per_shard) = (2, 2, 1) and (1, 4, 2) on
  tests/test_mesh_stream.py's scene, pushed in uneven chunks and flushed,
  and through a checkpoint: the port ``StreamDecoder``'s (channel, window,
  message) set, on every rank. Fano budget 10 cycles a bit: a lane of a
  cut frame runs the plain Fano to its budget, about a millisecond a
  cycle on the CPU.
- ``distributed.py``: a second ``initialize`` is a no-op, a mesh of
  another size than the world raises, ``process_local_channels``, and
  NCCL asked for two ranks on one card raises the port's own error.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_world as world_mod
from test_torch_copies import jax_config
from test_torch_decoder import assert_outputs_match
from uwspr_tpu.parallel.mesh import ShardedDecoder as JaxShardedDecoder
from uwspr_tpu.parallel.mesh import extend_with_halo as jax_extend_with_halo
from uwspr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from uwspr_tpu_torch.parallel import distributed as tdist
from uwspr_tpu_torch.parallel.mesh import assemble_halo
from uwspr_tpu_torch.pipeline.device_decoder import (DeviceDecoder,
                                                     DeviceDecoderOutput)
from uwspr_tpu_torch.pipeline.stream import StreamDecoder


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Started before the module's first test, so that the world runs
    while this process compiles the JAX references."""
    w = world_mod.World(tmp_path_factory.mktemp("world"), "mesh")
    yield w
    w.kill()


def jax_halo(case):
    """JAX's extend_with_halo under shard_map: (n_time, n_ch, 2, block +
    halo), and the inputs."""
    n_ch, n_time, block, halo = case
    mesh = jax_make_mesh(n_ch, n_time, devices=jax.devices()[:n_ch * n_time])
    x, tail = world_mod.halo_inputs(*case)

    def fn(x_ri, tail_ri):
        return jax_extend_with_halo(x_ri, tail_ri, n_time=n_time,
                                    block_len=block, halo=halo)[None]
    out = jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P("channel", None, "time"), P("channel", None, None)),
        out_specs=P("time", "channel", None, None)))(x, tail)
    return np.asarray(out), x, tail


# ------------------------------------------------------------------ halo

@pytest.mark.parametrize("case", world_mod.HALO_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_assemble_halo_matches_jax(case):
    """Each time shard's extended row from its own block and the blocks
    the chained exchange hands it (shard (t+m) mod n_time's after round
    m): JAX's rows, element-exact."""
    n_ch, n_time, block, halo = case
    want, x, tail = jax_halo(case)
    k = -(-halo // block)
    for t in range(n_time):
        def blk(s):
            return torch.from_numpy(x[:, :, s * block:(s + 1) * block])
        got = assemble_halo(blk(t), [blk((t + m) % n_time)
                                     for m in range(1, k + 1)],
                            torch.from_numpy(tail), t=t, n_time=n_time,
                            block_len=block, halo=halo)
        np.testing.assert_array_equal(got.numpy(), want[t])


# ------------------------------------------------------------ ShardedDecoder

@pytest.fixture(scope="module")
def jax_decoder_run():
    dec = JaxShardedDecoder(jax_config(world_mod.decoder_config()),
                            jax_make_mesh(2, 2, devices=jax.devices()[:4]))
    x, tail = world_mod.multihost_scene()
    out, n = dec.decode(x, tail)
    return {k: np.asarray(v) for k, v in out.items()}, int(n)


def test_sharded_decoder_matches_jax(world, jax_decoder_run):
    j, _ = jax_decoder_run
    assert j["success"].shape[:2] == (2, 2)
    assert j["success"].sum() >= 1          # the frame decodes
    for res, arrays in world.ranks():
        c, t = res["coordinate"]
        want = DeviceDecoderOutput(**{k: v[c, t][None] for k, v in j.items()})
        assert_outputs_match(DeviceDecoder.unpack_output(arrays["decoder"][0]),
                             want, DeviceDecoder)


def test_sharded_decoder_count_on_every_rank(world, jax_decoder_run):
    j, n = jax_decoder_run
    assert n == int(j["success"].sum())
    for res, _ in world.ranks():
        assert res["decoder_count"] == n
        assert res["decoder_count_local"] == n


def test_rank_output_is_its_windows_decode(world):
    """Each rank's packed output is bitwise decode_windows_ri on its own
    window, sliced from the stream (same device, same W)."""
    for _, arrays in world.ranks():
        np.testing.assert_array_equal(arrays["decoder"][0, 0],
                                      arrays["decoder_own_window"][0])


@pytest.mark.parametrize("case", world_mod.WORLD_HALO_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_exchange_in_a_world_matches_jax(case, world):
    """The exchange over the 2x2 world's time groups: every rank's row is
    JAX's row of its (channel, time) shard."""
    want, _, _ = jax_halo(case)
    key = "halo_" + "_".join(map(str, case))
    for res, arrays in world.ranks():
        c, t = res["coordinate"]
        np.testing.assert_array_equal(arrays[key], want[t][c:c + 1])


# ------------------------------------------------------ ShardedStreamDecoder

@pytest.fixture(scope="module")
def stream_reference():
    """The port StreamDecoder's {(channel, window, message)} on the
    scene."""
    z, expected = world_mod.stream_scene()
    sd = StreamDecoder(world_mod.stream_config(), n_channels=4,
                       engine="device", device="cpu")
    spots, idx = set(), [0] * 4
    for ch, r in sd.push(z):
        spots |= {(ch, idx[ch], s.message) for s in r.spots}
        idx[ch] += 1
    assert idx == [8] * 4
    assert expected <= {m for _, _, m in spots}
    return spots


@pytest.mark.parametrize("engine", world_mod.ENGINES)
@pytest.mark.parametrize("shape", world_mod.STREAM_MESHES,
                         ids=lambda s: "{}x{}-wins{}".format(*s))
def test_sharded_stream_matches_stream_decoder(world, stream_reference,
                                               shape, engine):
    key = "stream_{}x{}x{}_{}".format(*shape, engine)
    runs = [res[key] for res, _ in world.ranks()]
    assert all(r == runs[0] for r in runs[1:]), "ranks disagree"
    run = runs[0]
    assert {tuple(s) for s in run["spots"]} == stream_reference
    assert run["windows"] == 8 * 4
    assert run["count"] == len(run["spots"])
    n_ch, n_time, wins = shape
    assert run["steps"] == 8 // (n_time * wins)


def test_sharded_stream_checkpoint_resume(world, stream_reference):
    """Interrupted mid-first-step, saved by rank 0 and resumed on every
    rank: the uninterrupted spots."""
    for res, _ in world.ranks():
        ck = res["checkpoint"]
        assert {tuple(s) for s in ck["spots"]} == stream_reference
        assert ck["windows"] == 8 * 4


# ----------------------------------------------------------- distributed.py

def test_initialize_again_is_a_no_op(world):
    for res, _ in world.ranks():
        assert res["created"] is True and res["again"] is False
        assert "already initialised on gloo" in res["other_backend"]


def test_global_mesh_needs_the_world_size(world):
    for res, _ in world.ranks():
        assert res["wrong_world"] == "mesh 3x1 needs 3 ranks, the world " \
                                     "has 4"


def test_process_local_channels(world):
    """rank = channel * n_time + time; a 2x2 mesh feeds 4 channels two
    rows per channel shard."""
    for r, (res, _) in enumerate(world.ranks()):
        assert res["coordinate"] == [r // 2, r % 2]
        assert res["local_channels"] == [2 * (r // 2), 2]


def test_nccl_two_ranks_on_one_card_refused(monkeypatch):
    """Two ranks of this host under NCCL and one card: the port's own
    error, naming gloo, before NCCL is reached."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(tdist.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: pytest.fail(
        "set_device reached"))
    with pytest.raises(tdist.SharedDeviceError, match="gloo"):
        tdist.rank_device("cuda")
