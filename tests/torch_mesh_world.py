"""One rank of a gloo world that the tests spawn on the CPU.

    python tests/torch_mesh_world.py MODE RANK WORLD_SIZE STORE OUT_DIR

The world has four ranks and meets through a ``file://`` store at STORE
(a path that does not exist yet), so that parallel test workers never race
for a TCP port. ``World`` spawns it. Each rank writes what it saw to
OUT_DIR/<MODE>_rank<RANK>.json (and .npz); the test functions assert on
those. MODE "mesh" (tests/test_torch_mesh.py) runs every check of the
port's ``uwspr_tpu_torch.parallel``; MODE "scaling"
(tests/test_torch_scaling.py) runs ``harness/scaling.py``'s inventory rows
and dry runs on four-rank meshes.

The scenes and configs live here so that the test modules build their
references from the same inputs: ``halo_inputs`` (the halo exchange),
``multihost_scene`` (tests/test_multihost.py's frame across both time
blocks and the tail, at tests/test_device.py::test_sharded_decoder_mesh's
config) and ``stream_scene`` (tests/test_mesh_stream.py's four-channel
stream of two (., 4) steps and a tail); the scaling rows, pod and
multichip meshes below.
"""

from __future__ import annotations

import datetime
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = datetime.timedelta(seconds=120)   # of every collective
WORLD_TIMEOUT_S = 240                       # of a whole world
HALO_CASES = [(2, 4, 6, 15), (2, 4, 20, 15), (2, 1, 6, 15), (1, 8, 5, 23)]
WORLD_HALO_CASES = [(2, 2, 6, 15), (2, 2, 20, 15)]   # halo > and < block
STREAM_MESHES = [(2, 2, 1), (1, 4, 2)]     # (n_channel, n_time, wins)
ENGINES = ("device", "hybrid")
CHUNKS = (10000, 25000, 7000)              # uneven pushes, then the rest
CHECKPOINT_CUT = 20000                     # mid-first-step
# harness/scaling.py on four ranks: (n_channel, n_time, wins_per_shard,
# channels_per_shard) rows at its toy config, the pod program on (4, 1) at
# 4 channels a shard and the multichip stream on (1, 4)
SCALING_ROWS = [(4, 1, 1, 2), (1, 4, 1, 1), (2, 2, 2, 1)]
SCALING_POD = (4, 1, 4)
SCALING_MULTICHIP = (1, 4)


class World:
    """The WORLD processes of one gloo world running MODE, started at
    once; ``ranks()`` waits for them (each must exit 0 within
    WORLD_TIMEOUT_S) and returns what each rank wrote: (results, arrays)
    where it wrote arrays, else the results."""

    def __init__(self, out: pathlib.Path, mode: str):
        self.out, self.mode = out, mode
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, mode, str(r), str(WORLD),
             str(out / "store"), str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(WORLD)]
        self._ranks = None

    def ranks(self):
        import pytest
        if self._ranks is None:
            outs = []
            for p in self.procs:
                try:
                    outs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"the gloo world ({self.mode}) timed out")
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
            self._ranks = []
            for r in range(WORLD):
                res = json.loads((self.out / f"{self.mode}_rank{r}.json")
                                 .read_text())
                npz = self.out / f"{self.mode}_rank{r}.npz"
                self._ranks.append((res, dict(np.load(npz)))
                                   if npz.exists() else res)
        return self._ranks

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def halo_inputs(n_ch, n_time, block_len, halo, seed=0):
    """(n_ch, 2, n_time * block_len) stream and (n_ch, 2, halo) tail."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_ch, 2, n_time * block_len)).astype(np.float32)
    tail = rng.normal(size=(n_ch, 2, halo)).astype(np.float32)
    return x, tail


def decoder_config():
    from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig,
                                        PipelineConfig)
    return PipelineConfig(coarse=CoarseConfig(maxfreqs=8),
                          demod=DemodConfig(maxcycles=64, n_jiggles=3))


def stream_config():
    from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig,
                                        PipelineConfig)
    return PipelineConfig(coarse=CoarseConfig(maxfreqs=4),
                          demod=DemodConfig(maxcycles=10, n_jiggles=3))


def multihost_scene():
    """Two channels of two hops plus the tail; channel 0 holds a whole
    frame at -14 dB that spans both time blocks and the tail. Returns
    (x (2, 2 * hop), tail (2, fl - hop))."""
    from uwspr_tpu_torch.io.channel import noise_sigma
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    hop, halo = 3375, 45000 - 3375
    rng = np.random.default_rng(0)
    sigma = noise_sigma(-14.0)
    x = (rng.normal(scale=sigma, size=(2, 2 * hop))
         + 1j * rng.normal(scale=sigma, size=(2, 2 * hop))
         ).astype(np.complex64)
    tail = (rng.normal(scale=sigma, size=(2, halo))
            + 1j * rng.normal(scale=sigma, size=(2, halo))
            ).astype(np.complex64)
    frame = synthesize_frame("VE3EMB", "FN25", 30, pad_to=None,
                             freq_offset=1.0)
    stream = np.concatenate([x, tail], axis=1)
    stream[0, 300:300 + len(frame)] += frame
    return stream[:, :2 * hop], stream[:, 2 * hop:]


def stream_scene():
    """Four channels, two steps of four hops plus the fl - hop tail, with
    frames in window 0 (channel 0), window 3 (channel 1: its samples come
    from the next step's data) and window 6 (channel 2). Returns (x,
    expected messages)."""
    from uwspr_tpu_torch.io.channel import noise_sigma
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    hop, fl = 3375, 45000
    total = 2 * 4 * hop + (fl - hop)
    rng = np.random.default_rng(7)
    sigma = noise_sigma(-16.0)
    x = (rng.normal(scale=sigma, size=(4, total))
         + 1j * rng.normal(scale=sigma, size=(4, total))).astype(np.complex64)
    expected = set()
    for ch, start, call, grid, dbm in [
            (0, 500, "VE3EMB", "FN25", 30),
            (1, 3 * hop + 100, "K1ABC", "FN42", 37),
            (2, 6 * hop + 300, "W9XYZ", "EM48", 20)]:
        f = synthesize_frame(call, grid, dbm, pad_to=None)
        x[ch, start:start + len(f)] += f
        expected.add(f"{call} {grid} {dbm}")
    return x, expected


def feed(dec, x, chunks=CHUNKS):
    """Push x in uneven chunks, then flush: [(channel, window, message)]."""
    got, pos = [], 0
    for chunk in chunks + (x.shape[1],):
        end = min(pos + chunk, x.shape[1])
        got.extend(dec.push(x[:, pos:end]))
        pos = end
    got.extend(dec.flush())
    return [(ch, w, s.message) for ch, w, s in got]


def run(rank: int, world: int, store: str, out: pathlib.Path) -> None:
    import torch
    import torch.distributed as dist

    from uwspr_tpu_torch.parallel.distributed import (global_mesh,
                                                      initialize,
                                                      process_local_channels)
    from uwspr_tpu_torch.parallel.mesh import (ShardedDecoder,
                                               ShardedStreamDecoder,
                                               extend_with_halo)
    torch.set_num_threads(2)
    init = dict(init_method=f"file://{store}", world_size=world, rank=rank,
                timeout=TIMEOUT)
    res = {"created": initialize("gloo", **init),
           "again": initialize("gloo", **init)}
    try:
        initialize("nccl", **init)
        res["other_backend"] = "no error"
    except ValueError as e:
        res["other_backend"] = str(e)
    try:
        global_mesh(3, 1, "cpu")
        res["wrong_world"] = "no error"
    except ValueError as e:
        res["wrong_world"] = str(e)
    mesh = global_mesh(2, 2, "cpu")
    c, t = mesh.get_coordinate()
    res["coordinate"] = [c, t]
    res["local_channels"] = process_local_channels(4, mesh)
    arrays = {}

    for case in WORLD_HALO_CASES:
        n_ch, n_time, block, halo = case
        x, tail = halo_inputs(*case)
        ext = extend_with_halo(
            torch.from_numpy(x[c:c + 1, :, t * block:(t + 1) * block]),
            torch.from_numpy(tail[c:c + 1]), mesh=mesh, block_len=block,
            halo=halo)
        arrays["halo_" + "_".join(map(str, case))] = ext.numpy()

    x, tail = multihost_scene()
    sd = ShardedDecoder(decoder_config(), mesh)
    packed, n = sd.decode(x, tail)
    arrays["decoder"] = packed.numpy()
    res["decoder_count"] = n
    # the rank's own window, sliced from the stream, through the decoder
    full = np.concatenate([x, tail], axis=1)[c, t * sd.hop:t * sd.hop + sd.fl]
    own = sd.decoder.decode_windows_ri(torch.from_numpy(
        np.stack([full.real, full.imag])[None].astype(np.float32)))
    arrays["decoder_own_window"] = own.numpy()
    start, count = process_local_channels(2, mesh)
    _, res["decoder_count_local"] = sd.decode(
        x[start:start + count], tail[start:start + count], local=True)

    meshes = {(2, 2): mesh, (1, 4): global_mesh(1, 4, "cpu")}
    z, _ = stream_scene()
    for n_ch, n_time, wins in STREAM_MESHES:
        for engine in ENGINES:
            dec = ShardedStreamDecoder(stream_config(), meshes[n_ch, n_time],
                                       n_channels=4, wins_per_shard=wins,
                                       engine=engine)
            res[f"stream_{n_ch}x{n_time}x{wins}_{engine}"] = {
                "spots": feed(dec, z), "steps": dec.stats.steps,
                "windows": dec.stats.windows, "count": dec.stats.spots}

    # interrupted mid-first-step, saved by rank 0, resumed by every rank
    dec = ShardedStreamDecoder(stream_config(), mesh, n_channels=4)
    got = dec.push(z[:, :CHECKPOINT_CUT])
    dec.save_checkpoint(out / "checkpoint")
    dec = ShardedStreamDecoder(stream_config(), mesh, n_channels=4)
    dec.load_checkpoint(out / "checkpoint")
    got += dec.push(z[:, CHECKPOINT_CUT:]) + dec.flush()
    res["checkpoint"] = {"spots": [(ch, w, s.message) for ch, w, s in got],
                         "windows": dec.stats.windows}
    dist.destroy_process_group()
    (out / f"mesh_rank{rank}.json").write_text(json.dumps(res))
    np.savez(out / f"mesh_rank{rank}.npz", **arrays)


def run_scaling(rank: int, world: int, store: str,
                out: pathlib.Path) -> None:
    """harness/scaling.py's rank functions on four ranks: every row of
    SCALING_ROWS (its decode and step inventories, count and spots), a
    barrier under the CollectiveLog, the pod and the multichip dry runs."""
    import torch
    import torch.distributed as dist

    from uwspr_tpu_torch.harness import scaling
    from uwspr_tpu_torch.parallel.distributed import global_mesh, initialize
    torch.set_num_threads(2)
    initialize("gloo", init_method=f"file://{store}", world_size=world,
               rank=rank, timeout=TIMEOUT)
    meshes = {}
    for n_ch, n_time, *_ in (SCALING_ROWS + [SCALING_POD[:2],
                                             SCALING_MULTICHIP]):
        if (n_ch, n_time) not in meshes:
            meshes[n_ch, n_time] = global_mesh(n_ch, n_time, "cpu")
    res = {"rows": [scaling.row_inventory(meshes[row[:2]], row,
                                          scaling.multichip_config())
                    for row in SCALING_ROWS]}
    orig = dist.barrier
    with scaling.CollectiveLog(meshes[2, 2]) as log:
        dist.barrier()
    res["barrier"] = scaling.inventory(log)
    res["restored"] = dist.barrier is orig
    res["pod"] = scaling.dryrun_pod(meshes[SCALING_POD[:2]], SCALING_POD[2])
    res["multichip"] = scaling.dryrun_multichip(meshes[SCALING_MULTICHIP])
    dist.destroy_process_group()
    (out / f"scaling_rank{rank}.json").write_text(json.dumps(res))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    mode, rank, world, store, out = sys.argv[1:]
    {"mesh": run, "scaling": run_scaling}[mode](
        int(rank), int(world), store, pathlib.Path(out))
