"""The port's multi-chip evidence: the collective inventory of the sharded
step and its efficiency bound at H100 interconnect rates, the pod and
multichip dry runs, and the card's own compute controls.

    python -m uwspr_tpu_torch.harness.scaling [--device cuda|cpu] [--out DIR]

Counterpart of scripts/scaling_analytic.py and
scripts/scaling_r05_artifact.py (SCALING_r05.json), scripts/pod_dryrun.py
(DRYRUN_POD_r04.json) and __graft_entry__.py::dryrun_multichip
(MULTICHIP_r05.json). Writes ``scaling.json`` and, on the card,
``dryrun_pod.json`` and ``multichip.json``, each with the card's name and
power limit and a ``vs_reference`` block against the JAX record.

- Inventory. JAX lists the collectives of the compiled program's HLO;
  eager torch compiles no program, but every collective of
  parallel/mesh.py goes through ``dist.batch_isend_irecv`` (the chained
  halo exchange, one call a round), ``dist.all_reduce`` (the spot count)
  or ``dist.all_gather`` (``ShardedStreamDecoder.gather``).
  ``CollectiveLog`` wraps those three and ``dist.barrier`` while a decode
  runs and records what this rank hands each call; ``inventory`` turns
  the log into a SCALING_r05.json row. ``expected_inventory`` is the hand
  formula. The inventory is the same on every backend and device, so a
  world of 8 gloo ranks (``python -m torch.distributed.run``) builds each
  of the record's five meshes with ``make_mesh`` and runs one
  ``ShardedDecoder.decode`` and one ``ShardedStreamDecoder.step`` under
  the log, at the multichip dry run's toy config.
- Controls (on the card only). ``ShardedDecoder.decode`` on a world of one
  over NCCL in this process at ``PipelineConfig()``, on
  scripts/weak_scaling.py's scenes (a decodable -18 dB frame a channel,
  or one frame across every time shard): (1,1) at 1 and 4 channels and
  at 1 and 4 windows a shard, and 128, 256 and 512 channels of one window
  (the channels a chip holds in the pod rows). ``common.timed_call``'s
  discipline; peak device memory. Before the timed calls, one decode of
  each control is recorded: its kernel launches counted and its
  selection and Fano calls replayed against their oracles
  (harness/replay.py's ``KernelReplay``).
- Bound. ``price``: t_compute / (t_compute + t_collectives) with zero
  overlap (scripts/scaling_analytic.py:133-160), at two data-sheet rates
  that were not measured here (the port's NCCL exchange has not run
  between two cards). The NVLink latency a step is an assumption with no
  source, so each row also gives its NVLink bound as a function of it.
  Every row is priced at the fastest per-window compute of the controls
  (the conservative point, as scripts/scaling_r05_artifact.py:34-37 took)
  and at its own control's step; each pod_4096ch row at its control of
  channels per chip.
- Dry runs (on the card only): the same 8 ranks, sharing the card over
  gloo, run scripts/pod_dryrun.py's (8,1) pod program (32 channels at 4 a
  shard, 8 frames, seed 7) and __graft_entry__.py's (2,4) multichip
  stream (a frame across every time-shard boundary, seed 1). Their step
  times are 8 ranks sharing one card: structure, not scaling.
- Kernels. Every recorded run (each row's decode and step, each control's
  first decode, each dry run) counts its kernel launches and plain calls
  (set to 0 just before it, read just after) and replays its selection
  and Fano calls against their oracles (harness/replay.py).

On the CPU (``--device cpu``) only the inventory runs: no time is taken,
no bound is priced and no dry run decodes.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from uwspr_tpu_torch.coarse.search import max_peaks
from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig,
                                    PipelineConfig)
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.harness import common
from uwspr_tpu_torch.harness.replay import (KernelReplay, combined,
                                            counters, reset_counters)
from uwspr_tpu_torch.io.channel import awgn, noise_sigma
from uwspr_tpu_torch.parallel.distributed import (global_mesh, initialize,
                                                  rank_device)
from uwspr_tpu_torch.parallel.mesh import (AXES, ShardedDecoder,
                                           ShardedStreamDecoder)
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

REFERENCE = "SCALING_r05.json"
POD_REFERENCE = "DRYRUN_POD_r04.json"
MULTICHIP_REFERENCE = "MULTICHIP_r05.json"
EXPECTED = "VE3EMB FN25 30"
WORLD = 8
WORLD_TIMEOUT_S = 600
# (n_channel, n_time, wins_per_shard, channels_per_shard): SCALING_r05.json's
# rows (scripts/scaling_r05_artifact.py:47-49)
ROWS = ((8, 1, 1, 1), (8, 1, 1, 4), (1, 8, 1, 1), (1, 8, 4, 1), (2, 4, 4, 1))
POD = (8, 1, 4)             # mesh and channels a shard, pod_dryrun.py:48-52
POD_FRAME_EVERY = 4
MULTICHIP = (2, 4)          # dryrun_multichip(8)'s mesh, __graft_entry__.py
POD_CHANNELS = 4096
POD_LAYOUTS = ((2, 8), (4, 8), (2, 4))      # (hosts, chips a host)
# (scene, channels, wins_per_shard) of the controls on a (1,1) mesh
CONTROLS = (("channel", 1, 1), ("channel", 4, 1), ("time", 1, 1),
            ("time", 1, 4), ("channel", 128, 1), ("channel", 256, 1),
            ("channel", 512, 1))
CONTROL_REPS = 3

# Interconnect rates: data-sheet figures, not measured (the port's NCCL
# exchange has not run between two cards). NVLink 4 on an H100 SXM: 900
# GB/s over both directions together (NVIDIA H100 data sheet), 450 GB/s a
# direction.
NVLINK_BYTES_S = 450e9
# One 400 Gb/s NDR InfiniBand port a GPU (NVIDIA ConnectX-7 data sheet, a
# port a GPU as in a DGX H100): 50 GB/s a direction.
NDR_BYTES_S = 50e9
# Latency of one step of a collective: neither a data-sheet figure nor
# measured. 100 us is the reference's own conservative inter-host round
# (scripts/scaling_analytic.py:183). NVLINK_STEP_S has no source: it is an
# assumption until two cards measure a small NCCL message, and the records
# give every row's NVLink bound as a function of it as well
# (``latency_curve``, at LATENCY_STEPS_S, and the latency at which the
# bound falls to TARGET_EFFICIENCY).
NVLINK_STEP_S = 10e-6
NDR_STEP_S = 100e-6
LATENCY_STEPS_S = (0.0, 1e-6, 3e-6, 10e-6, 30e-6, 100e-6)
TARGET_EFFICIENCY = 0.8     # BASELINE.md:36's scaling target
RATES = {"intra_node_nvlink4": (NVLINK_BYTES_S, NVLINK_STEP_S),
         "inter_node_ndr400": (NDR_BYTES_S, NDR_STEP_S)}
HOP_S = 9.0                 # a window hop: what a step must stay under
# the reference's collective op of each torch.distributed call
HLO_OP = {"batch_isend_irecv": "collective-permute",
          "all_reduce": "all-reduce", "all_gather": "all-gather"}
NOTE_SHARED = "8 ranks sharing one card: structure, not scaling"


# -------------------------------------------------------------- configs

def multichip_config() -> PipelineConfig:
    """__graft_entry__.py:51-55; also the inventory's toy config."""
    return PipelineConfig(coarse=CoarseConfig(maxfreqs=8),
                          demod=DemodConfig(maxcycles=64, n_jiggles=3))


def pod_config() -> PipelineConfig:
    """scripts/pod_dryrun.py:60."""
    return PipelineConfig(demod=DemodConfig(maxcycles=512))


# --------------------------------------------------------------- scenes

def _geometry(config: PipelineConfig) -> tuple[int, int, int]:
    """(fl, hop, halo) in samples."""
    s = config.stream
    return s.fl, s.shift * s.fs, s.fl - s.shift * s.fs


def channel_scene(channels: int, wps: int, seed: int = 0):
    """scripts/weak_scaling.py:91-106 (axis "channel", one time shard):
    ``channels`` rows of -18 dB noise, each with a whole "VE3EMB FN25 30"
    frame at a random start and offset -> (x (channels, wps * hop), tail
    (channels, fl - hop))."""
    fl, hop, halo = _geometry(PipelineConfig())
    total = wps * hop
    rng = np.random.default_rng(seed)
    x = np.stack([awgn(np.zeros(total + halo, dtype=np.complex64), -18.0,
                       rng=rng) for _ in range(channels)])
    for c in range(channels):
        start = int(rng.integers(0, 500))
        z = np.asarray(synthesize_frame(
            "VE3EMB", "FN25", 30, start_sample=0,
            freq_offset=float(rng.uniform(-3, 3))))[:fl]
        m = min(len(z), total + halo - start)
        x[c, start:start + m] += z[:m]
    return x[:, :total], x[:, total:]


def time_scene(channels: int, n_time: int, wps: int, seed: int = 0):
    """scripts/weak_scaling.py:91-114 (axis "time"; there ``channels`` is
    1): rows of -18 dB noise and one frame at the head of row 0, whose
    samples span every time shard -> (x (channels, n_time * wps * hop),
    tail)."""
    fl, hop, halo = _geometry(PipelineConfig())
    total = n_time * wps * hop
    rng = np.random.default_rng(seed)
    x = np.stack([awgn(np.zeros(total + halo, dtype=np.complex64), -18.0,
                       rng=rng) for _ in range(channels)])
    z = np.asarray(synthesize_frame("VE3EMB", "FN25", 30, start_sample=200,
                                    freq_offset=1.0))[:fl]
    m = min(len(z), total + halo)
    x[0, :m] += z[:m]
    return x[:, :total], x[:, total:]


def row_scene(row):
    """A mesh row's input: the channel scene when the time axis is 1, else
    the time scene."""
    n_ch, n_t, wps, cps = row
    if n_t == 1:
        return channel_scene(n_ch * cps, wps)
    return time_scene(n_ch * cps, n_t, wps)


def pod_scene(n_shards: int, cps: int, seed: int = 7):
    """scripts/pod_dryrun.py:63-77: n_shards * cps channels of -16 dB noise,
    one hop plus the tail, a frame in every POD_FRAME_EVERY-th channel ->
    (x, tail, frames embedded)."""
    fl, hop, halo = _geometry(pod_config())
    channels, total = n_shards * cps, hop
    rng = np.random.default_rng(seed)
    sigma = noise_sigma(-16.0)
    x = (rng.normal(scale=sigma, size=(channels, total + halo))
         + 1j * rng.normal(scale=sigma, size=(channels, total + halo))
         ).astype(np.complex64)
    embedded = range(0, channels, POD_FRAME_EVERY)
    for c in embedded:
        z = np.asarray(synthesize_frame(
            "VE3EMB", "FN25", 30, start_sample=int(rng.integers(0, 400)),
            freq_offset=float(rng.uniform(-3, 3))))[:fl]
        m = min(len(z), total + halo)
        x[c, :m] += z[:m]
    return x[:, :total], x[:, total:], len(embedded)


def multichip_scene(channels: int, total: int, seed: int = 1):
    """__graft_entry__.py:57-62: faint noise and the frame at sample 700 of
    channel 0 -> (channels, total)."""
    rng = np.random.default_rng(seed)
    x = (0.005 * (rng.normal(size=(channels, total))
                  + 1j * rng.normal(size=(channels, total)))
         ).astype(np.complex64)
    frame = synthesize_frame("VE3EMB", "FN25", 30, pad_to=None)
    x[0, 700:700 + len(frame)] += frame
    return x


# ------------------------------------------------------------ inventory

def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CollectiveLog:
    """While active, records every call this rank makes to
    ``dist.batch_isend_irecv``, ``dist.all_reduce``, ``dist.all_gather``
    and ``dist.barrier``: the op, the mesh axis of its group ("channel",
    "time" or "world"), the group's size, the bytes this rank hands the
    call to send (the isend tensors of a round, the all_reduce tensor, the
    rank's all_gather block; under gloo the pinned host tensors the
    exchange really moves) and their dtype. One batch_isend_irecv is one
    round. parallel/mesh.py looks the calls up through ``dist.`` when it
    makes them, so the wrappers see them; nothing it sends changes."""

    NAMES = ("batch_isend_irecv", "all_reduce", "all_gather", "barrier")

    def __init__(self, mesh):
        self.mesh = mesh
        self.calls: list[dict] = []

    def _axis(self, group) -> tuple[str, int]:
        if group is None or group is dist.GroupMember.WORLD:
            return "world", dist.get_world_size()
        ranks = sorted(dist.get_process_group_ranks(group))
        c, t = self.mesh.get_coordinate()
        lines = {"time": self.mesh.mesh[c].tolist(),
                 "channel": self.mesh.mesh[:, t].tolist()}
        axis = next((a for a in AXES if sorted(lines[a]) == ranks), "group")
        return axis, len(ranks)

    def _note(self, name: str, args: dict) -> None:
        if name == "batch_isend_irecv":
            ops = args["p2p_op_list"]
            sends = [p.tensor for p in ops if p.op is dist.isend]
            group = ops[0].group
            sent = sum(t.nbytes for t in sends)
            dtype = _dtype(sends[0]) if sends else None
        elif name == "barrier":
            group, sent, dtype = args.get("group"), 0, None
        else:
            group, sent, dtype = (args.get("group"), args["tensor"].nbytes,
                                  _dtype(args["tensor"]))
        axis, size = self._axis(group)
        self.calls.append({"op": name, "axis": axis, "group_size": size,
                           "bytes": sent, "dtype": dtype})

    def __enter__(self):
        self.orig = {n: getattr(dist, n) for n in self.NAMES}
        for name, fn in self.orig.items():
            setattr(dist, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)

        def call(*a, **kw):
            self._note(name, sig.bind(*a, **kw).arguments)
            return fn(*a, **kw)
        return call

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(dist, name, fn)


def _summary(collectives: list[dict]) -> dict:
    """A SCALING_r05.json row's inventory fields from a list of calls,
    plus the port's all_gather under its own name."""
    def total(op):
        return sum(o["bytes"] for o in collectives if o["op"] == op)
    return {"collectives": collectives,
            "collective_rounds": len(collectives),
            "ppermute_bytes_per_device_per_step": total("batch_isend_irecv"),
            "allreduce_bytes_per_device_per_step": total("all_reduce"),
            "allgather_bytes_per_device_per_step": total("all_gather")}


def inventory(log: CollectiveLog) -> dict:
    return _summary(list(log.calls))


def expected_inventory(n_ch: int, n_t: int, wps: int, cps: int,
                       config: PipelineConfig, *, step: bool = False
                       ) -> dict:
    """The hand formula of one ``ShardedDecoder.decode`` (``step``: one
    ``ShardedStreamDecoder.step``) on an (n_ch, n_t) mesh at wps windows
    and cps channels a shard: k = ceil(halo / block) exchange rounds on the
    time axis (none when it is 1), block = wps * hop, each sending the
    rank's (cps, 2, block) float32 planes; one all_reduce of the int64
    spot count over the world; the step adds one all_gather of the rank's
    packed (cps, wps, C, 23) float32 block, C = max_peaks(config.coarse)."""
    _, hop, halo = _geometry(config)
    block, world = wps * hop, n_ch * n_t
    k = 0 if n_t == 1 else -(-halo // block)
    calls = [{"op": "batch_isend_irecv", "axis": "time", "group_size": n_t,
              "bytes": cps * block * 8, "dtype": "float32"}] * k
    calls.append({"op": "all_reduce", "axis": "world", "group_size": world,
                  "bytes": 8, "dtype": "int64"})
    if step:
        calls.append({"op": "all_gather", "axis": "world",
                      "group_size": world,
                      "bytes": cps * wps * max_peaks(config.coarse) * 23 * 4,
                      "dtype": "float32"})
    return _summary([dict(c) for c in calls])


def price(inv: dict, t_compute: float, rate: tuple[float, float]) -> dict:
    """The efficiency bound t_compute / (t_compute + t_collectives), zero
    overlap (scripts/scaling_analytic.py:133-160). ``rate`` is (bytes/s a
    direction, seconds a latency step). Bytes on a device's link: a
    round's bytes, the all_reduce's payload, and (n - 1) blocks of a ring
    all_gather over n ranks. Latency steps: one a round, ceil(log2 n) a
    tree all_reduce or barrier (the reference's pod rows), n - 1 a ring
    all_gather."""
    bw, step_s = rate
    wire, steps = 0, 0
    for o in inv["collectives"]:
        n = o["group_size"]
        if o["op"] == "all_gather":
            wire += (n - 1) * o["bytes"]
            steps += n - 1
        elif o["op"] in ("all_reduce", "barrier"):
            wire += o["bytes"]
            steps += math.ceil(math.log2(n)) if n > 1 else 0
        else:
            wire += o["bytes"]
            steps += 1
    t_coll = wire / bw + steps * step_s
    return {"t_compute_s": t_compute, "t_collectives_s": t_coll,
            "wire_bytes": wire, "latency_steps": steps,
            "efficiency_bound": t_compute / (t_compute + t_coll)}


def latency_curve(inv: dict, t_compute: float, bytes_s: float) -> dict:
    """``price`` at ``bytes_s`` as a function of the latency of one step:
    the bound at each of LATENCY_STEPS_S, and the latency a step at which
    the bound falls to TARGET_EFFICIENCY (None when no step has latency;
    negative when the bytes alone already bring it below)."""
    at = {f"{lat:g}": price(inv, t_compute, (bytes_s, lat))
          for lat in LATENCY_STEPS_S}
    zero = at["0"]
    steps = zero["latency_steps"]
    budget = t_compute * (1 / TARGET_EFFICIENCY - 1)
    return {"latency_steps": steps, "wire_s": zero["t_collectives_s"],
            "efficiency_bound_at_latency_step_s": {
                k: v["efficiency_bound"] for k, v in at.items()},
            f"latency_step_s_for_bound_{TARGET_EFFICIENCY:g}": (
                (budget - zero["t_collectives_s"]) / steps if steps
                else None)}


# --------------------------------------------------------- a rank's part

def _block_messages(dec: ShardedDecoder, packed: torch.Tensor) -> list:
    """[channel, global window, message] of this rank's own packed
    (ch_l, n_win, C, 23) block, unpacked on its host (no collective)."""
    ch_l, n_win = packed.shape[:2]
    c, t = dec.mesh.get_coordinate()
    out = dec.decoder.unpack_output(packed.reshape((-1,) + packed.shape[2:]))
    return [[c * ch_l + i // n_win, t * n_win + i % n_win, m]
            for i in range(ch_l * n_win)
            for m in dec.decoder.messages(out.window(i))]


def _logged(mesh, fn):
    """(fn(), the inventory of the collectives it made)."""
    with CollectiveLog(mesh) as log:
        out = fn()
    return out, inventory(log)


def row_inventory(mesh, row, config: PipelineConfig) -> dict:
    """One ``ShardedDecoder.decode`` and one ``ShardedStreamDecoder.step``
    of a mesh row on its scene, each under a CollectiveLog, with its
    kernel calls counted and replayed (``_recorded``). Collective: every
    rank of the mesh calls it."""
    n_ch, n_t, wps, cps = row
    x, tail = row_scene(row)
    dec = ShardedDecoder(config, mesh)
    (count, d), kd = _recorded(
        lambda: _logged(mesh, lambda: dec.decode(x, tail)[1]), dec.device)
    count = int(count)
    sdec = ShardedStreamDecoder(config, mesh, n_channels=n_ch * cps,
                                wins_per_shard=wps)
    (spots, s), ks = _recorded(
        lambda: _logged(mesh, lambda: sdec.step(x, tail, n_t * wps)),
        dec.device)
    return {"row": list(row), "coordinate": list(mesh.get_coordinate()),
            "decode": d, "step": s, "count": count,
            "spots": [[c, w, sp.message] for c, w, sp in spots],
            "kernels": {"decode": kd, "step": ks}}


def _recorded(fn, device: torch.device):
    """fn() with the kernel counts set to 0 just before it and read just
    after, and its selection and Fano calls replayed against their
    oracles (harness/replay.py): (result, {"launches", "plain",
    "replay"})."""
    with KernelReplay() as calls:
        reset_counters()
        out = fn()
        common.sync(device)
        launches, plain = counters()
    return out, {"launches": launches, "plain": plain,
                 "replay": calls.replay()}


def _step_seconds(fn, device: torch.device) -> float:
    t0 = time.perf_counter()
    fn()
    common.sync(device)
    return time.perf_counter() - t0


def dryrun_pod(mesh, cps: int) -> dict:
    """scripts/pod_dryrun.py on ``mesh`` (time axis 1) at ``cps`` channels
    a shard: one recorded decode, then one timed decode. Collective."""
    dec = ShardedDecoder(pod_config(), mesh)
    x, tail, frames = pod_scene(mesh.shape[0], cps)
    (packed, n), kernels = _recorded(lambda: dec.decode(x, tail),
                                     dec.device)
    return {"spots": int(n), "frames_embedded": frames,
            "messages": _block_messages(dec, packed),
            "step_seconds": _step_seconds(lambda: dec.decode(x, tail),
                                          dec.device), **kernels}


def dryrun_multichip(mesh) -> dict:
    """__graft_entry__.py::dryrun_multichip on ``mesh``: the stream of one
    step and its tail pushed through ShardedStreamDecoder (one channel a
    channel shard), recorded; then one timed step. Collective."""
    n_ch = mesh.shape[0]
    dec = ShardedStreamDecoder(multichip_config(), mesh, n_channels=n_ch)
    L, halo = dec.step_len, dec.halo
    x = multichip_scene(n_ch, L + halo)
    spots, kernels = _recorded(lambda: dec.push(x), dec.dec.device)
    res = {"spots": [[c, w, s.message] for c, w, s in spots],
           "windows": dec.stats.windows, "count": dec.stats.spots,
           **kernels}
    n_win = L // dec.hop
    res["step_seconds"] = _step_seconds(
        lambda: dec.step(x[:, :L], x[:, L:], n_win), dec.dec.device)
    return res


def rank_main(out_dir: str | os.PathLike, device_type: str) -> int:
    """One rank of the WORLD-rank gloo world, from the launcher's
    environment: the inventory of every row of ROWS, then, on the card,
    both dry runs. Rank 0 gathers every rank's results into
    out_dir/ranks.json."""
    initialize("gloo")
    try:
        rank_device(device_type)
        if device_type == "cuda":
            from uwspr_tpu_torch.utils import cuda_build
            cuda_build.load_library()
        meshes = {}

        def mesh(n_ch, n_t):
            if (n_ch, n_t) not in meshes:
                meshes[n_ch, n_t] = global_mesh(n_ch, n_t, device_type)
            return meshes[n_ch, n_t]
        res = {"rank": dist.get_rank(),
               "rows": [row_inventory(mesh(*row[:2]), row,
                                      multichip_config()) for row in ROWS]}
        if device_type == "cuda":
            res["pod"] = dryrun_pod(mesh(*POD[:2]), POD[2])
            res["multichip"] = dryrun_multichip(mesh(*MULTICHIP))
        ranks = [None] * dist.get_world_size() if res["rank"] == 0 else None
        dist.gather_object(res, ranks, dst=0)
        if res["rank"] == 0:
            (pathlib.Path(out_dir) / "ranks.json").write_text(
                json.dumps(ranks))
    finally:
        dist.destroy_process_group()
    return 0


def run_world(out_dir: pathlib.Path, rank_cmd: list[str]) -> list[dict]:
    """``rank_cmd`` (the arguments after the interpreter) as WORLD ranks
    under ``python -m torch.distributed.run --standalone``; every rank's
    results, which rank 0 wrote to out_dir/ranks.json."""
    env = dict(os.environ, PYTHONPATH=str(common.ROOT), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), *rank_cmd],
        capture_output=True, text=True, cwd=common.ROOT, env=env,
        timeout=WORLD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"the {WORLD}-rank world exited "
                           f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    common.log(f"the {WORLD}-rank world ran in "
               f"{time.perf_counter() - t0:.1f} s")
    return json.loads((out_dir / "ranks.json").read_text())


# ------------------------------------------------------------- controls

def _control(dec: ShardedDecoder, spec) -> dict:
    scene, channels, wps = spec
    x, tail = (channel_scene(channels, wps) if scene == "channel"
               else time_scene(channels, 1, wps))
    dev = dec.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    (_, n), kernels = _recorded(lambda: dec.decode(x, tail), dev)
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2**20 if cuda \
        else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prog = dec.decoder.program
    seen = set() if prog is None else set(prog.captures)
    b = common.timed_call(lambda: dec.decode(x, tail), dev, CONTROL_REPS)
    windows = channels * wps
    return {"scene": scene, "channels": channels, "wins_per_shard": wps,
            "windows": windows, "spots_recorded": int(n),
            "kernels": kernels,
            "frames_embedded": channels if scene == "channel" else 1,
            "spots": int(b.out[1]), "step_s": b.seconds,
            "step_event_s": b.event_seconds, "first_s": b.first_seconds,
            "ms_per_window": b.seconds / windows * 1e3,
            "ms_per_window_events": (None if b.event_seconds is None else
                                     b.event_seconds / windows * 1e3),
            "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                         if cuda else None),
            "eager_peak_mib": eager_peak,
            # the warm step's capture of this control's shape, if new: its
            # seconds, its growth of the card's graph pool and the pool
            "capture": (None if prog is None else next(
                (v for k, v in prog.captures.items() if k not in seen),
                None))}


def controls(device: torch.device) -> dict:
    """Each control of CONTROLS, ``ShardedDecoder.decode`` at
    ``PipelineConfig()`` on a (1,1) mesh: a world of one in this process,
    over NCCL on the card (gloo on the CPU). Each control's first decode is
    recorded (``_recorded``: counts set to 0 just before, read just after,
    every selection and Fano call replayed), outside its timed calls; the
    rows, and the launches, plain calls and replays of those decodes
    summed."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        initialize(backend, init_method=f"file://{tmp}/store", world_size=1,
                   rank=0)
        try:
            dec = ShardedDecoder(PipelineConfig(),
                                 global_mesh(1, 1, device.type))
            rows = []
            for spec in CONTROLS:
                rows.append(_control(dec, spec))
                r = rows[-1]
                common.log(f"control {spec}: {r['spots']}/"
                           f"{r['frames_embedded']} spots, "
                           f"{r['step_s'] * 1e3:.3f} ms a step, "
                           f"{r['ms_per_window']:.4f} ms/window")
        finally:
            dist.destroy_process_group()
    return {"note": ("ShardedDecoder.decode on a (1,1) mesh over NCCL, "
                     "world of one, PipelineConfig(), "
                     "scripts/weak_scaling.py's scenes; one warm step, "
                     f"then {CONTROL_REPS} timed; a recorded decode of "
                     "each before them, its kernel calls replayed"),
            "rows": rows, **combined([r["kernels"] for r in rows])}


# -------------------------------------------------------------- records

def _control_of(ctl: list[dict], scene: str, channels: int, wps: int):
    return next(c for c in ctl if (c["scene"], c["channels"],
                                   c["wins_per_shard"]) == (scene, channels,
                                                            wps))


def _fastest(c: dict) -> tuple[float, str]:
    """A control's step seconds on the faster of its two clocks."""
    ev = c["step_event_s"]
    return ((ev, "cuda_events") if ev is not None and ev < c["step_s"]
            else (c["step_s"], "host_clock"))


def headline_point(ctl: list[dict]) -> dict:
    """The fastest per-window compute of the controls, on either clock:
    the smaller the compute term, the larger the collectives' share, so
    the bound it gives is the lowest (scripts/scaling_r05_artifact.py:
    34-37)."""
    best = min(ctl, key=lambda c: _fastest(c)[0] / c["windows"])
    s, clock = _fastest(best)
    return {"t_compute_per_window_s": s / best["windows"],
            "control": [best["scene"], best["channels"],
                        best["wins_per_shard"]], "clock": clock}


def _vs_row(got: dict, ref: dict) -> dict:
    """The port's decode inventory against a SCALING_r05.json row, with
    every difference listed."""
    ref_pp = [o for o in ref["collectives"]
              if o["op"] == "collective-permute"]
    ref_ar = [o for o in ref["collectives"] if o["op"] == "all-reduce"]
    pp = [o for o in got["collectives"] if o["op"] == "batch_isend_irecv"]
    ar = [o for o in got["collectives"] if o["op"] == "all_reduce"]
    differences = [
        f"op names: torch.distributed's {o} is the HLO's {h}"
        for o, h in HLO_OP.items() if any(c["op"] == o
                                          for c in got["collectives"])]
    for a, b in zip(ar, ref_ar):
        if a["bytes"] != b["bytes"]:
            differences.append(
                f"the spot count's all_reduce is {a['dtype']} "
                f"({a['bytes']} B) where JAX's psum is {b['result_type']} "
                f"({b['bytes']} B; parallel/mesh.py keeps int64)")
    if [o["bytes"] for o in pp] != [o["bytes"] for o in ref_pp]:
        differences.append("the exchange rounds' bytes differ")
    return {"collective_rounds": {"port": got["collective_rounds"],
                                  "reference": ref["collective_rounds"]},
            "ppermute_rounds": {"port": len(pp), "reference": len(ref_pp)},
            "ppermute_bytes_per_device_per_step": {
                "port": got["ppermute_bytes_per_device_per_step"],
                "reference": ref["ppermute_bytes_per_device_per_step"]},
            "all_reduces": {"port": len(ar), "reference": len(ref_ar)},
            "allreduce_bytes_per_device_per_step": {
                "port": got["allreduce_bytes_per_device_per_step"],
                "reference": ref["allreduce_bytes_per_device_per_step"]},
            "differences": differences,
            "pass": (got["collective_rounds"] == ref["collective_rounds"]
                     and got["ppermute_bytes_per_device_per_step"]
                     == ref["ppermute_bytes_per_device_per_step"]
                     and len(ar) == len(ref_ar) == 1)}


def _bounds(inv: dict, t_compute: float) -> dict:
    return {name: price(inv, t_compute, rate)
            for name, rate in RATES.items()}


def scaling_record(ranks: list[dict], measured: dict | None,
                   head: dict) -> dict:
    """scaling.json: every row's inventory (every rank's equal to the hand
    formula and to the record) and its kernel calls (replayed on every
    rank; on the card launched, no plain call); its bounds and the pod
    rows' bounds when the controls were measured (on the card), and the
    controls. A row's decode is priced as recorded (its bytes do not
    depend on the coarse or demod config); its step at PipelineConfig()'s
    all_gather (``step_served``: the formula, which the recorded step at
    the toy config meets), the block the served config gathers."""
    ctl = measured["rows"] if measured else None
    ref = common.load_record(REFERENCE)
    refrows = {(r["mesh"]["channel"], r["mesh"]["time"], r["wins_per_shard"],
                r["channels_per_shard"]): r for r in ref["headline"]["rows"]}
    point = headline_point(ctl) if ctl else None
    rows = []
    for i, row in enumerate(ROWS):
        n_ch, n_t, wps, cps = row
        per_rank = [r["rows"][i] for r in ranks]
        got = per_rank[0]
        want_d = expected_inventory(*row, multichip_config())
        want_s = expected_inventory(*row, multichip_config(), step=True)
        served = expected_inventory(*row, PipelineConfig(), step=True)
        n_d = len(got["decode"]["collectives"])
        added = got["step"]["collectives"][n_d:]
        runs = [r["kernels"][k] for r in per_rank for k in ("decode",
                                                            "step")]
        out = {"config": f"({n_ch},{n_t}) wins_per_shard={wps} "
                         f"channels_per_shard={cps}",
               "mesh": {"channel": n_ch, "time": n_t},
               "wins_per_shard": wps, "channels_per_shard": cps,
               "windows_per_step": n_ch * n_t * wps * cps,
               "decode": got["decode"], "step": got["step"],
               "step_served": {k: v for k, v in served.items()
                               if k != "collectives"},
               "spots": got["spots"], "count": got["count"],
               "kernels": {k: combined([r["kernels"][k]
                                        for r in per_rank])
                           for k in ("decode", "step")},
               "vs_reference": {"inventory": _vs_row(got["decode"],
                                                     refrows[row])},
               "exact": {
                   "decode_is_the_formula": all(
                       r["decode"] == want_d for r in per_rank),
                   "step_is_the_formula": all(
                       r["step"] == want_s for r in per_rank),
                   "step_adds_one_all_gather": (
                       got["step"]["collectives"][:n_d]
                       == got["decode"]["collectives"]
                       and [o["op"] for o in added] == ["all_gather"]),
                   "same_spots_on_every_rank": all(
                       r["spots"] == got["spots"]
                       and r["count"] == got["count"] for r in per_rank),
                   **(_kernels_exact(runs) if ctl else
                      {"replayed_bit_exact": all(r["replay"]["ok"]
                                                 for r in runs)})}}
        out["vs_reference"]["inventory"]["differences"].append(
            f"ShardedStreamDecoder.step adds one all_gather of "
            f"{served['allgather_bytes_per_device_per_step']} B a rank at "
            f"PipelineConfig() ("
            f"{got['step']['allgather_bytes_per_device_per_step']} B at the "
            f"toy config: its packed (ch_l, n_win, C, 23) float32 block) "
            f"that the JAX step does not have: its host fetches the sharded "
            f"outputs")
        if ctl:
            own = _control_of(ctl, "channel" if n_t == 1 else "time", cps,
                              wps)
            t_head = point["t_compute_per_window_s"] * wps * cps
            out["bound"] = {"decode": _bounds(got["decode"], t_head),
                            "step": _bounds(served, t_head)}
            out["bound_own_control"] = {
                "control": [own["scene"], own["channels"], wps],
                "decode": _bounds(got["decode"], _fastest(own)[0]),
                "step": _bounds(served, _fastest(own)[0])}
            out["nvlink_latency_curve"] = {
                "decode": latency_curve(got["decode"], t_head,
                                        NVLINK_BYTES_S),
                "step": latency_curve(served, t_head, NVLINK_BYTES_S)}
        rows.append(out)
    pod = []
    for (hosts, cph), refpod in zip(POD_LAYOUTS,
                                    ref["headline"]["pod_4096ch"]):
        chips = hosts * cph
        cpc = -(-POD_CHANNELS // chips)
        inv = expected_inventory(chips, 1, 1, cpc, PipelineConfig(),
                                 step=True)
        r = {"hosts": hosts, "chips_per_host": cph, "chips": chips,
             "channels": POD_CHANNELS, "channels_per_chip": cpc,
             "inventory": {k: v for k, v in inv.items()
                           if k != "collectives"},
             "reference": {"channels_per_chip": refpod["channels_per_chip"],
                           "efficiency_bound_dcn_v5e_compute":
                               refpod["efficiency_bound_dcn"]}}
        if ctl:
            t = _fastest(_control_of(ctl, "channel", cpc, 1))[0]
            b = price(inv, t, RATES["inter_node_ndr400"])
            r["bound_inter_node_ndr400"] = b
            r["realtime_headroom"] = HOP_S / (t + b["t_collectives_s"])
        pod.append(r)
    exact = {}
    if ctl:
        exact["controls_decode_every_frame"] = all(
            c["spots"] == c["frames_embedded"] for c in ctl)
        exact["controls_launched_no_plain"] = (
            all(c["kernels"]["launches"]["select_best"] > 0
                and c["kernels"]["launches"]["fano_decode"] > 0
                for c in ctl)
            and not any(measured["plain"].values()))
        exact["controls_replayed_bit_exact"] = measured["replay"]["ok"]
    return {**head,
            "method": (
                "collectives recorded at the torch.distributed calls of "
                "parallel/mesh.py (CollectiveLog) in a world of "
                f"{WORLD} gloo ranks, one decode and one stream step a "
                "row at the multichip dry run's toy config; the bytes are "
                "those handed to each call. Bounds assume ZERO "
                "compute/communication overlap at data-sheet rates that "
                "were not measured, with the card's own measured compute; "
                "the NVLink latency a step has no source (an assumption "
                "until two cards measure it): each row also gives the "
                "NVLink bound as a function of it (nvlink_latency_curve)"),
            "rates": {
                "intra_node_nvlink4": {
                    "bytes_per_s_per_direction": NVLINK_BYTES_S,
                    "latency_step_s": NVLINK_STEP_S,
                    "source": "NVIDIA H100 SXM data sheet, NVLink 4: 900 "
                              "GB/s both directions; the latency is "
                              "assumed, with no source"},
                "inter_node_ndr400": {
                    "bytes_per_s_per_direction": NDR_BYTES_S,
                    "latency_step_s": NDR_STEP_S,
                    "source": "one 400 Gb/s NDR InfiniBand port a GPU "
                              "(ConnectX-7 data sheet); the latency is "
                              "scripts/scaling_analytic.py's inter-host "
                              "round, assumed"},
                "measured": False},
            "headline": point or "not measured (CPU run: no controls)",
            "rows": rows,
            "pod_4096ch": {
                "note": ("channel-sharded: each chip decodes its "
                         "channels' window; the collectives are the spot "
                         "count's all_reduce and the stream step's "
                         "all_gather, priced across hosts; t_compute is "
                         "the control of the chip's channels"),
                "rows": pod},
            "controls": measured or "not measured (CPU run)",
            "kernels": {"inventory": combined(
                [r["kernels"][k] for r in rows for k in ("decode",
                                                          "step")])},
            "diagnostics": ("scripts/weak_scaling.py's oversubscribed "
                            "virtual-device rows are not ported: "
                            "SCALING_r05.json keeps them only as "
                            "environment diagnostics"),
            "exact": exact}


def _kernels_exact(runs: list[dict]) -> dict:
    """The kernels of recorded runs on the card: selection and Fano
    launched in every run (the per-window Fano cap launches on inactive
    lanes too), no plain call, every call replayed bit-exact."""
    return {"kernels_launched_on_every_rank": all(
                r["launches"]["select_best"] > 0
                and r["launches"]["fano_decode"] > 0 for r in runs),
            "no_plain_call": not any(v for r in runs
                                     for v in r["plain"].values()),
            "replayed_bit_exact": all(r["replay"]["ok"] for r in runs)}


def pod_record(ranks: list[dict], head: dict) -> dict:
    ref = common.load_record(POD_REFERENCE)
    runs = [r["pod"] for r in ranks]
    n = runs[0]["spots"]
    messages = sorted(m for r in runs for m in r["messages"])
    return {**head, "mesh": {"channel": POD[0], "time": POD[1]},
            "channels": POD[0] * POD[2], "channels_per_shard": POD[2],
            "frames_embedded": runs[0]["frames_embedded"], "spots": n,
            "messages": messages, "note": NOTE_SHARED,
            "step_seconds_by_rank": [r["step_seconds"] for r in runs],
            "launches_by_rank": [r["launches"] for r in runs],
            "plain_calls_by_rank": [r["plain"] for r in runs],
            "replay_by_rank": [r["replay"] for r in runs],
            "kernels": combined(runs),
            "vs_reference": {"spots": {
                "port": n, "reference": ref["spots"],
                "frames": [runs[0]["frames_embedded"],
                           ref["frames_embedded"]],
                "pass": (n == ref["spots"] and runs[0]["frames_embedded"]
                         == ref["frames_embedded"])}},
            "exact": {"every_frame_decoded": n == runs[0]["frames_embedded"],
                      "same_count_on_every_rank": all(
                          r["spots"] == n for r in runs),
                      "every_message_sent": len(messages) == n and all(
                          m[2] == EXPECTED for m in messages),
                      **_kernels_exact(runs)}}


def multichip_record(ranks: list[dict], head: dict) -> dict:
    tail = common.load_record(MULTICHIP_REFERENCE)["tail"]
    m = re.search(r"windows=(\d+) spots=(\d+) msgs=\[(.*)\]", tail)
    ref_msgs = sorted(re.findall(r"'([^']*)'", m.group(3)))
    runs = [r["multichip"] for r in ranks]
    first = runs[0]
    msgs = sorted({s[2] for s in first["spots"]})
    return {**head, "mesh": {"channel": MULTICHIP[0], "time": MULTICHIP[1]},
            "windows": first["windows"], "spots": first["spots"],
            "messages": msgs, "note": NOTE_SHARED,
            "step_seconds_by_rank": [r["step_seconds"] for r in runs],
            "launches_by_rank": [r["launches"] for r in runs],
            "plain_calls_by_rank": [r["plain"] for r in runs],
            "replay_by_rank": [r["replay"] for r in runs],
            "kernels": combined(runs),
            "vs_reference": {"decode": {
                "port": {"windows": first["windows"],
                         "spots": first["count"], "messages": msgs},
                "reference": {"windows": int(m.group(1)),
                              "spots": int(m.group(2)),
                              "messages": ref_msgs},
                "pass": (first["windows"] == int(m.group(1))
                         and first["count"] == int(m.group(2))
                         and msgs == ref_msgs)}},
            "exact": {"frame_across_every_boundary_decoded":
                          EXPECTED in msgs,
                      "same_spots_on_every_rank": all(
                          r["spots"] == first["spots"] for r in runs),
                      **_kernels_exact(runs)}}


def run(device: torch.device, rank_cmd: list[str] | None = None) -> dict:
    """The controls in this process (on the card), then the WORLD-rank
    world (``rank_cmd``: the launcher's arguments of a rank; default this
    module), then the records by name."""
    head = common.record_head("scaling", REFERENCE, device)
    ctl = None
    if device.type == "cuda":
        from uwspr_tpu_torch.fec.host import load_native_fano
        from uwspr_tpu_torch.utils import cuda_build
        cuda_build.load_library()   # once, before the ranks load it
        load_native_fano()
        ctl = controls(device)
        # the ranks are other processes: the blocks this one keeps unused
        # go back to the card before they share it
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cmd = rank_cmd or ["-m", "uwspr_tpu_torch.harness.scaling",
                           "--device", device.type, "--rank-of"]
        ranks = run_world(pathlib.Path(tmp), [*cmd, tmp])
    records = {"scaling": scaling_record(ranks, ctl, head)}
    if ctl:
        records["dryrun_pod"] = pod_record(
            ranks, {**head, "reference": POD_REFERENCE})
        records["multichip"] = multichip_record(
            ranks, {**head, "reference": MULTICHIP_REFERENCE})
    return records


def main(argv=None) -> int:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--rank-of", default=None, metavar="DIR",
                   help="internal: run as one rank of the world (under "
                        "python -m torch.distributed.run); rank 0 writes "
                        "DIR/ranks.json")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.rank_of is not None:
        return rank_main(args.rank_of, device.type)
    rc = 0
    for name, record in run(device).items():
        rc = max(rc, common.finish(record, args.out, name))
    return rc


if __name__ == "__main__":
    sys.exit(main())
