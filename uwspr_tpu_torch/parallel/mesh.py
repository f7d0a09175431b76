"""Multi-device decoding: channel x time sharding over a mesh of ranks.

Counterpart of uwspr_tpu/parallel/mesh.py on torch.distributed. The
reference has no distributed capability; its implicit pipeline
parallelism is replaced by data parallelism over a 2-D mesh of ranks, one
device each:

- axis "channel": independent receive channels, embarrassingly parallel;
- axis "time": a continuous stream is split into hop-aligned blocks, one
  per rank. Every 120 s window overlaps the following samples by fl-hop
  (111 s), so each rank must see a *right halo* of fl-hop samples beyond
  its own block (the reference's ring-buffer window builder,
  lib/sliding_window_stream_to_pdu_impl.cc:113-135).

The halo (fl-hop = 41625 samples) is usually longer than a block, so it
is assembled by a *chained* exchange along the rank's time group:
ceil(halo/block) rounds of ``dist.batch_isend_irecv``, each passing the
block received last one rank to the left. Positions past the last time
shard come from the caller's ``tail`` (the next samples of the stream, or
zeros at the end). The time axis is therefore not circular: window w of
time shard t covers exactly global samples
[t*block + w*hop, t*block + w*hop + fl), the window of a single-device
sliding window over the concatenated stream.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
(n_channel, n_time) named ("channel", "time"), rank = channel * n_time +
time. ``init_device_mesh`` takes the worlds this port runs: gloo on the
CPU, gloo with four ranks sharing one card (each rank makes the card
current first, so DeviceMesh does not pick a device from LOCAL_RANK), and
NCCL with one rank per card; checked on an H100 with torch 2.11. Its
per-axis groups get the caller's timeout through ``backend_override``
(otherwise they would carry the backend's default, 30 minutes for gloo).

Backends: under NCCL the blocks move as device tensors. Gloo moves only
host memory (a device tensor handed to its send fails), so under gloo the
rank's block, the received blocks and the tail are host tensors, pinned
when the decode runs on a card, and the extended row goes to the device in
one copy after the exchange. The decode itself runs on the rank's device
either way.

The global spot count is an all_reduce over the mesh, returned as a
tensor: under NCCL it stays on the card, as the JAX decode's psum does,
and the rank's input block goes out from pinned memory without a wait, so
``ShardedDecoder.decode`` queues its work and returns. Each rank decodes
its (channel, window) block through ``DeviceDecoder.decode_windows_ri``,
the batched program the single-device runtimes run: on a card the
decoder's captured CUDA graph, replayed after the halo exchange; the
collectives stay outside it. ``ShardedStreamDecoder``
gathers every rank's packed (ch_l, n_win, C, 23) result over the mesh, so
every rank returns the same spots. Its "hybrid" engine runs the host Fano
(``DeviceDecoder.host_fano_assemble``) on each rank's own prefano block
before the gather, where the JAX package gathers the prefano first.

JAX's ``cpu_mesh`` builds virtual CPU devices inside one process; torch
has no such mesh. Its counterpart is the test helper of
tests/test_torch_mesh.py, which spawns a gloo world of CPU subprocesses
over a ``file://`` store.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from uwspr_tpu_torch.config import PipelineConfig
from uwspr_tpu_torch.device import to_device
from uwspr_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.messages import HashTable

AXES = ("channel", "time")


def make_mesh(n_channel: int, n_time: int, device_type: str, *,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """The (channel, time) DeviceMesh over the initialised world, whose
    size must be n_channel * n_time; each axis group fails a collective
    that waits longer than ``timeout``. On "cuda" each rank's card must
    already be current (``distributed.rank_device``)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world != n_channel * n_time:
        raise ValueError(f"mesh {n_channel}x{n_time} needs "
                         f"{n_channel * n_time} ranks, the world has {world}")
    backend = dist.get_backend()
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
    else:
        opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    return init_device_mesh(device_type, (n_channel, n_time),
                            mesh_dim_names=AXES,
                            backend_override={a: (backend, opts)
                                              for a in AXES})


def _mesh_device(mesh) -> torch.device:
    """The device this rank decodes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _host_comm(mesh) -> bool:
    """True when collectives take host tensors (gloo)."""
    return dist.get_backend(mesh.get_group("time")) == "gloo"


def assemble_halo(x_ri: torch.Tensor, received: list[torch.Tensor],
                  tail_ri: torch.Tensor, *, t: int, n_time: int,
                  block_len: int, halo: int) -> torch.Tensor:
    """The pure half of ``extend_with_halo``: time shard t's own block
    (ch_l, 2, block_len), ``received[m-1]`` the block of shard
    (t+m) mod n_time for m = 1..k (k = ceil(halo/block_len); unused when
    n_time == 1) and the tail (ch_l, 2, halo) -> the extended row
    (ch_l, 2, block_len + halo). A position past the last shard
    (t + m >= n_time) comes from the tail at offset
    (t+m-n_time)*block_len (uwspr_tpu/parallel/mesh.py:63-91)."""
    if n_time == 1:
        return torch.cat([x_ri, tail_ri], dim=2)
    k = -(-halo // block_len)
    tail_pad = torch.nn.functional.pad(tail_ri, (0, k * block_len - halo))
    pieces = [x_ri]
    for m in range(1, k + 1):
        if t + m < n_time:
            pieces.append(received[m - 1])
        else:
            off = (t + m - n_time) * block_len
            pieces.append(tail_pad[:, :, off:off + block_len])
    return torch.cat(pieces, dim=2)[:, :, :block_len + halo]


def extend_with_halo(x_ri: torch.Tensor, tail_ri: torch.Tensor, *, mesh,
                     block_len: int, halo: int) -> torch.Tensor:
    """This rank's (ch_l, 2, block_len) block -> (ch_l, 2, block_len +
    halo), collectively over the rank's time group: k = ceil(halo /
    block_len) chained rounds, each sending the block received last to the
    left neighbour and receiving the right neighbour's, so that after m
    rounds the rank holds shard (t+m) mod n_time's block; then
    ``assemble_halo``. The tensors are where the backend moves them: host
    tensors under gloo, device tensors under NCCL."""
    n_time = mesh.shape[1]
    t = mesh.get_coordinate()[1]
    received = []
    if n_time > 1:
        group = mesh.get_group("time")
        row = mesh.mesh[mesh.get_coordinate()[0]].tolist()
        left, right = row[(t - 1) % n_time], row[(t + 1) % n_time]
        send = x_ri.contiguous()
        pin = send.device.type == "cpu" and send.is_pinned()
        for _ in range(-(-halo // block_len)):
            buf = torch.empty(send.shape, dtype=send.dtype,
                              device=send.device, pin_memory=pin)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, send, left, group=group),
                    dist.P2POp(dist.irecv, buf, right, group=group)]):
                req.wait()
            received.append(buf)
            send = buf
    return assemble_halo(x_ri, received, tail_ri, t=t, n_time=n_time,
                         block_len=block_len, halo=halo)


def _to_ri(a: np.ndarray) -> np.ndarray:
    """(rows, n) complex -> (rows, 2, n) float32 real/imag planes."""
    return np.stack([a.real, a.imag], axis=1).astype(np.float32)


class ShardedDecoder:
    """Decode (channels, time_samples) arrays sharded over a mesh.

    time_samples per time shard must be a multiple of the window hop; each
    rank decodes block_len // hop windows of its channel rows. Window w of
    time shard t starts at global sample t*block_len + w*hop.

    fano_mode "device": each rank decodes to the packed (.., C, 23)
    output. "host" (the hybrid engine): each rank stops after the sync/rms
    gates and returns its packed prefano, which
    ``decoder.host_fano_assemble`` decodes on the host. ``state`` carries
    the decoder's constants (uwspr_tpu_torch.params), as DeviceDecoder's
    does. The config is used as given, as the JAX ShardedDecoder does."""

    def __init__(self, config: PipelineConfig | None, mesh,
                 fano_mode: str = "device", *,
                 state: dict[str, np.ndarray] | None = None):
        self.config = config or PipelineConfig()
        self.mesh = mesh
        self.fano_mode = fano_mode
        self.device = _mesh_device(mesh)
        self.decoder = DeviceDecoder(self.config, device=self.device,
                                     state=state, fano_mode=fano_mode)
        self._host = _host_comm(mesh)

    @property
    def fl(self) -> int:
        return self.config.stream.fl

    @property
    def hop(self) -> int:
        return self.config.stream.shift * self.config.stream.fs

    @property
    def halo(self) -> int:
        return self.fl - self.hop

    def _comm_tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array as the exchange moves it: a host tensor under
        gloo (pinned when the decode is on a card), else on the device,
        sent from pinned memory without a host wait (``to_device``)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not self._host:
            return to_device(t, self.device)
        return t.pin_memory() if self.device.type == "cuda" else t

    def rank_block(self, x: np.ndarray, tail: np.ndarray | None = None,
                   local: bool = False):
        """This rank's (ch_l, 2, block_len) block and (ch_l, 2, halo) tail
        of a decode's input, as the exchange takes them (see ``decode``)."""
        n_ch, n_t = self.mesh.shape
        c, t = self.mesh.get_coordinate()
        x = np.asarray(x)
        channels, total = x.shape
        if not local:
            if channels % n_ch:
                raise ValueError(f"{channels} channels do not split over "
                                 f"{n_ch} channel shards")
            channels //= n_ch
        if total % n_t:
            raise ValueError(f"{total} samples do not split over {n_t} time "
                             f"shards")
        block_len = total // n_t
        if block_len % self.hop:
            raise ValueError("the per-shard block length must be a multiple "
                             "of the hop")
        rows = slice(0, channels) if local else slice(c * channels,
                                                      (c + 1) * channels)
        if tail is None:
            tail = np.zeros((x.shape[0], self.halo), dtype=np.complex64)
        tail = np.asarray(tail)
        if tail.shape != (x.shape[0], self.halo):
            raise ValueError(f"tail must be {(x.shape[0], self.halo)}, got "
                             f"{tail.shape}")
        blk = x[rows, t * block_len:(t + 1) * block_len]
        return (self._comm_tensor(_to_ri(blk)),
                self._comm_tensor(_to_ri(tail[rows])))

    def windows(self, x_ri: torch.Tensor, tail_ri: torch.Tensor
                ) -> torch.Tensor:
        """The rank's block and tail -> its (ch_l * n_win, 2, fl) windows on
        its device, channel-major: the halo exchange, then block_len // hop
        windows of fl samples a hop apart in the extended row."""
        block_len = x_ri.shape[2]
        ext = extend_with_halo(x_ri, tail_ri, mesh=self.mesh,
                               block_len=block_len, halo=self.halo)
        ext = ext.to(self.device, non_blocking=True)
        wins = ext.unfold(2, self.fl, self.hop)      # (ch_l, 2, n_win, fl)
        return wins.transpose(1, 2).reshape(-1, 2, self.fl)

    def decode(self, x: np.ndarray, tail: np.ndarray | None = None,
               local: bool = False):
        """x: (channels, time_samples) complex, the full array on every rank
        (local=False) or only this rank's channel rows (local=True,
        ``distributed.process_local_channels``); tail: the (rows of x,
        fl-hop) samples that follow x in the stream (None: zeros, the end
        of the stream).

        Returns (this rank's packed output (ch_l, n_win, C, K) on its
        device, the global count as a (1,) int64 tensor: on the device
        under NCCL, as the JAX decode returns its psum, on the host under
        gloo, whose exchange is the host's). Nothing is read on the host
        under NCCL; a caller that wants an int converts where it reads the
        count. Collective: every rank of the mesh must call it. fano_mode
        "device": K = 23 and the count is the decoded candidates; "host":
        the packed prefano and the count of worth lanes (pending host
        decodes, uwspr_tpu/parallel/mesh.py:155-159)."""
        x_ri, tail_ri = self.rank_block(x, tail, local)
        ch_l, n_win = x_ri.shape[0], x_ri.shape[2] // self.hop
        packed = self.decoder.decode_windows_ri(self.windows(x_ri, tail_ri))
        packed = packed.reshape((ch_l, n_win) + packed.shape[1:])
        hit = packed[..., 0] > 0.5
        if self.fano_mode == "host":
            hit = hit & (packed[..., 1] > 0.5)
        n = hit.sum().to(torch.int64).reshape(1)
        if self._host:
            n = n.cpu()
        dist.all_reduce(n)
        return packed, n


@dataclasses.dataclass
class ShardedStreamStats:
    steps: int = 0
    windows: int = 0
    spots: int = 0


class ShardedStreamDecoder:
    """Continuous multichannel decoding over a (channel, time) mesh.

    The mesh analogue of pipeline.stream.StreamDecoder: every rank pushes
    the same samples, buffered per channel on the host; whenever a full
    step (n_time * wins_per_shard hops) plus its fl-hop lookahead tail is
    buffered, one sharded decode step runs. Consecutive steps are
    continuous (the tail of step s is the head of step s+1), so window w
    starts at global sample w*hop, as in a single-device sliding window.

    engine "device" | "hybrid", as the single-device StreamDecoder's: the
    hybrid engine runs each rank's Fano (and OSD fallback,
    DemodConfig.osd_depth) on its host. Each rank's packed result is
    gathered over the mesh, and every rank returns the same spots."""

    def __init__(self, config: PipelineConfig | None, mesh,
                 n_channels: int | None = None, wins_per_shard: int = 1,
                 hashtable: HashTable | None = None,
                 engine: str = "device"):
        if engine not in ("device", "hybrid"):
            raise ValueError(f"engine {engine!r} not in ('device', 'hybrid')")
        self.engine = engine
        self.dec = ShardedDecoder(
            config, mesh, fano_mode="host" if engine == "hybrid" else "device")
        self.mesh = mesh
        self.config = self.dec.config
        self.n_time = mesh.shape[1]
        self.n_channels = (n_channels if n_channels is not None
                           else mesh.shape[0])
        if self.n_channels % mesh.shape[0]:
            raise ValueError(f"{self.n_channels} channels do not split over "
                             f"{mesh.shape[0]} channel shards")
        self.wins_per_shard = wins_per_shard
        self.step_len = self.n_time * wins_per_shard * self.dec.hop
        self.hashtable = hashtable if hashtable is not None else HashTable()
        self._buf = np.zeros((self.n_channels, 0), dtype=np.complex64)
        self.windows_emitted = 0          # global window index of next emit
        self.stats = ShardedStreamStats()

    @property
    def hop(self) -> int:
        return self.dec.hop

    @property
    def halo(self) -> int:
        return self.dec.halo

    def gather(self, local: torch.Tensor) -> np.ndarray:
        """Every rank's packed (ch_l, n_win, C, 23) block -> the global
        (channels, n_time * n_win, C, 23) array on the host, on every
        rank."""
        n_ch, n_t = self.mesh.shape
        if self.dec._host:
            local = local.cpu()
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(n_ch * n_t)]
        dist.all_gather(parts, local)
        rows = [torch.cat(parts[c * n_t:(c + 1) * n_t], dim=1)
                for c in range(n_ch)]
        return torch.cat(rows, dim=0).cpu().numpy()

    def step(self, x: np.ndarray, tail: np.ndarray, n_windows: int):
        """One mesh step on (n_channels, step_len) samples and their tail:
        the sharded decode, the hybrid engine's host Fano on the rank's own
        block, the gather, then the spots of the first n_windows windows
        as [(channel, global_window_index, Spot), ...]."""
        packed, _ = self.dec.decode(x, tail)
        dec = self.dec.decoder
        if self.engine == "hybrid":
            lead = packed.shape[:2]
            asm = dec.host_fano_assemble(packed.reshape((-1,)
                                                        + packed.shape[2:]))
            packed = DeviceDecoder._pack({
                f.name: torch.as_tensor(getattr(asm, f.name))
                for f in dataclasses.fields(asm)
                if getattr(asm, f.name) is not None})
            packed = packed.reshape(lead + packed.shape[1:])
        out = dec.unpack_output(self.gather(packed)[:, :n_windows])
        results = []
        for ch in range(self.n_channels):
            for w in range(n_windows):
                one = out.window(ch).window(w)
                if one.success.any():
                    results.extend((ch, self.windows_emitted + w, spot)
                                   for spot in dec.spots(one,
                                                         self.hashtable))
        self.stats.steps += 1
        self.stats.windows += n_windows * self.n_channels
        self.stats.spots += int(out.success.sum())
        self.windows_emitted += n_windows
        return results

    def push(self, samples: np.ndarray):
        """samples: (n,) or (channels, n), the same on every rank. Returns
        [(channel, global_window_index, Spot), ...] for every step that
        completed."""
        samples = np.atleast_2d(np.asarray(samples, dtype=np.complex64))
        if samples.shape[0] != self.n_channels:
            raise ValueError(f"{samples.shape[0]} channels pushed, the "
                             f"decoder has {self.n_channels}")
        self._buf = np.concatenate([self._buf, samples], axis=1)
        results = []
        while self._buf.shape[1] >= self.step_len + self.halo:
            x = self._buf[:, :self.step_len]
            tail = self._buf[:, self.step_len:self.step_len + self.halo]
            results.extend(self.step(x, tail, self.step_len // self.hop))
            self._buf = self._buf[:, self.step_len:]
        return results

    def flush(self):
        """End of stream: decode the windows still completable from the
        buffered samples (start + fl <= buffered length), zero-padding the
        step to its fixed shape; windows that reach into the padding are
        not emitted, and spots are counted on the kept windows only."""
        true_len = self._buf.shape[1]
        n_true = max(0, (true_len - self.config.stream.fl) // self.hop + 1)
        if n_true == 0:
            return []
        padded = np.zeros((self.n_channels, self.step_len + self.halo),
                          dtype=np.complex64)
        padded[:, :true_len] = self._buf
        results = self.step(padded[:, :self.step_len],
                            padded[:, self.step_len:], n_true)
        self._buf = self._buf[:, n_true * self.hop:]
        return results

    # -- checkpoint/resume (uwspr_tpu/parallel/mesh.py:366-387) -----------

    def save_checkpoint(self, directory: str | os.PathLike) -> None:
        """Rank 0 writes the buffer, hash table and counters (every rank
        holds the same); collective: returns on every rank once written."""
        if dist.get_rank() == 0:
            os.makedirs(directory, exist_ok=True)
            np.savez(os.path.join(directory, "mesh_buffer.npz"),
                     buf=self._buf)
            self.hashtable.save(os.path.join(directory, "hashtable.txt"))
            state = dict(dataclasses.asdict(self.stats),
                         windows_emitted=self.windows_emitted)
            with open(os.path.join(directory, "stream_state.json"), "w") as f:
                json.dump(state, f)
        dist.barrier()

    def load_checkpoint(self, directory: str | os.PathLike) -> None:
        """Every rank reads the checkpoint rank 0 wrote."""
        with np.load(os.path.join(directory, "mesh_buffer.npz")) as data:
            self._buf = data["buf"].astype(np.complex64)
        ht = os.path.join(directory, "hashtable.txt")
        if os.path.exists(ht):
            self.hashtable = HashTable.load(ht)
        sp = os.path.join(directory, "stream_state.json")
        if os.path.exists(sp):
            with open(sp) as f:
                state = json.load(f)
            self.windows_emitted = state.pop("windows_emitted", 0)
            self.stats = ShardedStreamStats(**state)


__all__ = ["AXES", "ShardedDecoder", "ShardedStreamDecoder",
           "ShardedStreamStats", "assemble_halo", "extend_with_halo",
           "make_mesh"]
