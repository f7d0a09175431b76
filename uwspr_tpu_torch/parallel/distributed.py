"""Multi-process setup: the torch.distributed process group and the global
(channel, time) mesh.

Counterpart of uwspr_tpu/parallel/distributed.py. One rank is one process
and one device; every rank runs the same program and feeds the mesh the
same stream (or its own channel rows, ``process_local_channels``). Launch
one process per rank, for example on one host with four cards:

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m uwspr_tpu_torch.cli serve --mesh 2x2 --dist-backend nccl

or from code:

    from uwspr_tpu_torch.parallel.distributed import initialize, global_mesh
    initialize("nccl")          # RANK, WORLD_SIZE, MASTER_ADDR/PORT
    mesh = global_mesh(n_channel, n_time, "cuda")
    dec = ShardedDecoder(config, mesh)

The caller names the backend; nothing chooses one or gives way from one to
the other. "nccl" moves device tensors and needs a card per rank (NCCL
refuses two ranks of one communicator on one card, and ``global_mesh``
says so before NCCL is reached); "gloo" moves host tensors and serves the
CPU and several ranks that share one card (the decode stays on the card,
the halo blocks go through pinned host memory, see parallel/mesh.py).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from uwspr_tpu_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


class SharedDeviceError(RuntimeError):
    """NCCL asked to put two ranks of one communicator on one card."""


def initialize(backend: str, *, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Initialise the default process group on ``backend`` ("nccl" or
    "gloo"): from the launcher's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) when ``init_method`` is None, else from
    ``init_method`` ("tcp://host:port" or "file:///path"), ``world_size``
    and ``rank``. A collective that waits longer than ``timeout`` fails.

    Returns True when this call created the group. A call when the group
    already exists on the same backend does nothing and returns False, as
    a second jax.distributed.initialize does; on another backend it raises
    ValueError."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise ValueError(f"the process group is already initialised on "
                             f"{have}, not {backend}")
        return False
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=timeout)
    return True


def _local_rank() -> tuple[int, int]:
    """(local rank, ranks on this host): the launcher's LOCAL_RANK and
    LOCAL_WORLD_SIZE, else the global rank and world size (a world started
    with explicit arguments lives on one host)."""
    env = os.environ
    if "LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env:
        return int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    return dist.get_rank(), dist.get_world_size()


def rank_device(device_type: str) -> torch.device:
    """The device of this rank, made torch's current CUDA device: under
    NCCL card LOCAL_RANK (SharedDeviceError when the host's ranks outnumber
    its cards), under gloo card LOCAL_RANK modulo the cards (ranks may
    share one); the CPU for ``device_type`` "cpu"."""
    if resolve_device(device_type).type == "cpu":
        return torch.device("cpu")
    local, local_world = _local_rank()
    cards = torch.cuda.device_count()
    if dist.get_backend() == "nccl":
        if local_world > cards:
            raise SharedDeviceError(
                f"nccl: {local_world} ranks on this host and {cards} "
                f"card(s); NCCL refuses two ranks of one communicator on one "
                f"card. Use the gloo backend to share a card.")
        index = local
    else:
        index = local % cards
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def global_mesh(n_channel: int, n_time: int, device_type: str,
                timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """The (channel, time) mesh over every rank of the job, each rank on
    ``rank_device(device_type)``. Ranks of one channel row are adjacent on
    the time axis (rank = channel * n_time + time), so the halo exchange,
    which runs every step, stays between neighbouring ranks, on one host
    wherever n_time divides its ranks, and the channel axis (no traffic
    but the closing count and gather) spans hosts. ValueError when the
    world has another number of ranks than n_channel * n_time."""
    from uwspr_tpu_torch.parallel.mesh import make_mesh
    rank_device(device_type)
    return make_mesh(n_channel, n_time, device_type, timeout=timeout)


def process_local_channels(n_channels: int, mesh) -> tuple[int, int]:
    """(start, count) of the channel rows this rank feeds when a decode
    takes local rows (``ShardedDecoder.decode(..., local=True)``): its
    channel coordinate times the rows of one channel shard."""
    n_ch = mesh.shape[0]
    if n_channels % n_ch:
        raise ValueError(f"{n_channels} channels do not split over "
                         f"{n_ch} channel shards")
    per = n_channels // n_ch
    return mesh.get_coordinate()[0] * per, per


__all__ = ["BACKENDS", "DEFAULT_TIMEOUT", "SharedDeviceError", "global_mesh",
           "initialize", "process_local_channels", "rank_device"]
