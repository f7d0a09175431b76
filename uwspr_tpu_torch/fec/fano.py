"""Batched Fano sequential decoder: CUDA kernel + plain lockstep version.

Replaces uwspr_tpu/fec/fano_pallas.py::fano_decode_batch_pallas and keeps
its result contract (fano_pallas.py:297-305): a dict of per-lane

    success (L,) bool, data (L, 10) uint8, metric (L,) int32,
    cycles (L,) int32 (loop count + 1), maxnp (L,) int32,

bit-exact with fec/fano_ref.py, fec/fano_jax.py and fec/native, including
the reference's cycle accounting, the finish-on-the-last-cycle-is-a-timeout
quirk (Fano.cc:250) and the outputs of inactive lanes, which start done
(success False, data zero, metric 0, cycles 1, maxnp 0).

``fano_decode_batch`` is the entry point. For CUDA tensors it launches
``csrc/fano.cu`` (one lane per one-warp block, each lane's trellis and
branch metrics in shared memory, each lane stopping on its own; the walk
is ``csrc/fano_lane.cuh``) and counts the launch in
``KERNEL_LAUNCHES``; bool or u8 ``active`` is read as it is and success is
written as bool, so the wrapper adds no conversion. For CPU tensors it
runs ``fano_decode_batch_plain``,
the lockstep tensor loop of fano_jax.py:94-243, and counts the call in
``PLAIN_CALLS``. The plain loop costs one Python step per primitive move,
so keep ``maxcycles`` small when it has to run lanes that time out.

``fano_decode_jiggles`` decodes every gated (candidate, jiggle) lane of a
batch in one call, for a caller that keeps only each candidate's first
decoded jiggle. On CUDA its kernel walks all the lanes at once (the gated
lanes first, in jiggle-major order: ``gated_first``) and stops a
lane of jiggle j >= 1 once a lower jiggle of its candidate has decoded
(``aborted``); every other lane, and the lowest jiggle that decodes, gets
the result ``fano_decode_batch`` gives it. On the CPU it is one
``fano_decode_batch_plain`` call over all the lanes, none stopped.
"""

from __future__ import annotations

import torch

from uwspr_tpu_torch.protocol.constants import N_CODED_BITS, POLY1, POLY2
from uwspr_tpu_torch.utils import cuda_build

# launches of the CUDA kernel onto a stream (a CUDA graph's capture only
# records one, and its replays are seen only in a trace of the card) /
# calls of the plain version, in this process
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

_MASK32 = 0xFFFFFFFF


def reset_counters() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


def _parity(v: torch.Tensor) -> torch.Tensor:
    """Bit parity of non-negative 32-bit values held in int64."""
    for s in (16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return v & 1


def _branch_symbol(state: torch.Tensor) -> torch.Tensor:
    """(poly1_parity << 1) | poly2_parity of 32-bit encoder states."""
    return (_parity(state & POLY1) << 1) | _parity(state & POLY2)


def branch_metrics(symbols: torch.Tensor, mettab: torch.Tensor,
                   nbits: int = N_CODED_BITS) -> torch.Tensor:
    """(L, 2*nbits) soft symbols -> (L, nbits, 4) int32 branch metrics
    metrics[l, k, j] with j = (poly1_bit << 1) | poly2_bit.

    A plain table gather; the JAX package's one-hot bf16 matmul
    (fano_jax.py:57-90) is a TPU device for the same numbers."""
    y0 = symbols[:, 0:2 * nbits:2].long()
    y1 = symbols[:, 1:2 * nbits:2].long()
    m = mettab.to(torch.int32)
    m0y0, m1y0 = m[0][y0], m[1][y0]
    m0y1, m1y1 = m[0][y1], m[1][y1]
    return torch.stack([m0y0 + m0y1, m0y0 + m1y1, m1y0 + m0y1, m1y0 + m1y1],
                       dim=-1)


def _check(symbols, mettab, active):
    if symbols.dim() != 2 or symbols.shape[1] != 2 * N_CODED_BITS:
        raise ValueError(f"symbols must be (L, {2 * N_CODED_BITS}), got "
                         f"{tuple(symbols.shape)}")
    if symbols.dtype.is_floating_point or symbols.dtype == torch.bool:
        raise ValueError(f"symbols must hold u8 values, got {symbols.dtype}")
    if tuple(mettab.shape) != (2, 256):
        raise ValueError(f"mettab must be (2, 256), got {tuple(mettab.shape)}")
    for name, x in (("mettab", mettab), ("active", active)):
        if x is not None and x.device != symbols.device:
            raise ValueError(f"{name} lies on {x.device}, symbols on "
                             f"{symbols.device}")
    if active is not None and tuple(active.shape) != (symbols.shape[0],):
        raise ValueError(f"active must be ({symbols.shape[0]},)")


def fano_decode_batch(symbols: torch.Tensor, mettab: torch.Tensor,
                      active: torch.Tensor | None = None, *,
                      delta: int = 60, maxcycles: int = 10000) -> dict:
    """Decode (L, 162) soft symbols (u8 values); see the module doc."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    _check(symbols, mettab, active)
    if symbols.device.type == "cpu":
        PLAIN_CALLS += 1
        return fano_decode_batch_plain(symbols, mettab, active, delta=delta,
                                       maxcycles=maxcycles)
    if symbols.device.type != "cuda":
        raise ValueError(f"fano_decode_batch: unsupported device "
                         f"{symbols.device}")
    budget = maxcycles * N_CODED_BITS
    if not 0 < budget < 2 ** 31 - 2:
        raise ValueError(f"maxcycles {maxcycles} out of range")
    dev = symbols.device
    L = symbols.shape[0]
    sym = symbols.to(torch.uint8).contiguous()
    if sym.data_ptr() % 2:                 # the kernel reads 2-byte pairs
        sym = sym.clone()
    act = active
    if act is not None and act.dtype not in (torch.bool, torch.uint8):
        act = act != 0
    act = None if act is None else act.contiguous()
    met = mettab.to(torch.int32).contiguous()
    success = torch.empty(L, dtype=torch.bool, device=dev)
    data = torch.empty((L, N_CODED_BITS >> 3), dtype=torch.uint8, device=dev)
    metric = torch.empty(L, dtype=torch.int32, device=dev)
    cycles = torch.empty(L, dtype=torch.int32, device=dev)
    maxnp = torch.empty(L, dtype=torch.int32, device=dev)
    lib = cuda_build.load_library()
    code = lib.uwspr_fano_decode(
        sym.data_ptr(), None if act is None else act.data_ptr(),
        met.data_ptr(), L, delta, budget, success.data_ptr(),
        data.data_ptr(), metric.data_ptr(), cycles.data_ptr(),
        maxnp.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("uwspr_fano_decode", code)
    if not torch.cuda.is_current_stream_capturing():
        KERNEL_LAUNCHES += 1    # a capture only records it
    return {"success": success, "data": data, "metric": metric,
            "cycles": cycles, "maxnp": maxnp}


def fano_decode_jiggles(symbols: torch.Tensor, gate: torch.Tensor,
                        mettab: torch.Tensor, *, delta: int = 60,
                        maxcycles: int = 10000) -> dict:
    """(N, J, 162) soft symbols (u8 values) of N candidates' J jiggles and
    their (N, J) gate -> the fields of ``fano_decode_batch`` by lane, each
    (N, J[, 10]), plus ``aborted`` (N, J) bool: the lane's walk stopped
    because a lower jiggle of its candidate decoded (success False; its
    other fields are those of a partial walk, cycles its looks + 1).
    Lanes outside the gate are inactive. See the module doc."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    if symbols.dim() != 3 or symbols.shape[2] != 2 * N_CODED_BITS:
        raise ValueError(f"symbols must be (N, J, {2 * N_CODED_BITS}), got "
                         f"{tuple(symbols.shape)}")
    N, J = symbols.shape[:2]
    if tuple(gate.shape) != (N, J):
        raise ValueError(f"gate must be ({N}, {J}), got {tuple(gate.shape)}")
    flat = symbols.reshape(N * J, 2 * N_CODED_BITS)
    _check(flat, mettab, gate.reshape(N * J))
    if symbols.device.type == "cpu":
        PLAIN_CALLS += 1
        out = fano_decode_batch_plain(flat, mettab, gate.reshape(N * J),
                                      delta=delta, maxcycles=maxcycles)
        out = {k: v.reshape((N, J) + v.shape[1:]) for k, v in out.items()}
        out["aborted"] = torch.zeros((N, J), dtype=torch.bool)
        return out
    if symbols.device.type != "cuda":
        raise ValueError(f"fano_decode_jiggles: unsupported device "
                         f"{symbols.device}")
    budget = maxcycles * N_CODED_BITS
    if not 0 < budget < 2 ** 31 - 256:
        raise ValueError(f"maxcycles {maxcycles} out of range")
    dev = symbols.device
    sym = symbols.to(torch.uint8).contiguous()
    if sym.data_ptr() % 2:                 # the kernel reads 2-byte pairs
        sym = sym.clone()
    act = gate if gate.dtype in (torch.bool, torch.uint8) else gate != 0
    act = act.contiguous()
    met = mettab.to(torch.int32).contiguous()

    def empty(dtype, *tail):
        return torch.empty((N, J) + tail, dtype=dtype, device=dev)
    out = {"success": empty(torch.bool),
           "data": empty(torch.uint8, N_CODED_BITS >> 3),
           "metric": empty(torch.int32), "cycles": empty(torch.int32),
           "maxnp": empty(torch.int32), "aborted": empty(torch.bool)}
    first_ok = torch.empty(N, dtype=torch.int32, device=dev)
    order = gated_first(act)
    lib = cuda_build.load_library()
    code = lib.uwspr_fano_decode_jiggles(
        sym.data_ptr(), act.data_ptr(), order.data_ptr(), met.data_ptr(),
        N, J, delta, budget, first_ok.data_ptr(),
        *(out[k].data_ptr() for k in ("success", "data", "metric", "cycles",
                                      "maxnp", "aborted")),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("uwspr_fano_decode_jiggles", code)
    if not torch.cuda.is_current_stream_capturing():
        KERNEL_LAUNCHES += 1    # a capture only records it
    return out


def gated_first(gate: torch.Tensor) -> torch.Tensor:
    """The (J*N,) int32 lanes b = j*N + n of an (N, J) gate in jiggle-major
    order, the gated ones first: on the device, with no host read."""
    g = gate.t().reshape(-1).to(torch.int32)
    b = torch.arange(g.shape[0], dtype=torch.int32, device=g.device)
    c = torch.cumsum(g, 0, dtype=torch.int32)
    pos = torch.where(g != 0, c - 1, c[-1:] + b - c)
    return torch.empty_like(b).scatter_(0, pos.to(torch.int64), b)


def fano_decode_batch_plain(symbols: torch.Tensor, mettab: torch.Tensor,
                            active: torch.Tensor | None = None, *,
                            delta: int = 60, maxcycles: int = 10000) -> dict:
    """Lockstep Fano over all lanes, one primitive step per iteration: a
    forward look (threshold test, move, tighten) or one backward-scan step
    (fano_jax.py:94-243). Node state is updated in place, only at the lanes
    a step moves, which equals the JAX version's masked functional
    updates."""
    nbits = N_CODED_BITS
    dev = symbols.device
    L = symbols.shape[0]
    tail = nbits - 31
    budget = maxcycles * nbits
    metrics = branch_metrics(symbols, mettab, nbits)        # (L, nbits, 4)
    lanes = torch.arange(L, device=dev)

    gamma = torch.zeros((L, nbits + 1), dtype=torch.int32, device=dev)
    enc = torch.zeros((L, nbits + 1), dtype=torch.int64, device=dev)
    tm0 = torch.zeros((L, nbits + 1), dtype=torch.int32, device=dev)
    tm1 = torch.zeros((L, nbits + 1), dtype=torch.int32, device=dev)
    branch = torch.zeros((L, nbits + 1), dtype=torch.int32, device=dev)

    def expand(idx, kk):
        """Sorted branch metrics at node kk of lanes idx; enc gains its low
        bit where the 1-branch is the better one (fano_jax.py:115-130)."""
        ek = enc[idx, kk]
        lsym = _branch_symbol(ek)
        mk = metrics[idx, torch.clamp(kk, max=nbits - 1)]   # (n, 4)
        a = mk.gather(1, lsym[:, None])[:, 0]
        b = mk.gather(1, (3 ^ lsym)[:, None])[:, 0]
        is_tail = kk >= tail
        swap = ~is_tail & (a <= b)
        tm0[idx, kk] = torch.where(swap, b, a)
        tm1[idx, kk] = torch.where(is_tail, tm1[idx, kk],
                                   torch.where(swap, a, b))
        enc[idx, kk] = torch.where(swap, ek + 1, ek)
        branch[idx, kk] = 0

    k = torch.zeros(L, dtype=torch.int64, device=dev)
    t = torch.zeros(L, dtype=torch.int32, device=dev)
    expand(lanes, k)
    phase = torch.zeros(L, dtype=torch.int32, device=dev)   # 0 fwd, 1 back
    cycles = torch.zeros(L, dtype=torch.int32, device=dev)
    maxnp = torch.zeros(L, dtype=torch.int64, device=dev)
    success = torch.zeros(L, dtype=torch.bool, device=dev)
    done = (torch.zeros(L, dtype=torch.bool, device=dev) if active is None
            else ~active.bool())

    while not bool(done.all()):
        fwd = ~done & (phase == 0)
        bwd = ~done & (phase == 1)

        # ---- forward look (one reference "cycle") ----
        timeout = fwd & (cycles >= budget)
        fwd = fwd & ~timeout
        maxnp = torch.where(fwd, torch.maximum(maxnp, k), maxnp)
        gk = gamma[lanes, k]
        tmk = torch.where(branch[lanes, k] != 0, tm1[lanes, k], tm0[lanes, k])
        ngamma = gk + tmk
        ok = ngamma >= t
        move = fwd & ok
        violate = fwd & ~ok
        tighten = move & (gk < t + delta) & (ngamma >= t + delta)
        t = torch.where(tighten, t + delta * torch.div(
            ngamma - t, delta, rounding_mode="floor"), t)
        mi = lanes[move]
        if mi.numel():
            km = k[mi]
            gamma[mi, km + 1] = ngamma[mi]
            enc[mi, km + 1] = (enc[mi, km] << 1) & _MASK32
        k = torch.where(move, k + 1, k)
        complete = move & (k == nbits)
        ei = lanes[move & ~complete]
        if ei.numel():
            expand(ei, k[ei])
        cycles = torch.where(fwd, cycles + 1, cycles)
        success = success | (complete & (cycles < budget))
        # a reference timeout leaves its loop counter at budget+1
        cycles = torch.where(timeout, budget + 1, cycles)
        done = done | complete | timeout
        phase = torch.where(violate, 1, phase)

        # ---- backward scan: exactly one step ----
        relax = bwd & ((k == 0)
                       | (gamma[lanes, torch.clamp(k - 1, min=0)] < t))
        step_back = bwd & ~relax
        t = torch.where(relax, t - delta, t)
        ri = lanes[relax & (branch[lanes, k] != 0)]
        if ri.numel():
            kr = k[ri]
            enc[ri, kr] = enc[ri, kr] ^ 1
            branch[ri, kr] = 0
        phase = torch.where(relax, 0, phase)
        k = torch.where(step_back, k - 1, k)
        switch = step_back & (k < tail) & (branch[lanes, k] != 1)
        si = lanes[switch]
        if si.numel():
            ks = k[si]
            enc[si, ks] = enc[si, ks] ^ 1
            branch[si, ks] = branch[si, ks] + 1
        phase = torch.where(switch, 0, phase)

    nbytes = nbits >> 3
    harvest = enc[:, 7::8][:, :nbytes] & 0xFF
    return {
        "success": success,
        "data": harvest.to(torch.uint8),
        "metric": gamma[lanes, k],
        "cycles": cycles + 1,
        "maxnp": maxnp.to(torch.int32),
    }


__all__ = ["KERNEL_LAUNCHES", "PLAIN_CALLS",
           "branch_metrics", "fano_decode_batch", "fano_decode_batch_plain",
           "fano_decode_jiggles", "reset_counters"]
