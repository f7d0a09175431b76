"""Ordered-statistics decoding (order <= 4) on tensors, batched over lanes.

Counterpart of uwspr_tpu/fec/osd_jax.py::osd2_decode_jax, the device and
mesh engines' deep-SNR fallback, which the JAX package vmaps over the
rescue lanes and leaves to XLA.

``osd_decode_lanes`` is the entry point. For CUDA tensors it launches
``csrc/osd.cu`` (one lane per block, the lane's logic in
``csrc/osd_lane.cuh``: a counting rank, the information set and its
inverse by column operations on 64-bit row masks, and the flip search as
integer scores, a weighted popcount over the parity positions) and counts
the launch in ``KERNEL_LAUNCHES``. It reads nothing on the host: an
inactive lane starts done, so the caller passes a fixed number of lanes
with ``active`` the mask of those to decode. For CPU tensors it runs
``osd_decode_lanes_plain`` on the active lanes and counts the call in
``PLAIN_CALLS``.

The plain version steps every lane of a batch through the JAX function's
stages; its fori_loops (50 elimination rounds, 50 Gauss-Jordan rounds, the
50 order-4 chunks) are host loops over batched tensors:

- reliability sort: one stable argsort of -|soft - 128| per lane (the u8
  soft symbols tie often, so stability decides the information set);
- most-reliable information set (``_basis_select``): 50 rounds, each
  pivoting on the first still-unselected nonzero row and eliminating its
  leading column everywhere, which selects the greedy independent set;
- (50, 50) GF(2) inversion (``_gf2_inv``): 50 Gauss-Jordan rounds;
- scoring: order 1 and 2 as two small products, order 3 as one (K, K, K)
  inclusion-exclusion tensor, order 4 as 50 chunks of the +/-1-product
  form, one (K, K, K) tensor per leading flip index; every argmin is the
  first minimum of the flattened tensor (lexicographic), and the order-4
  chunks take a new best only when strictly smaller, so ties resolve as
  in the JAX function and the host walk.

GF(2) products are float32 products of 0/1 operands (exact: the inner
dimension is at most 162), reduced with ``remainder(., 2)``; torch has no
integer matmul on CUDA. With the decoders' u8 soft symbols every score is
an integer or a half-integer below 2**24, so the sums are exact in any
order and the winners, flip counts, quality and margin equal the JAX
function's, and the kernel's integer scores. Products run under
``exact_f32``.
"""

from __future__ import annotations

import torch

from uwspr_tpu_torch.device import exact_f32
from uwspr_tpu_torch.utils import cuda_build

N, K = 162, 50

# launches of the CUDA kernel onto a stream (a CUDA graph's capture only
# records one, and its replays are seen only in a trace of the card) /
# calls of the plain version, in this process
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counters() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


def _gf2_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a @ b, 2.0)


def _basis_select(Gp: torch.Tensor) -> torch.Tensor:
    """(L, N, K) bool reliability-ordered generators -> (L, K) indices of
    the first K linearly independent rows of each, ascending
    (osd_jax.py:49-67)."""
    L = Gp.shape[0]
    dev = Gp.device
    ar = torch.arange(L, device=dev)
    rows = torch.arange(N, device=dev)
    R = Gp.clone()
    selected = torch.zeros((L, N), dtype=torch.bool, device=dev)
    for _ in range(K):
        nonzero = R.any(dim=2) & ~selected
        i = torch.argmax(nonzero.to(torch.uint8), dim=1)   # first unselected
        row = R[ar, i]                                     # (L, K)
        c = torch.argmax(row.to(torch.uint8), dim=1)       # leading column
        elim = R[ar, :, c] & (rows[None, :] != i[:, None])  # (L, N)
        R = torch.where(elim[:, :, None], R ^ row[:, None, :], R)
        selected[ar, i] = True
    return torch.argsort((~selected).to(torch.int8), dim=1,
                         stable=True)[:, :K]


def _gf2_inv(A: torch.Tensor) -> torch.Tensor:
    """(L, K, K) invertible bool GF(2) matrices -> their inverses, bool
    (osd_jax.py:70-84)."""
    L = A.shape[0]
    dev = A.device
    ar = torch.arange(L, device=dev)
    rows = torch.arange(K, device=dev)
    eye = torch.eye(K, dtype=torch.bool, device=dev).expand(L, K, K)
    M = torch.cat([A, eye], dim=2)                          # (L, K, 2K)
    for col in range(K):
        piv = torch.argmax((M[:, :, col] & (rows >= col)).to(torch.uint8),
                           dim=1)
        rowc = M[:, col].clone()
        rowp = M[ar, piv]
        M[:, col] = rowp
        M[ar, piv] = torch.where((piv == col)[:, None], rowp, rowc)
        elim = M[:, :, col] & (rows != col)
        M = torch.where(elim[:, :, None], M ^ M[:, col][:, None, :], M)
    return M[:, :, K:]


def _two_smallest(x: torch.Tensor) -> torch.Tensor:
    """(L, n) -> (L, 2) the two smallest values of each row, ascending."""
    return torch.topk(x, 2, dim=1, largest=False).values


def _first_min(x: torch.Tensor):
    """(L, n) scores -> (index of the first minimum (L,), its value (L,),
    the two smallest values (L, 2)). Overwrites x at the minimum: a masked
    min pass instead of a top-k over the (K, K, K) tensors, which the card
    runs as a multi-pass select."""
    ar = torch.arange(x.shape[0], device=x.device)
    flat = torch.argmin(x, dim=1)
    v = x[ar, flat]
    x[ar, flat] = torch.inf
    return flat, v, torch.stack([v, x.min(dim=1).values], dim=1)


def _onehot_sum(L: int, dev, *idx: torch.Tensor) -> torch.Tensor:
    """(L, K) float32 flip vector with a one at each index of ``idx``."""
    v = torch.zeros((L, K), dtype=torch.float32, device=dev)
    ar = torch.arange(L, device=dev)
    for i in idx:
        v[ar, i] += 1.0
    return v


def _check(soft, G, order, active):
    if order not in (1, 2, 3, 4):
        raise ValueError(f"OSD order {order} not in 1..4")
    if soft.dim() != 2 or soft.shape[1] != N:
        raise ValueError(f"soft must be (L, {N}), got {tuple(soft.shape)}")
    if tuple(G.shape) != (N, K):
        raise ValueError(f"G must be ({N}, {K}), got {tuple(G.shape)}")
    for name, x in (("G", G), ("active", active)):
        if x is not None and x.device != soft.device:
            raise ValueError(f"{name} lies on {x.device}, soft on "
                             f"{soft.device}")
    if active is not None and tuple(active.shape) != (soft.shape[0],):
        raise ValueError(f"active must be ({soft.shape[0]},)")


def _check_kernel(soft, G, active):
    """What the kernel reads as it is: u8 soft, float32 G, bool or u8
    active, each contiguous."""
    if soft.dtype != torch.uint8:
        raise ValueError(f"the OSD kernel takes u8 soft symbols, got "
                         f"{soft.dtype}")
    if G.dtype != torch.float32:
        raise ValueError(f"the OSD kernel takes a float32 G, got {G.dtype}")
    if active is not None and active.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"active must be bool or u8, got {active.dtype}")
    for name, x in (("soft", soft), ("G", G), ("active", active)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def osd_decode_lanes(soft: torch.Tensor, G: torch.Tensor, order: int = 2,
                     active: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """(L, 162) soft symbols in the Fano convention (>= 128 means coded bit
    1, |x - 128| is the reliability), the (162, 50) 0/1 generator
    (fec.osd.generator_matrix, the decoder state's osd_G, float32 on the
    same device) and ``active`` (L,) bool, or None for every lane ->
    (info bits (L, 50) int32, quality (L,) float32, margin (L,) float32,
    flips (L,) int32): on an active lane the result of osd2_decode_jax
    (osd_jax.py:87-218) at ``order``, on an inactive one bits 0, quality 0,
    margin 0 and flips 0.

    On a CUDA tensor soft must be u8 and every input contiguous (the
    decoders pass their u8 symbols); the kernel launches without a host
    read, and anything else raises. On a CPU tensor soft may be u8 or
    float32 holding u8 values (tests/test_torch_osd.py and chip_smoke.py
    pass float32); the plain version decodes the active lanes only."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    _check(soft, G, order, active)
    if soft.device.type == "cpu":
        PLAIN_CALLS += 1
        return osd_decode_lanes_plain(soft, G, order, active)
    if soft.device.type != "cuda":
        raise ValueError(f"osd_decode_lanes: unsupported device "
                         f"{soft.device}")
    _check_kernel(soft, G, active)
    dev = soft.device
    L = soft.shape[0]
    bits = torch.empty((L, K), dtype=torch.int32, device=dev)
    quality = torch.empty(L, dtype=torch.float32, device=dev)
    margin = torch.empty(L, dtype=torch.float32, device=dev)
    flips = torch.empty(L, dtype=torch.int32, device=dev)
    lib = cuda_build.load_library()
    code = lib.uwspr_osd_decode(
        soft.data_ptr(), None if active is None else active.data_ptr(),
        G.data_ptr(), L, order, bits.data_ptr(), quality.data_ptr(),
        margin.data_ptr(), flips.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("uwspr_osd_decode", code)
    if not torch.cuda.is_current_stream_capturing():
        KERNEL_LAUNCHES += 1    # a capture only records it
    return bits, quality, margin, flips


def osd_decode_lanes_plain(soft: torch.Tensor, G: torch.Tensor,
                           order: int = 2,
                           active: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """The batched tensor version of ``osd_decode_lanes`` on any device.
    With ``active`` it decodes the active lanes alone (it reads the mask on
    the host) and gives the inactive ones the kernel's outputs."""
    _check(soft, G, order, active)
    with exact_f32():
        if active is None:
            return _decode(soft.float(), G.float(), order)
        L = soft.shape[0]
        dev = soft.device
        bits = torch.zeros((L, K), dtype=torch.int32, device=dev)
        quality = torch.zeros(L, dtype=torch.float32, device=dev)
        margin = torch.zeros(L, dtype=torch.float32, device=dev)
        flips = torch.zeros(L, dtype=torch.int32, device=dev)
        idx = torch.nonzero(active.bool()).flatten()
        if idx.numel():
            u, q, m, f = _decode(soft[idx].float(), G.float(), order)
            bits[idx], quality[idx], margin[idx], flips[idx] = u, q, m, f
        return bits, quality, margin, flips


def _decode(soft, G, order):
    L = soft.shape[0]
    dev = soft.device
    ar = torch.arange(L, device=dev)
    y = soft - 128.0
    h = y >= 0
    r = torch.abs(y)
    idx = torch.argsort(-r, dim=1, stable=True)
    Gb = G > 0.5
    sel = torch.gather(idx, 1, _basis_select(Gb[idx]))     # information set
    Ainv = _gf2_inv(Gb[sel]).float()                        # (L, K, K)
    hs = torch.gather(h, 1, sel).float()
    u0 = _gf2_matmul(Ainv, hs[:, :, None])[:, :, 0]         # (L, K)
    Df = _gf2_matmul(G, Ainv)            # (L, N, K) delta per basis flip
    c0 = _gf2_matmul(u0, G.T)                               # (L, N)
    m0 = (c0 != h.float()).float()
    s = r * (1.0 - 2.0 * m0)
    score0 = torch.sum(r * m0, dim=1)

    w = (s[:, None, :] @ Df)[:, 0]                          # (L, K)
    p1 = torch.argmin(w, dim=1)
    v1 = score0 + w[ar, p1]
    take1 = v1 < score0
    s_best = torch.where(take1, v1, score0)
    flips = torch.where(take1[:, None], _onehot_sum(L, dev, p1),
                        torch.zeros((L, K), device=dev))
    n_flips = take1.to(torch.int32)
    # per-stage two smallest candidate scores, for the list-decoding margin
    top2 = [score0[:, None], _two_smallest(score0[:, None] + w)]

    def take(v, vec, n):
        nonlocal s_best, flips, n_flips
        t = v < s_best
        s_best = torch.where(t, v, s_best)
        flips = torch.where(t[:, None], vec, flips)
        n_flips = torch.where(t, n, n_flips)

    kk = torch.arange(K, device=dev)
    if order >= 2:
        M2 = (Df * s[:, :, None]).transpose(1, 2) @ Df      # (L, K, K)
        pair = score0[:, None, None] + w[:, :, None] + w[:, None, :] \
            - 2.0 * M2
        pair = torch.where(kk[:, None] < kk[None, :], pair, torch.inf)
        flat, v, two = _first_min(pair.reshape(L, K * K))
        top2.append(two)
        take(v, _onehot_sum(L, dev, flat // K, flat % K), 2)

    strict3 = ((kk[:, None, None] < kk[None, :, None])
               & (kk[None, :, None] < kk[None, None, :]))
    if order >= 3:
        # XOR of three columns by inclusion-exclusion (d are 0/1)
        T = torch.einsum("li,lip,liq,lir->lpqr", s, Df, Df, Df)
        trip = (score0[:, None, None, None] + w[:, :, None, None]
                + w[:, None, :, None] + w[:, None, None, :]
                - 2.0 * (M2[:, :, :, None] + M2[:, :, None, :]
                         + M2[:, None, :, :])
                + 4.0 * T)
        flat, v, two = _first_min(      # first min = lexicographic
            torch.where(strict3, trip, torch.inf).reshape(L, K ** 3))
        top2.append(two)
        take(v, _onehot_sum(L, dev, flat // (K * K), (flat // K) % K,
                            flat % K), 3)

    if order >= 4:
        # all C(50,4) quadruples, one (K,K,K) chunk per leading flip p,
        # p ascending with strict-< (the host's lexicographic tie-break):
        # with E = 1-2D, q4 = sum_i s_i E_ip E_iq E_ir E_it and score =
        # score0 + (sum(s) - q4) / 2
        E = 1.0 - 2.0 * Df                                  # (L, N, K)
        T_s = s.sum(dim=1)
        EE = (E[:, :, :, None] * E[:, :, None, :]).reshape(L, N, K * K)
        best4 = torch.full((L,), torch.inf, device=dev)
        arg4 = torch.zeros((L, 4), dtype=torch.int64, device=dev)
        two = torch.full((L, 2), torch.inf, device=dev)
        for p in range(K):
            a = s * E[:, :, p]
            q4 = ((a[:, :, None] * E).transpose(1, 2) @ EE)  # (L, q, r*t)
            sc = score0[:, None] + (T_s[:, None] - q4.reshape(L, K ** 3)) \
                / 2.0
            ok = strict3 & (kk[:, None, None] > p)
            flat, v, two_p = _first_min(
                torch.where(ok.reshape(K ** 3), sc, torch.inf))
            two = _two_smallest(torch.cat([two, two_p], dim=1))
            t = v < best4
            best4 = torch.where(t, v, best4)
            cand = torch.stack([torch.full_like(flat, p), flat // (K * K),
                                (flat // K) % K, flat % K], dim=1)
            arg4 = torch.where(t[:, None], cand, arg4)
        top2.append(two)
        take(best4, _onehot_sum(L, dev, *arg4.unbind(1)), 4)

    u = torch.remainder(u0 + (Ainv @ flips[:, :, None])[:, :, 0], 2.0)
    total = torch.clamp(r.sum(dim=1), min=1e-9)
    quality = (total - 2.0 * s_best) / total
    two = _two_smallest(torch.cat(top2, dim=1))
    margin = (two[:, 1] - two[:, 0]) / total
    return u.to(torch.int32), quality, margin, n_flips


def bits_to_payload(u: torch.Tensor) -> torch.Tensor:
    """(..., 50) info bits -> (..., 7) uint8, MSB first per byte with the
    trailing 6 bits zero (osd_jax.py:221-227)."""
    pad = torch.zeros(u.shape[:-1] + (6,), dtype=u.dtype, device=u.device)
    b = torch.cat([u, pad], dim=-1).reshape(u.shape[:-1] + (7, 8))
    # the bit weights made on the device: a host list would cross as a
    # blocking copy
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=u.device)
    return (b.to(torch.int32) << shifts).sum(dim=-1).to(torch.uint8)


__all__ = ["KERNEL_LAUNCHES", "PLAIN_CALLS", "bits_to_payload",
           "osd_decode_lanes", "osd_decode_lanes_plain", "reset_counters"]
