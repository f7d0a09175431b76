"""Convolutional encoder for the WSPR K=32 r=1/2 code (test-vector oracle).

A from-scratch, vectorized NumPy implementation of the encoder whose behavior
matches the reference's Fano::encode (lib/Fano.cc:81-100): data bytes are
consumed high-bit-first into a shift register; each input bit emits the parity
of (state & POLY1) then the parity of (state & POLY2).

This replaces the external `wsprsim` tool the reference relies on
(README.md:35-43): together with protocol.messages.pack and
protocol.modulate, it can synthesize arbitrary valid frames for testing.

The port's own copy of uwspr_tpu/protocol/fec_encode.py (imports pointed
inside uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import numpy as np

from uwspr_tpu_torch.protocol.constants import (
    INTERLEAVE_PERM,
    N_SYMBOLS,
    POLY1,
    POLY2,
    SYNC_VECTOR,
)


def bytes_to_bits(data: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """Unpack bytes to bits, high bit first."""
    bits = np.unpackbits(np.asarray(data, dtype=np.uint8))
    return bits if nbits is None else bits[:nbits]


def bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    """Pack bits (high bit first) into bytes, zero-padding the tail."""
    return np.packbits(np.asarray(bits, dtype=np.uint8))


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64).copy()
    x ^= x >> np.uint64(32)
    x ^= x >> np.uint64(16)
    x ^= x >> np.uint64(8)
    x ^= x >> np.uint64(4)
    x ^= x >> np.uint64(2)
    x ^= x >> np.uint64(1)
    return (x & np.uint64(1)).astype(np.uint8)


def encode_bits(bits: np.ndarray) -> np.ndarray:
    """Encode a bit vector -> 2*len(bits) coded symbols (one bit per entry).

    Output order per input bit: POLY1 symbol then POLY2 symbol
    (lib/Fano.cc:94-96).
    """
    bits = np.asarray(bits, dtype=np.uint64)
    n = len(bits)
    # state after consuming bit i is (b_0..b_i) in the low bits; only the low
    # 32 bits ever matter because the polynomials are 32-bit.
    states = np.zeros(n, dtype=np.uint64)
    s = np.uint64(0)
    mask = np.uint64(0xFFFFFFFF)
    for i in range(n):
        s = ((s << np.uint64(1)) | bits[i]) & mask
        states[i] = s
    out = np.empty(2 * n, dtype=np.uint8)
    out[0::2] = _parity(states & np.uint64(POLY1))
    out[1::2] = _parity(states & np.uint64(POLY2))
    return out


def encode_frame_bits(info_bits_50: np.ndarray) -> np.ndarray:
    """50 info bits -> 162 coded bits (with 31-bit zero tail), pre-interleave."""
    info_bits_50 = np.asarray(info_bits_50, dtype=np.uint8)
    assert info_bits_50.shape == (50,)
    padded = np.concatenate([info_bits_50, np.zeros(31, dtype=np.uint8)])
    return encode_bits(padded)  # 162 coded bits


def channel_symbols(info_bits_50: np.ndarray) -> np.ndarray:
    """50 info bits -> 162 4-ary channel symbols (0..3), transmit order.

    symbol[t] = sync[t] + 2 * coded_bit_at_position_t, where the interleaver
    places coded bit p at channel position INTERLEAVE_PERM[p]. The data bit
    selects between the lower and upper tone pair; the sync bit selects the
    odd/even tone within the pair (WSPR standard; consistent with the
    demodulator's p1/p3 vs p0/p2 split at lib/sync_and_demodulate_impl.cc:216-224
    and the coarse scorer at lib/FDR_impl.cc:199-207).
    """
    coded = encode_frame_bits(info_bits_50)      # coded-bit order
    sym = np.zeros(N_SYMBOLS, dtype=np.uint8)
    sym[INTERLEAVE_PERM] = coded                 # interleave to channel order
    return (SYNC_VECTOR + 2 * sym).astype(np.uint8)


__all__ = [
    "bytes_to_bits", "bits_to_bytes", "encode_bits", "encode_frame_bits",
    "channel_symbols",
]
