"""WSPR protocol constants.

Everything a WSPR modem needs to know that is *protocol*, not implementation:
frame geometry, the convolutional code, the interleaver permutation, the sync
vector, and the Fano soft-decision metric table.

Reference parity notes (cited into the reference sources):
- Frame: 162 channel symbols, 50 info bits + 31 zero tail bits = 81 coded
  bits at rate 1/2 (lib/Fano.h, lib/sync_and_demodulate_impl.cc:93).
- Code: K=32 r=1/2 Layland-Lushbaugh, POLY1=0xf2d05351, POLY2=0xe4613c47
  (lib/Fano.cc:54-55).
- Modulation: 4-FSK, 375/256 baud, tone spacing 375/256 Hz, baseband tone
  offsets {-1.5, -0.5, +0.5, +1.5}*df (lib/sync_and_demodulate_impl.cc:146-148).
- Interleaver: 8-bit bit-reversal permutation, indices < 162 kept in order
  (lib/sync_and_demodulate_impl.cc:265-282).
- Fano metric: mettab[s][y] = round(10*(M[y or 255-y] - 0.45)) with M the
  6 dB 2-FSK table (lib/Fano.cc:39-44); round() is C round-half-away-from-zero.

The port's own copy of uwspr_tpu/protocol/constants.py (imports pointed
inside uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import numpy as np

from uwspr_tpu_torch.protocol._tables import METRIC_TABLE_6DB, SYNC_VECTOR

# ---------------------------------------------------------------------------
# Frame geometry
# ---------------------------------------------------------------------------
N_SYMBOLS = 162          # channel symbols per frame
N_INFO_BITS = 50         # information bits per frame
N_TAIL_BITS = 31         # all-zero flush bits (K-1)
N_CODED_BITS = N_INFO_BITS + N_TAIL_BITS   # 81 trellis steps
CONSTRAINT_LENGTH = 32   # K

# Baseband signal geometry (underwater WSPR profile of the reference)
SAMPLE_RATE = 375                    # S/s complex baseband
SAMPLES_PER_SYMBOL = 256             # "spb"
SYMBOL_RATE = SAMPLE_RATE / SAMPLES_PER_SYMBOL      # 375/256 ~ 1.4648 baud
TONE_SPACING = SAMPLE_RATE / SAMPLES_PER_SYMBOL     # Hz, == symbol rate
FRAME_SAMPLES = N_SYMBOLS * SAMPLES_PER_SYMBOL      # 41472 ~ 110.6 s
# Baseband center frequency of each of the 4 tones, in units of TONE_SPACING
TONE_OFFSETS = np.array([-1.5, -0.5, +0.5, +1.5])   # * TONE_SPACING Hz

# Audio-rate front end (reference example flowgraphs)
AUDIO_RATE = 12000
AUDIO_CENTER_FREQ = 1500
DECIMATION = AUDIO_RATE // SAMPLE_RATE               # 32

# Streaming window geometry (sliding_window_stream_to_pdu defaults)
WINDOW_SAMPLES = 45000   # "fl": 120 s at 375 S/s
WINDOW_HOP_SECONDS = 9   # "shift"
WINDOW_HOP_SAMPLES = WINDOW_HOP_SECONDS * SAMPLE_RATE   # 3375

# ---------------------------------------------------------------------------
# Convolutional code (K=32, r=1/2, Layland-Lushbaugh)
# ---------------------------------------------------------------------------
POLY1 = 0xF2D05351
POLY2 = 0xE4613C47


def _parity32(x: np.ndarray) -> np.ndarray:
    """Bitwise parity of each uint32 element (vectorized)."""
    x = x.astype(np.uint32).copy()
    x ^= x >> np.uint32(16)
    x ^= x >> np.uint32(8)
    x ^= x >> np.uint32(4)
    x ^= x >> np.uint32(2)
    x ^= x >> np.uint32(1)
    return (x & np.uint32(1)).astype(np.uint8)


# 8-bit parity lookup table (equivalent to the reference's Partab, lib/tab.c,
# but derived from first principles rather than transcribed).
PARITY8 = _parity32(np.arange(256, dtype=np.uint32))

# ---------------------------------------------------------------------------
# Interleaver
# ---------------------------------------------------------------------------


def _bit_reverse8(i: np.ndarray) -> np.ndarray:
    """Reverse the bit order of 8-bit integers (vectorized)."""
    i = i.astype(np.uint32)
    i = ((i & 0xF0) >> 4) | ((i & 0x0F) << 4)
    i = ((i & 0xCC) >> 2) | ((i & 0x33) << 2)
    i = ((i & 0xAA) >> 1) | ((i & 0x55) << 1)
    return i


def _make_interleave_permutation() -> np.ndarray:
    """PERM[p] = j means channel-symbol position j carries coded bit p.

    Matches the deinterleaver at lib/sync_and_demodulate_impl.cc:265-282:
    walk i = 0..255, j = bitreverse8(i); keep j < 162 in encounter order.
    """
    j = _bit_reverse8(np.arange(256))
    return j[j < N_SYMBOLS].astype(np.int32)


# coded-bit order -> channel-symbol order
INTERLEAVE_PERM = _make_interleave_permutation()
# channel-symbol order -> coded-bit order (inverse permutation)
DEINTERLEAVE_PERM = np.argsort(INTERLEAVE_PERM).astype(np.int32)


def deinterleave(symbols: np.ndarray) -> np.ndarray:
    """Reorder 162 channel-position soft symbols into coded-bit order."""
    return np.asarray(symbols)[..., INTERLEAVE_PERM]


def interleave(symbols: np.ndarray) -> np.ndarray:
    """Reorder 162 coded-bit-order symbols into channel-symbol order."""
    return np.asarray(symbols)[..., DEINTERLEAVE_PERM]


# ---------------------------------------------------------------------------
# Fano soft-decision metric table
# ---------------------------------------------------------------------------
FANO_METRIC_BIAS = 0.45


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C round(): half-way cases away from zero (numpy rounds half-to-even)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def make_fano_metric_table(bias: float = FANO_METRIC_BIAS) -> np.ndarray:
    """(2, 256) int32 metric table: mettab[sent_bit][received_soft_symbol].

    mettab[0][y] scores hypothesis "sent 0" for received byte y, mettab[1][y]
    scores "sent 1" (== mettab[0] reversed). Reference: lib/Fano.cc:39-44.
    """
    t = METRIC_TABLE_6DB
    m0 = _round_half_away(10.0 * (t - bias))
    m1 = _round_half_away(10.0 * (t[::-1] - bias))
    return np.stack([m0, m1]).astype(np.int32)


FANO_METTAB = make_fano_metric_table()

__all__ = [
    "N_SYMBOLS", "N_INFO_BITS", "N_TAIL_BITS", "N_CODED_BITS",
    "CONSTRAINT_LENGTH", "SAMPLE_RATE", "SAMPLES_PER_SYMBOL", "SYMBOL_RATE",
    "TONE_SPACING", "FRAME_SAMPLES", "TONE_OFFSETS", "AUDIO_RATE",
    "AUDIO_CENTER_FREQ", "DECIMATION", "WINDOW_SAMPLES", "WINDOW_HOP_SECONDS",
    "WINDOW_HOP_SAMPLES", "POLY1", "POLY2", "PARITY8", "SYNC_VECTOR",
    "INTERLEAVE_PERM", "DEINTERLEAVE_PERM", "deinterleave", "interleave",
    "FANO_METRIC_BIAS", "FANO_METTAB", "METRIC_TABLE_6DB",
    "make_fano_metric_table",
]
