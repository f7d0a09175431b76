"""WSPR protocol tables and the type-1 message packer, for the benchmark's
generator and its plain reference.

The sync vector and the 6 dB soft-decision table are data of the WSPR
protocol (wsprd's pr3 vector and metric table 2, shared by every WSPR
decoder). The rest is derived here: the K=32 r=1/2 code's polynomials,
the bit-reversal interleaver, the Fano metric table, the 4-FSK tone
offsets, the type-1 "CALL GRID dBm" packer and the channel symbols.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 375
SPB = 256                                   # samples per symbol
N_SYMBOLS = 162
N_CODED_BITS = 81                           # 50 info bits + 31 tail bits
FRAME_SAMPLES = N_SYMBOLS * SPB             # 41,472
TONE_SPACING = SAMPLE_RATE / SPB
TONE_OFFSETS = np.array([-1.5, -0.5, 0.5, 1.5])
POLY1 = 0xF2D05351
POLY2 = 0xE4613C47

SYNC_VECTOR = np.array([int(c) for c in (
    "110000001000111000100101111000000010010100000010110011010001101000011010101010010"
    "010110001101010001000001001001110110011010001110000010100110000000110101100011000")], dtype=np.uint8)

METRIC_TABLE_6DB = np.array([
    0.9999, 0.9998, 0.9998, 0.9998, 0.9998, 0.9998, 0.9997, 0.9997,
    0.9997, 0.9997, 0.9997, 0.9996, 0.9996, 0.9996, 0.9995, 0.9995,
    0.9994, 0.9994, 0.9994, 0.9993, 0.9993, 0.9992, 0.9991, 0.9991,
    0.9990, 0.9989, 0.9988, 0.9988, 0.9988, 0.9986, 0.9985, 0.9984,
    0.9983, 0.9982, 0.9980, 0.9979, 0.9977, 0.9976, 0.9974, 0.9971,
    0.9969, 0.9968, 0.9965, 0.9962, 0.9960, 0.9957, 0.9953, 0.9950,
    0.9947, 0.9941, 0.9937, 0.9933, 0.9928, 0.9922, 0.9917, 0.9911,
    0.9904, 0.9897, 0.9890, 0.9882, 0.9874, 0.9863, 0.9855, 0.9843,
    0.9832, 0.9819, 0.9806, 0.9792, 0.9777, 0.9760, 0.9743, 0.9724,
    0.9704, 0.9683, 0.9659, 0.9634, 0.9609, 0.9581, 0.9550, 0.9516,
    0.9481, 0.9446, 0.9406, 0.9363, 0.9317, 0.9270, 0.9218, 0.9160,
    0.9103, 0.9038, 0.8972, 0.8898, 0.8822, 0.8739, 0.8647, 0.8554,
    0.8457, 0.8357, 0.8231, 0.8115, 0.7984, 0.7854, 0.7704, 0.7556,
    0.7391, 0.7210, 0.7038, 0.6840, 0.6633, 0.6408, 0.6174, 0.5939,
    0.5678, 0.5410, 0.5137, 0.4836, 0.4524, 0.4193, 0.3850, 0.3482,
    0.3132, 0.2733, 0.2315, 0.1891, 0.1435, 0.0980, 0.0493, 0.0000,
    -0.0510, -0.1052, -0.1593, -0.2177, -0.2759, -0.3374, -0.4005, -0.4599,
    -0.5266, -0.5935, -0.6626, -0.7328, -0.8051, -0.8757, -0.9498, -1.0271,
    -1.1019, -1.1816, -1.2642, -1.3459, -1.4295, -1.5077, -1.5958, -1.6818,
    -1.7647, -1.8548, -1.9387, -2.0295, -2.1152, -2.2154, -2.3011, -2.3904,
    -2.4820, -2.5786, -2.6730, -2.7652, -2.8616, -2.9546, -3.0526, -3.1445,
    -3.2445, -3.3416, -3.4357, -3.5325, -3.6324, -3.7313, -3.8225, -3.9209,
    -4.0248, -4.1278, -4.2261, -4.3193, -4.4220, -4.5262, -4.6214, -4.7242,
    -4.8234, -4.9245, -5.0298, -5.1250, -5.2232, -5.3267, -5.4332, -5.5342,
    -5.6431, -5.7270, -5.8401, -5.9350, -6.0407, -6.1418, -6.2363, -6.3384,
    -6.4536, -6.5429, -6.6582, -6.7433, -6.8438, -6.9478, -7.0789, -7.1894,
    -7.2714, -7.3815, -7.4810, -7.5575, -7.6852, -7.8071, -7.8580, -7.9724,
    -8.1000, -8.2207, -8.2867, -8.4017, -8.5287, -8.6347, -8.7082, -8.8319,
    -8.9448, -9.0355, -9.1885, -9.2095, -9.2863, -9.4186, -9.5064, -9.6386,
    -9.7207, -9.8286, -9.9453, -10.0701, -10.1735, -10.3001, -10.2858, -10.5427,
    -10.5982, -10.7361, -10.7042, -10.9212, -11.0097, -11.0469, -11.1155, -11.2812,
    -11.3472, -11.4988, -11.5327, -11.6692, -11.9376, -11.8606, -12.1372, -13.2539,
], dtype=np.float64)

_ALPHABET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ "


def _bit_reverse8(i: np.ndarray) -> np.ndarray:
    i = i.astype(np.uint32)
    i = ((i & 0xF0) >> 4) | ((i & 0x0F) << 4)
    i = ((i & 0xCC) >> 2) | ((i & 0x33) << 2)
    return ((i & 0xAA) >> 1) | ((i & 0x55) << 1)


def _interleave_perm() -> np.ndarray:
    """PERM[p] = channel position of coded bit p: bit-reversed 0..255,
    positions under 162 kept in order."""
    j = _bit_reverse8(np.arange(256))
    return j[j < N_SYMBOLS].astype(np.int64)


INTERLEAVE_PERM = _interleave_perm()


def _round_half_away(x: np.ndarray) -> np.ndarray:
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def fano_metric_table(bias: float = 0.45) -> np.ndarray:
    """(2, 256) int32: mettab[sent bit][received soft symbol]."""
    t = METRIC_TABLE_6DB
    return np.stack([_round_half_away(10.0 * (t - bias)),
                     _round_half_away(10.0 * (t[::-1] - bias))]
                    ).astype(np.int32)


METTAB = fano_metric_table()


def pack_type1(call: str, grid: str, power_dbm: int) -> bytes:
    """"CALL GRID dBm" -> the 7-byte payload (50 bits, then zeros)."""
    call = call.upper().strip()
    if not call[2:3].isdigit():
        call = " " + call
    call = f"{call:<6s}"
    idx = _ALPHABET.index
    n1 = idx(call[0]) * 36 + idx(call[1])
    n1 = n1 * 10 + int(call[2])
    for ch in call[3:]:
        n1 = n1 * 27 + idx(ch) - 10
    g = grid.upper()
    ngrid = ((179 - 10 * (ord(g[0]) - 65) - int(g[2])) * 180
             + 10 * (ord(g[1]) - 65) + int(g[3]))
    n2 = ngrid * 128 + power_dbm + 64
    return bytes([(n1 >> 20) & 255, (n1 >> 12) & 255, (n1 >> 4) & 255,
                  ((n1 & 15) << 4) | ((n2 >> 18) & 15), (n2 >> 10) & 255,
                  (n2 >> 2) & 255, (n2 & 3) << 6])


def channel_symbols(payload: bytes) -> np.ndarray:
    """7-byte payload -> 162 four-ary channel symbols: the 50 bits and 31
    zeros through the K=32 r=1/2 encoder (parity of the state under POLY1,
    then POLY2), interleaved, plus the sync bit."""
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))[:50]
    state, coded = 0, []
    for b in list(bits) + [0] * 31:
        state = ((state << 1) | int(b)) & 0xFFFFFFFF
        coded += [(state & POLY1).bit_count() & 1,
                  (state & POLY2).bit_count() & 1]
    sym = np.zeros(N_SYMBOLS, np.uint8)
    sym[INTERLEAVE_PERM] = coded
    return (SYNC_VECTOR + 2 * sym).astype(np.uint8)
