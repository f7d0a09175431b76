"""The device OSD's operations and their peak: the population counts an
ordered-statistics decode of the WSPR code needs, and one NVIDIA H100
SXM's rate of them.

A decode of order n scores every flip pattern of weight 0 to n of the 50
information positions, sum_k C(50, k) candidates (251,176 at order 4). A
candidate's score weighs its mismatch over the 112 parity positions with
the reliabilities 0 to 128: 8 bit-planes of 4 32-bit words each, 32
population counts a candidate (8,037,632 a decode at order 4), whatever
implements the decode.

Peak: 16 population counts a clock an SM (CUDA C++ Programming Guide,
throughput of native arithmetic instructions, compute capability 9.0) x
132 SMs x 1,980 MHz (H100 SXM boost clock)."""

from math import comb

INFO, PARITY = 50, 112
WORD_BITS, PLANES = 32, 8
POPC_PER_CLOCK_SM, SMS, CLOCK_HZ = 16, 132, 1.98e9
POPC_PER_S = POPC_PER_CLOCK_SM * SMS * CLOCK_HZ


def popcounts(order: int) -> int:
    """Population counts of one decode at ``order``."""
    words = -(-PARITY // WORD_BITS)
    return sum(comb(INFO, k) for k in range(order + 1)) * words * PLANES
