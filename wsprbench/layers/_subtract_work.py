"""The device multipass subtraction's useful work and its peak: the float64
multiply-adds and the window bytes one subtracted frame needs, whatever
implements the subtraction, and one NVIDIA H100 SXM's rate of them.

A frame's subtraction evaluates its per-symbol gains, a complex product of
each of the frame's 41,472 samples with the replica (4 real multiply-adds
a sample), at every lag of both lag polishes (2 x (2 LAG_SEARCH + 1)), at
the first frequency polish and once at the end (2 more; the other
frequency polishes stop early), and fits the frame (a complex product a
sample, 4 more). Bytes: the frame's samples of the window read and
written, float32 pairs (16 bytes a sample). Both are lower bounds of what
any implementation does.

Peak: 64 float64 fused multiply-adds a clock an SM (CUDA C++ Programming
Guide, throughput of native arithmetic instructions, compute capability
9.0) x 132 SMs x 1,980 MHz (H100 SXM boost clock); HBM at
``_peaks.HBM_BYTES_PER_S``."""

FRAME = 162 * 256
DFMA_PER_CLOCK_SM, SMS, CLOCK_HZ = 64, 132, 1.98e9
DFMA_PER_S = DFMA_PER_CLOCK_SM * SMS * CLOCK_HZ
BYTES_PER_FRAME = FRAME * 16
# the subtraction's lag polish (+- samples) and frequency polishes, fixed
# in the program (pipeline/multipass.py's constants)
LAG_SEARCH, FREQ_ITERS = 16, 3


def fmas() -> int:
    """float64 multiply-adds of one subtracted frame, at least."""
    gains = 2 * (2 * LAG_SEARCH + 1) + (1 if FREQ_ITERS > 0 else 0) + 1
    return (gains + 1) * FRAME * 4
