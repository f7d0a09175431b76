"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

HBM_BYTES_PER_S = 3.35e12
