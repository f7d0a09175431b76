"""Roofline accounting for measured decode intervals on an NVIDIA H100.

Counterpart of uwspr_tpu/utils/roofline.py. Dividing a program's FLOPs
and HBM bytes by a measured time and the card's peaks turns a stage time
into an attribution — tensor-core-bound, HBM-bound, or
dispatch/latency-bound — so perf work aims at the actual limiter.

Peaks are the H100 SXM data sheet's, at its 700 W power limit: 989 TFLOP/s
bf16 dense on the tensor cores, 3.35 TB/s HBM3. A card set below 700 W
(``nvidia-smi --query-gpu=power.limit``) reaches less; state the limit
beside any share computed against these peaks.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch.utils.flop_counter import FlopCounterMode

H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_HBM_BYTES = 3.35e12


@dataclass
class Roofline:
    flops: float                 # program total
    bytes_accessed: float
    seconds: float               # measured wall time per execution
    flops_per_s: float
    bytes_per_s: float
    tc_util: float               # vs the bf16 tensor-core peak
    hbm_util: float
    bound: str                   # "tensor core" | "HBM" | "dispatch/latency"

    def line(self) -> str:
        return (f"{self.flops / 1e9:.2f} GFLOP, "
                f"{self.bytes_accessed / 1e6:.1f} MB @ {self.seconds * 1e3:.2f} ms"
                f" -> {self.flops_per_s / 1e12:.2f} TFLOP/s "
                f"({self.tc_util * 100:.1f}% tensor core), "
                f"{self.bytes_per_s / 1e9:.1f} GB/s "
                f"({self.hbm_util * 100:.1f}% HBM) [{self.bound}-bound]")


def cost_of(fn, *args, **kwargs) -> tuple[float, float]:
    """(flops, bytes) of ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` while it runs. That mode
    sees torch operators only (matmuls, convolutions, ...), not the port's
    ctypes CUDA kernels, and it counts no memory traffic: bytes are
    returned as 0.0 (unknown), as the reference's cost_of does when the
    backend has no analysis."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops()), 0.0


def analyze(flops: float, bytes_accessed: float, seconds: float,
            *, peak_flops: float = H100_PEAK_BF16_FLOPS,
            peak_bytes: float = H100_PEAK_HBM_BYTES) -> Roofline:
    """Classify a measured interval. 'bound' is the larger utilization;
    if both are under 10% the interval is dominated by neither — small
    ops, kernel launches, or serialized scalar work (dispatch/latency)."""
    fps = flops / max(seconds, 1e-12)
    bps = bytes_accessed / max(seconds, 1e-12)
    tc = fps / peak_flops
    hbm = bps / peak_bytes
    if max(tc, hbm) < 0.10:
        bound = "dispatch/latency"
    elif tc >= hbm:
        bound = "tensor core"
    else:
        bound = "HBM"
    return Roofline(flops, bytes_accessed, seconds, fps, bps, tc, hbm,
                    bound)


__all__ = ["Roofline", "cost_of", "analyze",
           "H100_PEAK_BF16_FLOPS", "H100_PEAK_HBM_BYTES"]
