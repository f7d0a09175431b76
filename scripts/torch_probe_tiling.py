#!/usr/bin/env python3
"""Time the probe kernel (uwspr_tpu_torch/csrc/probe_powers.cu) at several
tilings against the one ops/probe.py::kernel_tiling picks, on the host
engine's four call shapes.

    python3 scripts/torch_probe_tiling.py

Needs a CUDA card. Inputs: one window of bench.py's scene (seed 0), 200
candidates at random 128-sample shifts with random drift, the 17-jiggle,
5-lag, 5-freq and single-probe (drift stage) grids of
demod/finesync.py. Each tiling is held to the
plain version (rtol 2e-4 + atol 2e-2) and timed with CUDA events, 20 calls
per turn behind a spin kernel, in turns A B C C B A, twice. Prints the card
and one line per shape.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_probe_tiling: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from uwspr_tpu_torch.device import exact_f32
    from uwspr_tpu_torch.io.channel import awgn
    from uwspr_tpu_torch.ops import probe
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    from uwspr_tpu_torch.utils import cuda_build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    lib = cuda_build.load_library()
    rng = np.random.default_rng(0)
    z = awgn(synthesize_frame("VE3EMB", "FN25", 30,
                              start_sample=int(rng.integers(0, 2000)),
                              freq_offset=float(rng.uniform(-5, 5))),
             -18.0, rng=rng)
    zri = torch.from_numpy(np.stack([z.real, z.imag]).astype(
        np.float32)).cuda()
    N, C = zri.shape[1], 200
    shift = rng.integers(0, 26, C) * 128
    jig = 8 * np.array([0, -1, 1, -2, 2, -3, 3, -4, 4, -5, 5, -6, 6, -7, 7,
                        -8, 8])
    drift = torch.from_numpy(rng.uniform(-1, 1, (C, 162)).astype(
        np.float32)).cuda()
    f1 = rng.uniform(-5, 5, C).astype(np.float32)
    shapes = {"L=17, F=1": (shift[:, None] + jig, f1[:, None]),
              "L=5, F=1": (shift[:, None] + np.arange(-128, 129, 64),
                           f1[:, None]),
              "L=1, F=5": (shift[:, None],
                           f1[:, None] + 0.25 * np.arange(-2, 3,
                                                          dtype=np.float32)),
              "L=1, F=1": (shift[:, None], f1[:, None])}

    def timed(fn, n=20):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    for name, (lags, freqs) in shapes.items():
        L, F = lags.shape[1], freqs.shape[1]
        lg = torch.from_numpy(lags.astype(np.int32)).cuda()
        fq = torch.from_numpy(np.ascontiguousarray(freqs)).cuda()
        with torch.no_grad(), exact_f32():
            want = probe.probe_powers_plain(zri, lg, fq, drift, n_lags=L)
        S0, _, _ = probe.kernel_tiling(L, F)
        fns = {}
        for S in sorted({S0, 32, 64}):
            threads = max(128, -(-L * F * (S // 2) // 32) * 32)
            if threads > 1024:
                continue

            def run(S=S, threads=threads):
                out = torch.empty((C, F, L, 162, 4), device="cuda")
                code = lib.uwspr_probe_powers(
                    zri.data_ptr(), N, lg.data_ptr(), fq.data_ptr(),
                    drift.data_ptr(), C, L, F, S, threads,
                    float(probe.PHASE), out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                cuda_build.check_launch("uwspr_probe_powers", code)
                return out
            d = (run() - want).abs()
            if bool((d > 2e-2 + 2e-4 * want.abs()).any()):
                raise AssertionError(f"{name} S={S}: kernel != plain")
            fns[f"S={S} ({threads} threads)"
                + (" [kernel_tiling]" if S == S0 else "")] = run
        turns = {k: [] for k in fns}
        order = list(fns) + list(reversed(list(fns)))
        for k in order + order:
            turns[k].append(timed(fns[k]))
        print(f"{name}: " + "; ".join(
            f"{k} {np.mean(v):.4f} ms (turns "
            f"{', '.join(f'{x:.4f}' for x in v)})" for k, v in turns.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
