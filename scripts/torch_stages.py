#!/usr/bin/env python3
"""Where the time goes in one batch of the PyTorch port's serving decode.

    python3 scripts/torch_stages.py [--windows 128] [--reps 10]
                                    [--device cuda] [--out DIR]

Runs bench.py's scene (seed 0, "VE3EMB FN25 30" at -18 dB) through
``uwspr_tpu_torch.pipeline.device_decoder.DeviceDecoder`` under
``with_serving_defaults(PipelineConfig(), W)`` and reports:

1. a per-stage split by prefix: each prefix of the decode (coarse grid;
   + model selection; + refinement to the deinterleaved symbols; + Fano,
   first-success select and packing, which is the whole decode) is timed on
   its own, and a stage is its prefix minus the one before. On CUDA a
   prefix is timed with CUDA events; the prefixes are taken in turns, and
   each figure is the median of ``--reps`` rounds after one warm-up;
2. on CUDA, three whole decodes under ``torch.profiler``: host wall time,
   device busy time (the sum of the kernels' own device time) and the idle
   share 1 - busy / wall, and the top kernels and operators by device time.
   The full table goes to ``DIR/torch_stages_profile.txt`` when ``--out`` is
   given.

Prints the card's name and power limit (nvidia-smi) beside the numbers and
one JSON object of all of them as its last line. ``--device cpu`` runs the
same stages with host timers at a small ``--windows`` to check the script.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import make_windows  # noqa: E402


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0].strip()


def prefixes(dec):
    """Name -> function of the (W, 2, fl) input running that prefix."""
    import torch

    def z(ri):
        return torch.complex(ri[:, 0], ri[:, 1])
    return {
        "coarse_grid": lambda ri: dec.coarse_grid(z(ri)),
        "select": lambda ri: dec._coarse_stage(z(ri)),
        "refine": lambda ri: dec.prefano(ri),
        "fano_pack": lambda ri: dec._pack(
            dec._fano_select_batch(dec.prefano(ri))),
    }


def time_prefixes(dec, ri, reps: int, cuda: bool) -> dict:
    import torch

    from uwspr_tpu_torch.device import exact_f32
    runs = prefixes(dec)
    ms = {name: [] for name in runs}
    with torch.no_grad(), exact_f32():
        for fn in runs.values():
            fn(ri)
        if cuda:
            torch.cuda.synchronize()
        for _ in range(reps):
            for name, fn in runs.items():
                if cuda:
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    fn(ri)
                    e.record()
                    torch.cuda.synchronize()
                    ms[name].append(s.elapsed_time(e))
                else:
                    t0 = time.perf_counter()
                    fn(ri)
                    ms[name].append((time.perf_counter() - t0) * 1e3)
    med = {name: statistics.median(v) for name, v in ms.items()}
    stages, prev = {}, 0.0
    for name, v in med.items():
        stages[name] = v - prev
        prev = v
    return {"prefix_ms": med, "stage_ms": stages, "whole_ms": prev}


def profile(dec, ri, n: int, out: pathlib.Path | None) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    dec.decode_windows_ri(ri)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            dec.decode_windows_ri(ri)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    kernels: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) \
                + e.self_device_time_total / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40, max_name_column_width=60)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / "torch_stages_profile.txt").write_text(table)
    return {"decodes": n, "wall_ms": wall, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()

    import torch

    from uwspr_tpu.config import PipelineConfig, with_serving_defaults
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    cuda = args.device == "cuda"
    card = card_name() if cuda else "cpu (host timers)"
    print(card, flush=True)
    W = args.windows
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), W),
                        device=args.device)
    ri = torch.from_numpy(make_windows(W)).to(dec.device)
    res = {"card": card, "windows": W, "reps": args.reps}
    res.update(time_prefixes(dec, ri, args.reps, cuda))
    print(f"{card}: ms per {W}-window batch, median of {args.reps}: "
          + "  ".join(f"{k} {v:.3f}" for k, v in res["stage_ms"].items())
          + f"  whole {res['whole_ms']:.3f}", flush=True)
    if cuda:
        res["profile"] = profile(dec, ri, 3, args.out)
        p = res["profile"]
        print(f"{card}: {p['decodes']} decodes under torch.profiler: wall "
              f"{p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms, "
              f"idle share {p['idle_share']:.4f}", flush=True)
        for name, v in p["top_kernels_ms"]:
            print(f"  {v:9.3f} ms  {100 * v / p['busy_ms']:5.1f}%  {name}",
                  flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
