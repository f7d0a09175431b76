#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's two decode engines.

    python3 scripts/torch_stages.py [--engine device|host|all]
                                    [--windows 128] [--reps 10]
                                    [--host-windows 128] [--host-rounds 3]
                                    [--device cuda] [--out DIR]

Device engine (``--engine device``, the default). Runs bench.py's scene
(seed 0, "VE3EMB FN25 30" at -18 dB) through
``uwspr_tpu_torch.pipeline.device_decoder.DeviceDecoder`` under
``with_serving_defaults(PipelineConfig(), W)`` and reports:

1. a per-stage split by prefix: each prefix of the decode (coarse grid;
   + model selection; + refinement to the deinterleaved symbols; + Fano,
   first-success select and packing, which is the whole decode) is timed on
   its own, and a stage is its prefix minus the one before. On CUDA a
   prefix is timed with CUDA events; the prefixes are taken in turns, and
   each figure is the median of ``--reps`` rounds after one warm-up. The
   split runs under ``captured.eager()``: a prefix is a part of the batch
   program, which the decoder otherwise replays whole as one CUDA graph,
   so each prefix is timed as the eager launches of its stages;
2. on CUDA, three whole decodes under ``torch.profiler`` (the decoder's
   captured program, replayed as it serves): host wall time,
   device busy time (the sum of the kernels' own device time) and the idle
   share 1 - busy / wall, and the top kernels and operators by device time.
   The full table goes to ``DIR/torch_stages_profile.txt`` when ``--out`` is
   given.

Host engine (``--engine host``). Runs the scene's first ``--host-windows``
windows one at a time through ``uwspr_tpu_torch.pipeline.decoder.
WindowDecoder(PipelineConfig())`` and reports:

3. per-window latency: each call timed on the host clock (every stage of
   the host engine ends in a copy to the host, and a synchronize closes the
   call), over ``--host-rounds`` rounds after one warm-up: mean, median and
   p90 of each round and of all calls, and the ``StageTimers`` split;
4. on CUDA, 16 windows under ``torch.profiler``: host wall time, device
   busy time split into kernels and copies/sets, busy time per window, the
   idle share 1 - busy / wall of that run and the same against the
   unprofiled mean ms/window, and the top kernels by device time.

``--engine all`` runs both. Prints the card's name and power limit
(nvidia-smi) beside the numbers and one JSON object of all of them as its
last line. ``--device cpu`` runs the same stages with host timers at a small
``--windows`` / ``--host-windows`` to check the script.
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
    from uwspr_tpu_torch.pipeline.captured import eager
    runs = prefixes(dec)
    ms = {name: [] for name in runs}
    with torch.no_grad(), exact_f32(), eager():
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


def profile(run, n: int, out: pathlib.Path | None, tag: str) -> dict:
    """``run(i)`` for i < n under torch.profiler after one warm-up call:
    host wall time, device busy time (kernels, and copies/sets apart) and
    the idle share 1 - busy / wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    run(0)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) \
                + e.self_device_time_total / 1e3
    busy = sum(kernels.values())
    copies = sum(v for k, v in kernels.items()
                 if k.startswith(("Memcpy", "Memset")))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40, max_name_column_width=60)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"torch_stages_profile_{tag}.txt").write_text(table)
    return {"calls": n, "wall_ms": wall, "busy_ms": busy,
            "copy_ms": copies, "kernel_ms": busy - copies,
            "idle_share": 1.0 - busy / wall,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def print_profile(card: str, p: dict, what: str) -> None:
    print(f"{card}: {p['calls']} {what} under torch.profiler: wall "
          f"{p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms "
          f"(kernels {p['kernel_ms']:.3f}, copies/sets {p['copy_ms']:.3f}), "
          f"idle share {p['idle_share']:.4f}", flush=True)
    for name, v in p["top_kernels_ms"]:
        print(f"  {v:9.3f} ms  {100 * v / p['busy_ms']:5.1f}%  {name}",
              flush=True)


def run_device(args, card: str, cuda: bool) -> dict:
    import torch

    from uwspr_tpu_torch.config import PipelineConfig, with_serving_defaults
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    W = args.windows
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), W),
                        device=args.device)
    ri = torch.from_numpy(make_windows(W)).to(dec.device)
    res = {"windows": W, "reps": args.reps}
    res.update(time_prefixes(dec, ri, args.reps, cuda))
    print(f"{card}: ms per {W}-window batch, median of {args.reps}: "
          + "  ".join(f"{k} {v:.3f}" for k, v in res["stage_ms"].items())
          + f"  whole {res['whole_ms']:.3f}", flush=True)
    if cuda:
        res["profile"] = profile(lambda i: dec.decode_windows_ri(ri), 3,
                                 args.out, "device")
        print_profile(card, res["profile"], "device-engine decodes")
    return res


def latency_summary(ms: list[float]) -> dict:
    q = statistics.quantiles(ms, n=10, method="inclusive")
    return {"n": len(ms), "mean": statistics.fmean(ms),
            "median": statistics.median(ms), "p90": q[8],
            "min": min(ms), "max": max(ms)}


def run_host(args, card: str, cuda: bool) -> dict:
    import numpy as np
    import torch

    from uwspr_tpu_torch.config import PipelineConfig
    from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
    n = args.host_windows
    ri = make_windows(n)
    zs = (ri[:, 0] + 1j * ri[:, 1]).astype(np.complex64)
    hdec = WindowDecoder(PipelineConfig(), device=args.device)

    def call(i):
        r = hdec(zs[i % n])
        if cuda:
            torch.cuda.synchronize()
        return r

    call(0)
    hdec.timers.reset()
    rounds, decoded = [], 0
    for _ in range(args.host_rounds):
        ms = []
        for i in range(n):
            t0 = time.perf_counter()
            r = call(i)
            ms.append((time.perf_counter() - t0) * 1e3)
            decoded += "VE3EMB FN25 30" in [s.message for s in r.spots]
        rounds.append(ms)
    every = [v for ms in rounds for v in ms]
    res = {"windows": n, "rounds": args.host_rounds,
           "decoded": decoded, "calls": len(every),
           "round_ms": [latency_summary(ms) for ms in rounds],
           "all_ms": latency_summary(every),
           "stage_ms_per_window": {k: v / len(every) * 1e3 for k, v in
                                   hdec.timers.totals.items()}}
    a = res["all_ms"]
    print(f"{card}: host engine WindowDecoder(PipelineConfig()), {n} windows"
          f" x {args.host_rounds} rounds: ms/window mean {a['mean']:.3f}, "
          f"median {a['median']:.3f}, p90 {a['p90']:.3f} (min {a['min']:.3f},"
          f" max {a['max']:.3f}); {decoded}/{len(every)} decoded", flush=True)
    for k, r in enumerate(res["round_ms"]):
        print(f"  round {k}: mean {r['mean']:.3f}, median {r['median']:.3f}, "
              f"p90 {r['p90']:.3f}", flush=True)
    print("  stages (ms/window): " + "  ".join(
        f"{k} {v:.3f}" for k, v in res["stage_ms_per_window"].items()),
        flush=True)
    if cuda:
        np_ = min(16, n)
        p = profile(call, np_, args.out, "host")
        p["busy_ms_per_window"] = p["busy_ms"] / np_
        p["idle_share_vs_unprofiled_mean"] = (
            1.0 - p["busy_ms_per_window"] / a["mean"])
        res["profile"] = p
        print_profile(card, p, "host-engine windows")
        print(f"  busy {p['busy_ms_per_window']:.3f} ms per window; idle "
              f"share against the unprofiled mean ms/window "
              f"{p['idle_share_vs_unprofiled_mean']:.4f}", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine", default="device",
                    choices=("device", "host", "all"))
    ap.add_argument("--windows", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--host-windows", type=int, default=128)
    ap.add_argument("--host-rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()

    cuda = args.device == "cuda"
    card = card_name() if cuda else "cpu (host timers)"
    print(card, flush=True)
    res = {"card": card}
    if args.engine in ("device", "all"):
        res["device_engine"] = run_device(args, card, cuda)
    if args.engine in ("host", "all"):
        res["host_engine"] = run_host(args, card, cuda)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
