"""The port's bench.py: multichannel window-decode throughput on one card.

    python -m uwspr_tpu_torch.harness.bench [--device cuda|cpu]

Prints ONE JSON line on stdout, with bench.py's keys:

    {"metric": "window_samples_per_s_per_chip", "value": N,
     "unit": "samples/s", "vs_baseline": N}

bench.py's scene (seed 0: the VE3EMB frame + AWGN at BENCH_SNR dB,
random offsets and starts, BENCH_WINDOWS windows), its environment knobs
(BENCH_WINDOWS, BENCH_SNR, BENCH_REPS, BENCH_REFINE_LANES,
BENCH_PROBE_DTYPE, BENCH_FANO_LANES, BENCH_CAND_LANES, and BENCH_STFT,
which also takes "pallas", the STFT kernel) and its explicit
``PipelineConfig(...)`` (bench.py:106-112). value is 0 unless every window
decodes. vs_baseline divides by the reference's real-time rate: one
45000-sample window per 9 s hop on one CPU thread, 5000 window-samples/s
(BASELINE.md). BENCH_FANO_IMPL other than "auto" names the lax.while_loop
Fano, which is not ported; the script refuses it.

The batch is on the card before the timing; each of BENCH_REPS decodes is
timed by CUDA events, the whole run by the host clock ending on
``torch.cuda.synchronize()``. Per-batch times and the roofline line
(utils/roofline.py) go to stderr, and the record to
torch_results/bench.json, with the run's kernel launches and plain-version
calls by kernel (the wrappers' counters, over the whole process).
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import torch

from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig,
                                    PipelineConfig)
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.fec import fano
from uwspr_tpu_torch.harness import common, scenes
from uwspr_tpu_torch.ops import probe, select, stft
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.utils.roofline import analyze, cost_of

BASELINE_SAMPLES_PER_S = 5000.0
COUNTED = (("select_best", select), ("fano_decode", fano),
           ("probe_powers", probe), ("stft_power", stft))
FANO_REFUSED = ("BENCH_FANO_IMPL={!r}: the lax.while_loop Fano is on "
                "ROADMAP.md's do-not-port list; the port's on-device Fano "
                "is its CUDA kernel (BENCH_FANO_IMPL=auto)")


def knobs(env=os.environ) -> dict:
    """bench.py's environment knobs, with its defaults."""
    n = int(env.get("BENCH_WINDOWS", "128"))
    k = {"windows": n,
         "snr_db": float(env.get("BENCH_SNR", "-18")),
         "reps": int(env.get("BENCH_REPS", "8")),
         "refine_max_lanes": int(env.get("BENCH_REFINE_LANES", str(2 * n))),
         "probe_dtype": env.get("BENCH_PROBE_DTYPE", "bf16"),
         "fano_compact_lanes": int(env.get("BENCH_FANO_LANES", str(2 * n))),
         "fano_impl": env.get("BENCH_FANO_IMPL", "auto"),
         "cand_compact_lanes": int(env.get("BENCH_CAND_LANES", str(2 * n))),
         "stft_impl": env.get("BENCH_STFT", "matmul_bf16")}
    if k["fano_impl"] != "auto":
        raise SystemExit(FANO_REFUSED.format(k["fano_impl"]))
    return k


def make_decoder(k: dict, device: torch.device) -> DeviceDecoder:
    """bench.py:98-117's decoder."""
    if (k["refine_max_lanes"] or k["fano_compact_lanes"]
            or k["cand_compact_lanes"] or k["probe_dtype"] != "f32"
            or k["stft_impl"] != "fft"):
        return DeviceDecoder(PipelineConfig(
            coarse=CoarseConfig(stft_impl=k["stft_impl"]),
            demod=DemodConfig(
                refine_max_lanes=k["refine_max_lanes"],
                probe_dtype=k["probe_dtype"],
                fano_compact_lanes=k["fano_compact_lanes"],
                fano_impl=k["fano_impl"],
                cand_compact_lanes=k["cand_compact_lanes"])),
            device=device)
    return DeviceDecoder(PipelineConfig(), device=device)


def decoded(decoder: DeviceDecoder, packed, expected) -> int:
    out = decoder.unpack_output(packed)
    return sum(expected[w] in decoder.messages(out.window(w))
               for w in range(len(expected)))


def reference_decoded() -> tuple[int, int]:
    """(decoded, windows) of the reference's last bench record."""
    tail = common.load_record("BENCH_r05.json")["tail"]
    m = re.search(r"(\d+)/(\d+) windows decoded correctly", tail)
    return int(m.group(1)), int(m.group(2))


def run(device: torch.device, env=os.environ) -> dict:
    log = common.log
    k = knobs(env)
    n = k["windows"]
    log(f"device: {common.card_identity(device)}; "
        + " ".join(f"{f}: {v}" for f, v in k.items()))
    decoder = make_decoder(k, device)
    windows, expected = scenes.bench_windows(n, k["snr_db"])
    ri = torch.from_numpy(scenes.to_ri(windows)).to(device)
    common.sync(device)

    t0 = time.perf_counter()
    decoder.decode_windows_ri(ri)
    common.sync(device)
    log(f"first decode of {n} windows: {time.perf_counter() - t0:.2f} s")

    cuda = device.type == "cuda"
    marks = ([torch.cuda.Event(enable_timing=True)
              for _ in range(k["reps"] + 1)] if cuda else [])
    stamps = []
    t0 = time.perf_counter()
    if cuda:
        marks[0].record()
    for r in range(k["reps"]):
        out = decoder.decode_windows_ri(ri)
        if cuda:
            marks[r + 1].record()
        stamps.append(time.perf_counter() - t0)
    common.sync(device)
    dt = (time.perf_counter() - t0) / k["reps"]
    per_batch = ([a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
                 if cuda else [])
    log(f"host seconds at each batch's return: "
        + " ".join(f"{s:.4f}" for s in stamps)
        + ("; per-batch seconds (CUDA events): "
           + " ".join(f"{s:.4f}" for s in per_batch) if cuda else ""))
    ok = decoded(decoder, out, expected)
    log(f"{ok}/{n} windows decoded correctly; {dt / n * 1000:.4f} ms/window")

    line = "not measured (CPU run)"
    if cuda:
        flops, nbytes = cost_of(decoder.decode_windows_ri, ri)
        line = (analyze(flops, nbytes, dt).line() + " (torch operators "
                "only; the CUDA kernels and memory traffic are not counted)")
    log(f"roofline: {line}")

    value = n * 45000.0 / dt if ok == n else 0.0
    ref_ok, ref_n = reference_decoded()
    return {"line": {"metric": "window_samples_per_s_per_chip",
                     "value": round(value, 1), "unit": "samples/s",
                     "vs_baseline": round(value / BASELINE_SAMPLES_PER_S,
                                          3)},
            "knobs": k, "decoded": f"{ok}/{n}",
            "ms_per_window": dt / n * 1e3,
            "batch_seconds_events": per_batch, "roofline": line,
            "peak_mib": (torch.cuda.max_memory_allocated(device) / 2**20
                         if cuda else None),
            "vs_reference": {"decoded": common.vs_reference(
                {"bench_scene": ok / n}, {"bench_scene": ref_ok / ref_n},
                "decoded", n)},
            "exact": {"every_window_decoded": ok == n},
            "kernel_launches": {k: m.KERNEL_LAUNCHES for k, m in COUNTED},
            "plain_calls": {k: m.PLAIN_CALLS for k, m in COUNTED}}


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device)
    res = run(device)
    record = {**common.record_head("bench", "bench.py (BENCH_r05.json)",
                                   device),
              **{f: v for f, v in res.items() if f != "line"},
              "result": res["line"]}
    rc = common.finish(record, args.out, "bench")
    print(json.dumps(res["line"]), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
