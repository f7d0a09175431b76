"""The port's ring-ingest bench (scripts/bench_ring_ingest.py): the
device ring fed hop blocks from the host against the same decode fed
device-resident windows, in one process.

    python -m uwspr_tpu_torch.harness.ring_ingest [--device cuda|cpu]
        [--channels C]

Rows, all at the serving defaults of PipelineConfig() (W = C = 128), over
13 measured hops of
bench_ring_ingest.py's streams (a frame every 13 hops per channel, -18 dB):

  ring_f32           DeviceRingDecoder, f32 blocks: every hop's block is
                     staged first (``stage()``: pinned memory, copy stream),
                     then the hops are pushed and fetched in order
  ring_int16         the same with int16 blocks and a scale per channel
  ring_f32_unstaged  f32 blocks pushed as numpy arrays (push_hop's own
                     copy, as RingServe sends them): against ring_f32 it
                     shows what ``stage()`` overlaps
  ring_multi13_cold  ``push_hops`` of 13 int16 hops in one call, the first
  ring_multi13       and a second call
  device_resident    DeviceDecoder on a (C, 2, fl) batch already on the
                     card (bench.py's methodology: no steady-state copy)
  full_h2d           the full windows copied to the card at every step
  h2d_only           the bare copy of one hop block per step

Seconds per step by the host clock ending on ``torch.cuda.synchronize()``;
host-to-device bytes per step from a ``torch.profiler`` trace of further
steps of the same row (the memcpy events' byte counts), not inferred.
Writes torch_results/ring_ingest.json. Checks: every decoding row decodes
all C channels in its best step (the record: 128 in every row); on the
card, each row's bytes per step are at least what it must send (the hop
block, int16 with its scales, or the full windows) and at most that plus
HTOD_SLACK.
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from uwspr_tpu_torch.config import PipelineConfig, with_serving_defaults
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.harness import common, scenes
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.pipeline.device_ring import DeviceRingDecoder

REFERENCE = "BENCH_RING_r05.json"
HTOD_SLACK = 64 * 1024          # bytes per step beside what a row must send
C = 128
HOPS = 13
FL, HOP = scenes.FL, scenes.HOP


def htod_bytes(step, n: int, device) -> float | None:
    """Host-to-device bytes per call of ``step`` over n calls traced by
    torch.profiler after one warm-up call the trace leaves out; None on
    the CPU."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(path))) as prof:
            for _ in range(n + 1):
                step()
                torch.cuda.synchronize()
                prof.step()
        events = json.loads(path.read_text())["traceEvents"]
    return sum(int(e["args"]["bytes"]) for e in events
               if e.get("cat") == "gpu_memcpy"
               and "HtoD" in e.get("name", "")) / n


def prefill(ring, streams) -> int:
    """Push hops from the stream's head until the ring decodes; the index
    of the hop whose push first decoded."""
    k = 0
    while ring.push_hop(streams[:, k * HOP:(k + 1) * HOP]) is None:
        k += 1
    return k


def blocks(streams, first: int, n: int) -> list:
    return [np.ascontiguousarray(scenes.to_ri(
        streams[:, (first + i) * HOP:(first + i + 1) * HOP]))
        for i in range(n)]


def decoded_per_step(outs) -> list:
    return [int(o.success.any(axis=-1).sum()) for o in outs]


def row(seconds: float, decoded: int, c: int, htod, note: str = "",
        per_step=None) -> dict:
    return {"seconds_per_step": seconds,
            "window_samples_per_s": c * FL / seconds,
            "ms_per_window": seconds / c * 1e3, "decoded": decoded,
            "htod_bytes_per_step": htod, "per_step_decodes": per_step,
            "note": note}


def ring_rows(streams, c: int, device) -> dict:
    rows = {}
    for name, dtype, staged in (("ring_f32", "f32", True),
                                ("ring_int16", "int16", True),
                                ("ring_f32_unstaged", "f32", False)):
        ring = DeviceRingDecoder(PipelineConfig(), n_channels=c,
                                 ingest_dtype=dtype,
                                 apply_serving_defaults=True, device=device)
        k = prefill(ring, streams)
        # bench_ring_ingest.py warms with the hop that just decoded again
        ring.fetch(ring.push_hop(streams[:, k * HOP:(k + 1) * HOP]))
        blk = blocks(streams, k + 1, HOPS)
        common.sync(device)
        t0 = time.perf_counter()
        pushed = [ring.stage(b) for b in blk] if staged else blk
        handles = [ring.push_hop(b) for b in pushed]
        outs = [ring.fetch(h) for h in handles]
        common.sync(device)
        dt = (time.perf_counter() - t0) / HOPS
        per = decoded_per_step(outs)
        extra = iter(blocks(streams, 0, 5))
        htod = htod_bytes(
            (lambda: ring.push_hop(ring.stage(next(extra)))) if staged
            else (lambda: ring.push_hop(next(extra))), 4, device)
        rows[name] = row(dt, max(per), c, htod,
                         "staged up front" if staged else
                         "numpy blocks, push_hop's copy", per)
        common.log(f"{name}: {json.dumps(rows[name])}")

    ring = DeviceRingDecoder(PipelineConfig(), n_channels=c,
                             ingest_dtype="int16",
                             apply_serving_defaults=True, device=device)
    k = prefill(ring, streams)
    stack = np.stack(blocks(streams, k + 1, HOPS))
    for name in ("ring_multi13_cold", "ring_multi13"):
        common.sync(device)
        t0 = time.perf_counter()
        out = ring.fetch(ring.push_hops(stack))    # the second call
        common.sync(device)                        # re-pushes the scene
        dt = (time.perf_counter() - t0) / HOPS
        per = decoded_per_step([out.window(i) for i in range(HOPS)])
        rows[name] = row(dt, max(per), c, None,
                         f"one push_hops call for {HOPS} hops", per)
    rows["ring_multi13"]["htod_bytes_per_step"] = htod_bytes(
        lambda: ring.push_hops(stack), 1, device)
    if rows["ring_multi13"]["htod_bytes_per_step"] is not None:
        rows["ring_multi13"]["htod_bytes_per_step"] /= HOPS
    common.log(f"ring_multi13: {json.dumps(rows['ring_multi13'])}")
    return rows


def window_rows(streams, c: int, device) -> dict:
    rows = {}
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), c),
                        device=device)
    ri = np.ascontiguousarray(scenes.to_ri(streams[:, :FL]))  # (C, 2, fl)
    ri_dev = torch.from_numpy(ri).to(device)
    dec.decode_windows_ri(ri_dev)                                 # warm
    for name, src in (("device_resident", lambda: ri_dev),
                      ("full_h2d", lambda: torch.from_numpy(ri).to(device))):
        common.sync(device)
        t0 = time.perf_counter()
        outs = [dec.decode_windows_ri(src()) for _ in range(HOPS)]
        out = dec.unpack_output(outs[-1])
        dt = (time.perf_counter() - t0) / HOPS
        htod = htod_bytes(lambda: dec.decode_windows_ri(src()), 2, device)
        rows[name] = row(dt, int(out.success.any(axis=-1).sum()), c, htod)
        common.log(f"{name}: {json.dumps(rows[name])}")
    blk = torch.from_numpy(scenes.to_ri(streams[:, :HOP]))
    common.sync(device)
    t0 = time.perf_counter()
    for _ in range(HOPS):
        blk.to(device)
    common.sync(device)
    dt = (time.perf_counter() - t0) / HOPS
    # a traced step copies the block HOPS times, as the timed loop does
    htod = htod_bytes(lambda: [blk.to(device) for _ in range(HOPS)], 2,
                      device)
    rows["h2d_only"] = row(dt, -1, c, None if htod is None else htod / HOPS)
    common.log(f"h2d_only: {json.dumps(rows['h2d_only'])}")
    return rows


def htod_checks(rows: dict, c: int) -> dict:
    """Each row's traced bytes per step within [what it must send, that +
    HTOD_SLACK]: a hop block of f32 (c, 2, hop) or of int16 with c float32
    scales, the full (c, 2, fl) windows, or nothing (device_resident)."""
    block = c * 2 * HOP * 4
    int16 = block // 2 + 4 * c
    need = {"ring_f32": block, "ring_f32_unstaged": block,
            "ring_int16": int16, "ring_multi13": int16,
            "full_h2d": c * 2 * FL * 4, "h2d_only": block,
            "device_resident": 0}
    return {f"{k}_htod_bytes": need[k] <= rows[k]["htod_bytes_per_step"]
            <= need[k] + HTOD_SLACK for k in need}


def main(argv=None) -> int:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--channels", type=int, default=C)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    streams = scenes.ring_streams(args.channels, HOPS)
    rows = {**ring_rows(streams, args.channels, device),
            **window_rows(streams, args.channels, device)}
    ref = common.load_record(REFERENCE)
    both = [k for k in rows if k in ref["rows"] and k != "h2d_only"]
    record = {**common.record_head("ring_ingest", REFERENCE, device),
              "channels": args.channels, "hops_measured": HOPS,
              "snr_db": -18, "rows": rows,
              "vs_reference": {"decoded": common.vs_reference(
                  {k: rows[k]["decoded"] / args.channels for k in both},
                  {k: ref["rows"][k]["decoded"] / ref["channels"]
                   for k in both}, "decoded", args.channels)},
              "exact": {f"{k}_decodes_all": r["decoded"] == args.channels
                        for k, r in rows.items() if k != "h2d_only"}}
    if device.type == "cuda":
        record["exact"].update(htod_checks(rows, args.channels))
    return common.finish(record, args.out, "ring_ingest")


if __name__ == "__main__":
    sys.exit(main())
