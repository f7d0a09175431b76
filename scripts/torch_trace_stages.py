#!/usr/bin/env python3
"""One traced run of a benchmark cell, and what the port's host spans and
stage markers show in its trace.

    python3 scripts/torch_trace_stages.py --workload narrow_stream_c128 \
        --seed 3000000001 --seconds 30 [--out DIR]

from the root of a checkout, on one CUDA card. Runs the cell as
``python3 -m wsprbench.run ... --trace 1`` does (its result line is printed
first), then reads the run's in-memory trace (``wsprbench.run.LAST_RUN``)
and prints a JSON line:

- ``stages_ms_per_window``: by stage of ``ops/marks.py::STAGES``, the
  device ms a channel-window of the kernels between the stage's marker and
  the next, split into the kernels ``grid_refine.ms_per_window`` counts
  (``grid_refine``) and the Fano, selection and OSD kernels (``named``);
  ``none`` holds the kernels outside every stage (the ring's eager shift)
  and ``marks`` the markers themselves, so that the ``grid_refine`` parts
  add up to that metric;
- ``marks_us_per_batch``: the markers' device time a replay;
- ``idle``: the traced window's idle share, the share of its idle time
  that lies inside some ``uwspr.`` host span, and the idle ms by the
  innermost ``uwspr.`` span, and by the innermost host op, over each
  instant of it;
- ``spans_ms``: the traced ``uwspr.`` spans by name: count, median and
  total ms;
- ``latency_ms``: the median request latency of the traced requests and
  of the others of the same window (what tracing adds to a request), and
  the window's end-to-end metrics;
- ``span_check_ns``: the host cost of one span with no profiler running;
- ``fano_tally``: ``DeviceDecoder.fano_tally`` summed over the run's
  decoders (warm-up and untimed requests included): the decodes that ran
  the one-launch Fano over every jiggle, the speculative lanes (gated
  jiggles >= 1 of candidates whose jiggle 0 decoded, which two phases
  would not walk), how many of them stopped early and the forward looks
  they spent, the last three also per decode;
- ``osd_tally``: where the cell's driver puts the device OSD's tally in
  its counters (``decode_batches_osd``: ``osd_<name>`` for each name of
  ``OSD_TALLY``), those counts: the decodes that ran the device OSD, the
  rescue lanes it decoded, those accepted by margin and by agreement
  alone, and those dropped over ``osd_max_lanes``, the last four also per
  decode; else None.

With ``--out`` the JSON is also appended to DIR/trace_stages.jsonl.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMED = re.compile(r"(fano_kernel|select_best_kernel|osd_kernel)")
MARK = re.compile(r"uwspr_mark_(\w+)")


def stage_split(view) -> tuple[dict, float]:
    """({stage: {"grid_refine": ms/window, "named": ms/window}}, markers'
    us a replay)."""
    ns, cur, marks_ns, ends = {}, "none", 0, 0
    for k in sorted(view.kernels(), key=lambda k: k.start):
        d = k.end - k.start
        m = MARK.search(k.name)
        if m:
            marks_ns += d
            ends += m.group(1) == "end"
            cur = "none" if m.group(1) == "end" else m.group(1)
            continue
        part = ns.setdefault(cur, {"grid_refine": 0, "named": 0})
        part["named" if NAMED.search(k.name) else "grid_refine"] += d
    out = {s: {k: v / 1e6 / view.windows for k, v in p.items()}
           for s, p in ns.items()}
    out["marks"] = {"grid_refine": marks_ns / 1e6 / view.windows,
                    "named": 0.0}
    return out, (marks_ns / 1e3 / ends if ends else 0.0)


def innermost_ms(gaps: list, ranges: list) -> dict:
    """Idle ms by the innermost (shortest) of ``ranges`` (name, start,
    end) that covers each instant of the ``gaps`` (disjoint), exactly: one
    sweep over the ranges' and gaps' ends."""
    ends = [(s, 1, (e - s, n)) for n, s, e in ranges]
    ends += [(e, 0, (e - s, n)) for n, s, e in ranges]
    ends += [t for a, b in gaps for t in ((a, 2, None), (b, 3, None))]
    ends.sort(key=lambda x: x[0])
    active, by, in_gap, last = Counter(), {}, False, None
    for t, kind, key in ends:
        if in_gap and t > last:
            name = min(active)[1] if active else "none"
            by[name] = by.get(name, 0) + (t - last) / 1e6
        last = t
        if kind == 1:
            active[key] += 1
        elif kind == 0:
            active[key] -= 1
            if not active[key]:
                del active[key]
        else:
            in_gap = kind == 2
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def idle_cover(view) -> dict:
    """The idle share, the share of idle time inside some ``uwspr.`` span,
    and the idle ms by innermost ``uwspr.`` span and by innermost host op
    (a span, or an op or runtime call of the host)."""
    from wsprbench.trace import RANGE
    spans = [h for h in view.host if h[0].startswith("uwspr.")]
    gaps = view.gaps()
    idle = sum(b - a for a, b in gaps)
    by_span = innermost_ms(gaps, spans)
    inside = idle / 1e6 - by_span.get("none", 0.0)
    return {"idle_share": idle / (view.t1 - view.t0),
            "idle_ms": idle / 1e6,
            "inside_uwspr_share": inside * 1e6 / idle if idle else None,
            "idle_ms_by_innermost_span": by_span,
            "idle_ms_by_innermost_op": dict(list(innermost_ms(
                gaps, [h for h in view.host if h[0] != RANGE]).items())[:12])}


def spans_ms(view) -> dict:
    by = {}
    for n, s, e in view.host:
        if n.startswith("uwspr.") and view.t0 <= s and e <= view.t1:
            by.setdefault(n, []).append((e - s) / 1e6)
    return {n: {"count": len(v), "median_ms": statistics.median(v),
                "total_ms": sum(v)} for n, v in sorted(by.items())}


def span_check_ns(reps: int = 200_000) -> float:
    from uwspr_tpu_torch.utils.profiler import span
    t0 = time.perf_counter()
    for i in range(reps):
        with span("decoder.spots", i):
            pass
    return (time.perf_counter() - t0) / reps * 1e9


@contextlib.contextmanager
def fano_tallies():
    """Yields a list that gathers the ``fano_counts`` tensor of every
    DeviceDecoder built inside the block (the tensor alone is kept: the
    decoder is freed as the run frees it). The harness's drivers keep no
    handle on the decoder they build, so the block wraps the class's
    constructor, and puts it back on leaving."""
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    kept, init = [], DeviceDecoder.__init__

    def keeping(self, *a, **k):
        init(self, *a, **k)
        kept.append(self.fano_counts)
    DeviceDecoder.__init__ = keeping
    try:
        yield kept
    finally:
        DeviceDecoder.__init__ = init


def fano_tally(kept: list) -> dict:
    """The tallies of ``fano_tallies`` summed, and per decode."""
    import torch
    from uwspr_tpu_torch.pipeline.device_decoder import FANO_TALLY
    total = dict(zip(FANO_TALLY, map(int, sum(
        (t.cpu() for t in kept),
        torch.zeros(len(FANO_TALLY), dtype=torch.int64)))))
    n = max(total["decodes"], 1)
    return {**total, **{f"{k}_per_decode": v / n for k, v in total.items()
                        if k != "decodes"}}


def osd_tally(counters: dict) -> dict | None:
    """The ``osd_*`` counters a cell's driver loop puts in ``r.counters``,
    by tally name, and per decode."""
    total = {k[4:]: v for k, v in counters.items() if k.startswith("osd_")}
    if not total:
        return None
    n = max(total["decodes"], 1)
    return {**total, **{f"{k}_per_decode": v / n for k, v in total.items()
                        if k != "decodes"}}


def main(argv=None) -> int:
    from wsprbench import run as R
    t_start = R.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    R.set_build_env(R.ROOT)
    with fano_tallies() as tallies:
        res = R.run_cell(R.ROOT, a.workload, a.seed, a.seconds, 1,
                         t_start=t_start)
    r = R.LAST_RUN
    view = r.tracer.view
    stages, marks_us = stage_split(view)
    tr = r.tracer
    traced = r.latencies[tr.start:tr.start + view.requests]
    rest = r.latencies[:tr.start] + r.latencies[tr.start + view.requests:]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {
        "workload": a.workload, "seed": a.seed, "card": card,
        "correct": res["correct"],
        "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "stages_ms_per_window": stages,
        "grid_refine_sum": sum(p["grid_refine"] for p in stages.values()),
        "marks_us_per_batch": marks_us,
        "idle": idle_cover(view),
        "breakdown_idle_gaps": res.get("breakdown", {}).get("idle_gaps"),
        "spans_ms": spans_ms(view),
        "latency_ms": {
            "traced_median": 1e3 * statistics.median(traced),
            "untraced_median": 1e3 * statistics.median(rest),
            "traced_requests": len(traced),
            "end_to_end": R.end_to_end(r, t_start)},
        "span_check_ns": span_check_ns(),
        "fano_tally": fano_tally(tallies),
        "osd_tally": osd_tally(r.counters),
    }
    line = json.dumps(out)
    print(line, flush=True)
    if a.out:
        d = pathlib.Path(a.out)
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "trace_stages.jsonl", "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
