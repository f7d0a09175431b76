"""What every harness shares: the card's identity, the batch timer, the
record writer and the comparison with the reference's records.

Tolerance of ``vs_reference`` (the records hold rates, not trials): a point
passes when the port's count of decoded trials is within ``POINT_TOL`` of
the record's, a curve when the sum of its absolute differences is at most
``CURVE_TOL`` trials. A decode rate is a property of the algorithm, not of
the chip, and the trial windows are bitwise the reference's, so the port
reproduces each rate to within a trial or two (bf16 rounding and another
summation order can flip a trial at the knee of the curve). The times in
the reference's records are a TPU's and are never compared.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
RESULTS = ROOT / "torch_results"
POINT_TOL = 2           # decoded trials, per point
CURVE_TOL = 4           # decoded trials, summed over a curve's points


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_identity(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[device.index or 0].strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Batch:
    """One timed batch: the last packed output, the host seconds per
    decode (ending on a synchronise), the card's seconds per decode by
    CUDA events (None on the CPU) and the first decode's seconds."""

    out: torch.Tensor
    seconds: float
    event_seconds: float | None
    first_seconds: float


def timed_batch(decoder, ri: torch.Tensor, reps: int = 3) -> Batch:
    """Counterpart of scripts/bench_matrix.py:63-87: decode once to warm,
    then time ``reps`` decodes of ``ri``, a batch already on the decoder's
    device, by CUDA events and the host clock, ending on
    ``torch.cuda.synchronize()``."""
    return timed_call(lambda: decoder.decode_windows_ri(ri), decoder.device,
                      reps)


def timed_call(fn, dev: torch.device, reps: int = 3) -> Batch:
    """``timed_batch``'s discipline for any call whose work runs on
    ``dev``: once to warm, then ``reps`` calls timed by CUDA events and the
    host clock, ending on ``torch.cuda.synchronize()``."""
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    first = time.perf_counter() - t0
    log(f"  first call: {first:.2f} s")
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    if dev.type == "cuda":
        end.record()
    sync(dev)
    wall = (time.perf_counter() - t0) / reps
    ev = start.elapsed_time(end) / 1e3 / reps if dev.type == "cuda" else None
    return Batch(out, wall, ev, first)


def load_record(name: str) -> dict:
    """One of the reference's records at the repository's root, read as
    JSON."""
    return json.loads((ROOT / name).read_text())


def point(snr: float) -> str:
    """The key of an SNR point, as SweepResult.as_dict writes it."""
    return f"{snr:g}"


def vs_reference(rates: dict, record: dict, key: str, trials: int) -> dict:
    """The port's rates against the reference's, point by point.

    rates and record map a point (``point(snr)``) to a decode rate; every
    point of ``rates`` must be in ``record``, whose other points are not
    compared (a run of a subset). Rates become counts of ``trials``."""
    points = {}
    for p, rate in rates.items():
        if p not in record:
            raise KeyError(f"{key}: point {p} is not in the reference's "
                           f"record (points {sorted(record)})")
        port, ref = round(rate * trials), round(record[p] * trials)
        points[p] = {"port": port, "reference": ref, "diff": port - ref,
                     "pass": abs(port - ref) <= POINT_TOL}
    total = sum(abs(v["diff"]) for v in points.values())
    return {"key": key, "trials": trials, "points": points,
            "sum_abs_diff": total, "point_tol": POINT_TOL,
            "curve_tol": CURVE_TOL,
            "pass": all(v["pass"] for v in points.values())
            and total <= CURVE_TOL}


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; nothing falls back")
    p.add_argument("--out", default=str(RESULTS),
                   help="directory of the record (default torch_results/)")
    return p


def record_head(harness: str, reference: str, device: torch.device) -> dict:
    return {"harness": f"uwspr_tpu_torch/harness/{harness}.py",
            "reference": reference, "card": card_identity(device),
            "device": str(device),
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "torch": torch.__version__}


def finish(record: dict, out_dir: str, name: str) -> int:
    """Fill the record's ``pass`` from the ``vs_reference`` blocks and
    ``exact`` checks of the record and of each of its ``rows``, write
    ``<out_dir>/<name>.json`` and return the exit code: 0 when everything
    passed, else 1 (the record is written either way, failures named on
    stderr)."""
    rows = record.get("rows", [])
    failed = []
    for where in [record, *(rows.values() if isinstance(rows, dict)
                            else rows)]:
        tag = f"{where['config']}: " if "config" in where else ""
        failed += [f"{tag}vs_reference {k}"
                   for k, b in where.get("vs_reference", {}).items()
                   if not b["pass"]]
        failed += [f"{tag}exact {k}"
                   for k, ok in where.get("exact", {}).items() if not ok]
    record["pass"] = not failed
    path = pathlib.Path(out_dir) / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1) + "\n")
    log(f"wrote {path}; pass={record['pass']}"
        + (f"; failed: {', '.join(failed)}" if failed else ""))
    return 0 if not failed else 1


__all__ = ["Batch", "CURVE_TOL", "POINT_TOL", "RESULTS", "ROOT",
           "card_identity", "finish", "load_record", "log",
           "parser", "point", "record_head", "sync", "timed_batch",
           "timed_call", "vs_reference"]
