"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size, in one process:

    python3 -m wsprbench.readings --workload <cell> --seeds 11,12,... \
        --control 3 --seconds 4

For each seed a short run of the cell (its window at the cell's own load,
then its check) gives the program's numbers, the lower readings; for the
first ``--control`` seeds the control, the reference one precision step
below the configuration's put in the program's place on the same request,
gives the upper readings. One JSON line a reading on standard output, and
the same lines in ``chiprun_out/readings_<cell>.jsonl`` when that
directory exists.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

from wsprbench import run as R


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="wsprbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    a = p.parse_args(argv)
    R.set_build_env(R.ROOT)
    out_dir = R.ROOT / "chiprun_out"
    sink = (open(out_dir / f"readings_{a.workload}.jsonl", "a")
            if out_dir.is_dir() else None)
    for n, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t0 = time.time()
        res = R.run_cell(R.ROOT, a.workload, seed, a.seconds, 0,
                         out=io.StringIO(), err=io.StringIO())
        rows = [{"seed": seed, "side": "program", **R.LAST_RUN.check,
                 "correct": res["correct"],
                 "metrics": {k: v["value"] for k, v in
                             res["metrics"].items()},
                 "seconds": time.time() - t0}]
        if n < a.control:
            t1 = time.time()
            rows.append({"seed": seed, "side": "control",
                         **R.LAST_RUN.reference().control(R.LAST_RUN),
                         "seconds": time.time() - t1})
        for row in rows:
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
        R.LAST_RUN = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
