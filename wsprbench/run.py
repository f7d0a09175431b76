"""Run one cell of the port's benchmark once and print its result line.

    python3 -m wsprbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
are found by name: ``BENCHMARK.json`` names the cell's configuration and
traffic, ``wsprbench/configs/<config>.json`` holds the configuration and
names its reference (``wsprbench/checks/<reference>.py``),
``wsprbench/traffic/<traffic>.json`` holds the traffic's parameters and
names its generator (``wsprbench/generators/<kind>.py``) and its driver
loop (``wsprbench/drivers/<driver>.py``), and each per-layer metric's
reader is ``wsprbench/layers/<metric>.py``. A new cell, configuration,
reference, traffic, generator, driver or metric is a new file and a new
``BENCHMARK.json`` entry.

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from an in-memory ``torch.profiler`` trace of part of the
window. Both check the timed path against the plain reference once the
window has closed. The run needs a CUDA card and the cell's number of
them, and fails without; it keeps every build directory of the program
inside the checkout (``build/``), at fixed paths.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "uwspr_tpu")
LAST_RUN = None     # the Run of the last run_cell, for readings and tests


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux), else
    now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        stat = pathlib.Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


def set_build_env(root: pathlib.Path) -> None:
    """Fixed cache and build directories inside the checkout, and no JAX
    behind ``transformers``-style libraries."""
    b = root / "build"
    os.environ["UWSPR_TORCH_BUILD_DIR"] = str(b / "uwspr_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(b / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(b / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "wsprbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """One run of one cell: what the harness read, and what the driver
    measured. A driver fills ``latencies`` (seconds per request),
    ``window_s``, ``windows_done``, ``attempted``, ``failed``,
    ``counters``, ``t_first`` (the first timed request's start) and, through
    ``reference().run``, ``check`` (the numbers of the checked request);
    ``mark(step)`` after each step of its set-up."""

    def __init__(self, root, cell_name, seed, seconds, trace, device):
        from wsprbench.trace import Tracer
        self.root = pathlib.Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if cell_name not in cells:
            raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
        self.cell = cells[cell_name]
        self.config = load_json(self.root / "wsprbench" / "configs"
                                / f"{self.cell['config']}.json")
        self.traffic = load_json(self.root / "wsprbench" / "traffic"
                                 / f"{self.cell['traffic']}.json")
        self.seed, self.seconds, self.device = seed, seconds, device
        tr = self.traffic["trace"]
        self.tracer = Tracer(bool(trace), tr["start"], tr["requests"])
        self.latencies: list[float] = []
        self.return_s: list[float] = []
        self.window_s = 0.0
        self.windows_done = self.attempted = self.failed = 0
        self.counters: dict = {}
        self.check: dict = {}
        self.t_first = None
        self.marks: list = []
        self.mark("imports")

    def mark(self, step: str) -> None:
        """The end of a step of set-up (printed on stderr)."""
        self.marks.append((step, time.time()))

    def reference(self):
        """The configuration's reference module: ``run(r, out, ri,
        sample)`` checks a request, ``control(r)`` gives its control."""
        return load_module(self.root / "wsprbench" / "checks"
                           / f"{self.config['reference']}.py")

    def pipeline_config(self):
        """The configuration file's "pipeline" as the port's
        PipelineConfig (the drivers pass it through the serving
        defaults, as ``serve`` does)."""
        import dataclasses
        from uwspr_tpu_torch.config import PipelineConfig
        base = PipelineConfig()
        parts = {k: dataclasses.replace(getattr(base, k), **v)
                 for k, v in self.config["pipeline"].items()}
        return dataclasses.replace(base, **parts)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def reset_peak(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)


def quantile(xs, q: float) -> float:
    """The q-th quantile by linear interpolation between order statistics
    (numpy's default)."""
    s = sorted(xs)
    pos = (len(s) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def end_to_end(r: Run, t_start: float) -> dict:
    vals = {
        "windows_per_s": r.windows_done / r.window_s,
        "latency_p50_ms": 1e3 * quantile(r.latencies, 0.5),
        "latency_p90_ms": 1e3 * quantile(r.latencies, 0.9),
        "setup_s": r.t_first - t_start,
    }
    return vals


def per_layer(r: Run) -> dict:
    out = {}
    for m in r.bench["per_layer"]:
        if r.cell["name"] not in m["workloads"]:
            continue
        if m["source"] == "device_trace" and r.device.type != "cuda":
            continue            # no device number from a run off the card
        mod = load_module(r.root / "wsprbench" / "layers"
                          / f"{m['name']}.py")
        v = mod.read(r, r.tracer.view)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def built_s(device) -> float:
    """Seconds this process spent building the port's kernel library: 0
    where it loaded the one a run in this checkout built before. A run
    that builds is a first run, whose ``setup_s`` holds the build."""
    if device.type != "cuda":
        return 0.0
    from uwspr_tpu_torch.utils import cuda_build
    return float(cuda_build.build_info.get("seconds", 0.0))


def run_cell(root, cell: str, seed: int, seconds: float, trace: int,
             device=None, t_start: float | None = None,
             out=sys.stdout, err=sys.stderr, patch=None) -> dict:
    """Set up, measure and check one cell; returns the result object and
    prints it as the last line of ``out``. ``device`` None means the card,
    which must be there. ``patch(run)``, where given, edits the loaded
    configuration and traffic before the driver starts (tests shrink a
    cell with it)."""
    t_start = time.time() if t_start is None else t_start
    import torch
    if device is None:
        n = 0
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
        bench = load_json(pathlib.Path(root) / "BENCHMARK.json")
        need = {w["name"]: w["chips"] for w in bench["workloads"]}.get(cell,
                                                                       1)
        if n < need:
            print(f"wsprbench: the cell needs {need} CUDA device(s), "
                  f"{n} found", file=err)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
    device = torch.device(device)
    r = Run(root, cell, seed, seconds, trace, device)
    if patch is not None:
        patch(r)
    driver = load_module(r.root / "wsprbench" / "drivers"
                         / f"{r.traffic['driver']}.py")
    driver.run(r)
    global LAST_RUN
    LAST_RUN = r
    bad = forbidden_modules()
    if bad:
        print(f"wsprbench: modules loaded that the port must not load: "
              f"{', '.join(bad)}", file=err)
        raise SystemExit(3)
    from wsprbench import compare
    lim = compare.limits(r.root, cell)
    correct, shown = compare.judge(r.check, lim)
    e2e = end_to_end(r, t_start)
    if trace:
        metrics = per_layer(r)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in r.bench["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": r.counters.get("peak_bytes", 0)}
    res = {"correct": bool(correct), "attempted": r.attempted,
           "failed": r.failed, "metrics": metrics, "device": dev}
    if trace and r.tracer.view is not None:
        v = r.tracer.view
        dev["busy_s"] = v.busy_s()
        dev["window_s"] = v.window_s
        res["breakdown"] = v.breakdown()
    res["setup_built_s"] = built_s(device)
    res["checked"] = shown
    steps, last = [], t_start
    for step, t in r.marks:
        steps.append(f"{step} {t - last:.3f}")
        last = t
    steps.append(f"to the first request {r.t_first - last:.3f}")
    print(f"setup_s {e2e['setup_s']:.3f}: {', '.join(steps)}; the kernel "
          f"library built in {res['setup_built_s']:.3f} s", file=err)
    for k, s in shown.items():
        print(f"check {k}: {s['value']} (limit {s['limit']})", file=err)
    print(json.dumps(res), file=out, flush=True)
    return res


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(prog="wsprbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    set_build_env(ROOT)
    sys.path.insert(0, str(ROOT))
    run_cell(ROOT, a.workload, a.seed, a.seconds, a.trace, t_start=t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
