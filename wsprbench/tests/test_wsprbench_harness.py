"""The result line, the selection's byte count, the import boundaries and
the harness's refusal to run without a card."""

from __future__ import annotations

import importlib.util
import io
import json
import subprocess
import sys

import pytest

from wsprbench import run as R
from wsprbench.tests.conftest import run_small


def _layer(name: str):
    spec = importlib.util.spec_from_file_location(
        "layer", R.ROOT / "wsprbench" / "layers" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(name: str) -> dict:
    return json.loads((R.ROOT / "wsprbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("config, batch, shape, grid", [
    ("narrowband", 128, (1664, 5, 26, 126), 109_025_280),
    ("wideband", 32, (6400, 5, 26, 126), 419_328_000),
])
def test_selection_bytes_at_the_cells_shapes(config, batch, shape, grid):
    sel = _layer("select_best_roofline")
    shp = sel.shape(_config(config)["pipeline"]["coarse"], batch)
    assert shp == shape
    assert sel.grid_bytes(shp) == grid
    assert sel.bytes_moved(shp) == grid + 126 + shape[0] * 8


def test_result_line_has_the_contracts_keys():
    res, last, err = run_small("narrow_stream_c128")
    obj = json.loads(last)
    assert list(obj)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(obj)[-1] == "checked"
    assert set(obj["metrics"]) == {"windows_per_s", "latency_p50_ms",
                                   "latency_p90_ms", "setup_s"}
    for m in obj["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(obj["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(obj["checked"]):]
    for line, (k, v) in zip(tail, obj["checked"].items()):
        assert line == f"check {k}: {v['value']} (limit {v['limit']})"
    assert obj["correct"] is True


def test_quantile_matches_linear_interpolation():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert R.quantile(xs, 0.5) == 3.0
    assert R.quantile(xs, 0.9) == pytest.approx(4.6)


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=R.ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_the_reference_none_of_the_port():
    mods = _loaded("import wsprbench.run, wsprbench.gen\n"
                   "import wsprbench.readings\n"
                   "from wsprbench.run import ROOT, load_module\n"
                   "for d in ('checks', 'drivers', 'generators', 'layers'):\n"
                   "    for p in sorted((ROOT / 'wsprbench' / d).glob('*.py')):\n"
                   "        load_module(p)\n"
                   "import uwspr_tpu_torch.pipeline.device_ring\n")
    assert not mods & {"jax", "jaxlib", "flax", "uwspr_tpu"}
    ref = _loaded("import wsprbench.reference.decode\n"
                  "import wsprbench.reference.fano\n"
                  "import wsprbench.compare, wsprbench.gen\n"
                  "from wsprbench.run import ROOT, load_module\n"
                  "for p in sorted((ROOT / 'wsprbench' / 'checks')"
                  ".glob('*.py')):\n"
                  "    load_module(p)\n")
    assert not ref & {"jax", "jaxlib", "flax", "uwspr_tpu",
                      "uwspr_tpu_torch"}


def test_no_card_no_result():
    out, err = io.StringIO(), io.StringIO()
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        R.run_cell(R.ROOT, "narrow_stream_c128", 1, 1.0, 0, out=out, err=err)
    assert e.value.code != 0 and out.getvalue() == ""
