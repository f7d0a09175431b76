"""The readers of the port's host spans and stage markers, on synthetic
trace views: nested spans, markers with kernels between them, and a trace
without them (a program that has none), which gives None."""

from __future__ import annotations

import importlib.util

import pytest

from wsprbench import run as R
from wsprbench.trace import RANGE, DeviceEvent, TraceView


def _layer(name: str):
    spec = importlib.util.spec_from_file_location(
        "layer", R.ROOT / "wsprbench" / "layers" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MS = 1_000_000          # ns


def ring_view(with_spans=True):
    """Two traced hops of 4 channel-windows: each push 100 ms, holding a
    fetch (60 ms, then 70 ms); one push and one fetch outside the range."""
    host = [(RANGE, 0, 1000 * MS),
            ("uwspr.ring.push", -150 * MS, -50 * MS),
            ("uwspr.decoder.fetch", -120 * MS, -60 * MS)]
    for k, fetch in enumerate((60, 70)):
        t = 200 * MS + k * 300 * MS
        host += [("uwspr.ring.push", t, t + 100 * MS),
                 ("uwspr.ring.buffer", t + MS, t + 2 * MS),
                 ("uwspr.ring.push_hop", t + 2 * MS, t + 10 * MS),
                 ("uwspr.decoder.submit", t + 3 * MS, t + 9 * MS),
                 ("uwspr.decoder.fetch", t + 10 * MS,
                  t + (10 + fetch) * MS),
                 ("aten::copy_", t + 12 * MS, t + 14 * MS),
                 ("uwspr.ring.results", t + 80 * MS, t + 99 * MS)]
    if not with_spans:
        host = [h for h in host if not h[0].startswith("uwspr.")]
    return TraceView(0, 1000 * MS, 2, 8, [], host)


def kernel(name, start, dur):
    return DeviceEvent(name, start, start + dur)


def staged_view(with_marks=True):
    """Two replays of a 2-window batch: markers and the kernels between
    them; an eager kernel before the first marker and one after each
    end, which belong to no stage."""
    ev, t = [kernel("CatArrayBatchedCopy", 0, 5)], 10
    times = {"stft": 40, "coarse": 60, "select": 7, "compact": 3,
             "refine": 20, "prefano_tail": 10, "fano1": 100, "pack": 2}
    for _ in range(2):
        for stage, dur in times.items():
            ev.append(kernel(f"uwspr_mark_{stage}", t, 1))
            ev.append(kernel("some_kernel(float*)", t + 1, dur))
            ev.append(kernel("Memcpy DtoD (Device -> Device)", t + 1 + dur,
                             4))
            t += dur + 6
        ev.append(kernel("uwspr_mark_end", t, 1))
        ev.append(kernel("CatArrayBatchedCopy", t + 2, 50))
        t += 60
    if not with_marks:
        ev = [e for e in ev if not e.name.startswith("uwspr_mark_")]
    return TraceView(0, t, 2, 4, ev, [])


def test_ring_host_ms_per_hop_leaves_out_the_fetch():
    read = _layer("ring.host_ms_per_hop").read
    # (100 - 60) + (100 - 70) ms over two hops; the push outside the
    # range and its fetch left out
    assert read(None, ring_view()) == pytest.approx(35.0)
    assert read(None, ring_view(with_spans=False)) is None
    assert read(None, None) is None


def test_fetch_and_load_medians():
    fetch = _layer("decoder.fetch_ms").read
    load = _layer("captured.load_ms").read
    view = ring_view()
    assert fetch(None, view) == pytest.approx(65.0)
    assert load(None, view) is None
    view.host += [("uwspr.captured.load", t, t + d * MS)
                  for t, d in ((10 * MS, 2), (30 * MS, 5), (50 * MS, 3))]
    assert load(None, view) == pytest.approx(3.0)
    assert fetch(None, ring_view(with_spans=False)) is None


def test_grid_and_refine_split_by_markers():
    grid = _layer("grid.ms_per_window").read
    refine = _layer("refine.ms_per_window").read
    view = staged_view()
    # two replays over 4 channel-windows; copies, markers and the kernels
    # outside a stage left out
    assert grid(None, view) == pytest.approx(2 * (40 + 60) / 1e6 / 4)
    assert refine(None, view) == pytest.approx(2 * (3 + 20 + 10) / 1e6 / 4)
    whole = _layer("grid_refine.ms_per_window").read(None, view)
    assert grid(None, view) + refine(None, view) < whole
    assert grid(None, staged_view(with_marks=False)) is None
    assert refine(None, staged_view(with_marks=False)) is None
    assert grid(None, None) is None
