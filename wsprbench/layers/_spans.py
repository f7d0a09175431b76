"""What the port's host spans and stage markers give a reader: the
``uwspr.<name>`` host ranges inside the traced range, the ranges that lie
inside others, and the device time of the kernels of each stage of the
decode, where a stage runs from its marker kernel (``uwspr_mark_<stage>``)
to the next marker and ``uwspr_mark_end`` closes the last. A program
without spans or markers gives none, and its readers return None."""

import re

MARK = re.compile(r"uwspr_mark_(\w+)")


def spans(view, name: str) -> list:
    """(start, end) ns of the host ranges ``uwspr.<name>`` inside the
    traced range."""
    full = "uwspr." + name
    return [(s, e) for n, s, e in view.host
            if n == full and view.t0 <= s and e <= view.t1]


def inside(outer: list, inner: list) -> list:
    """The intervals of ``inner`` that lie inside some interval of
    ``outer``."""
    return [i for i in inner
            if any(o[0] <= i[0] and i[1] <= o[1] for o in outer)]


def median_ms(intervals: list):
    """The median duration of the intervals in ms, or None for none."""
    xs = sorted(e - s for s, e in intervals)
    if not xs:
        return None
    n = len(xs)
    mid = xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2
    return mid / 1e6


def stage_ns(view) -> dict:
    """Device ns of the kernels (the markers left out) of each stage, by
    stage; kernels before the first marker or after an ``end`` belong to
    none."""
    out, cur = {}, None
    for k in sorted(view.kernels(), key=lambda k: k.start):
        m = MARK.search(k.name)
        if m:
            cur = None if m.group(1) == "end" else m.group(1)
        elif cur is not None:
            out[cur] = out.get(cur, 0) + (k.end - k.start)
    return out


def stages_ms_per_window(view, stages: tuple):
    """Device ms of the kernels of ``stages`` over the traced
    channel-windows, or None where the trace holds no marker."""
    if view is None or not view.windows:
        return None
    ns = stage_ns(view)
    if not ns:
        return None
    return sum(ns.get(s, 0) for s in stages) / 1e6 / view.windows
