"""subtract.ms_per_window: device time of the kernels of the decode's
``subtract`` stages (the compaction of a pass's decodes and the
subtraction kernel, between ``uwspr_mark_subtract`` and the next marker,
once between each two passes), over the channel-windows of the traced
requests. None where the trace holds no such stage."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "wsprbench_spans", pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(r, view):
    if view is None or not view.windows:
        return None
    if "subtract" not in _spans.stage_ns(view):
        return None
    return _spans.stages_ms_per_window(view, ("subtract",))
