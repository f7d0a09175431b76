"""osd.ms_per_window: device time of the kernels of the decode's ``osd``
stage (the rescue's compaction, the OSD kernel and the acceptance), between
its marker kernel and the next, over the channel-windows of the traced
requests."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "wsprbench_spans", pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(r, view):
    return _spans.stages_ms_per_window(view, ("osd",))
