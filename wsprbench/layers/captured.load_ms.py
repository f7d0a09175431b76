"""captured.load_ms: the median ``uwspr.captured.load`` span of the traced
batches, in ms: the host's copy of a batch into pinned memory and the
queueing of its copy into the captured graph's static input."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "wsprbench_spans", pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(r, view):
    if view is None:
        return None
    return _spans.median_ms(_spans.spans(view, "captured.load"))
