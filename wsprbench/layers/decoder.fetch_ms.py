"""decoder.fetch_ms: the median ``uwspr.decoder.fetch`` span of the traced
batches, in ms: ``DeviceDecoder.fetch``'s wait for the card, the copy of
the packed output to the host and its unpacking."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "wsprbench_spans", pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(r, view):
    if view is None:
        return None
    return _spans.median_ms(_spans.spans(view, "decoder.fetch"))
