"""ring.host_ms_per_hop: host ms of ``RingServe.push`` a hop without its
wait for the card: the ``uwspr.ring.push`` spans of the traced hops less
the ``uwspr.decoder.fetch`` spans inside them, over those hops (the
buffer, the block's conversion and upload, the shift, the submit and the
per-channel results)."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "wsprbench_spans", pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(r, view):
    if view is None:
        return None
    pushes = _spans.spans(view, "ring.push")
    if not pushes:
        return None
    fetches = _spans.inside(pushes, _spans.spans(view, "decoder.fetch"))
    host = (sum(e - s for s, e in pushes) - sum(e - s for s, e in fetches))
    return host / 1e6 / len(pushes)
