"""grid.ms_per_window: device time of the kernels of the decode's ``stft``
and ``coarse`` stages (the STFT power, the smoothed spectrum, the peak pick
and the sync grid), between their marker kernels, over the channel-windows
of the traced requests."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "wsprbench_spans", pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(r, view):
    return _spans.stages_ms_per_window(view, ("stft", "coarse"))
