"""later_passes.ms_per_window: device time of the kernels from a decode's
first ``uwspr_mark_subtract`` to its ``uwspr_mark_pack`` (every
subtraction and every pass after the first, the markers left out), over
the channel-windows of the traced requests: the share of a batch that the
multipass adds. None where the trace holds no subtraction marker."""

import re

_MARK = re.compile(r"uwspr_mark_(\w+)")


def read(r, view):
    if view is None or not view.windows:
        return None
    ns, seen, inside = 0, False, False
    for k in sorted(view.kernels(), key=lambda k: k.start):
        m = _MARK.search(k.name)
        if m:
            stage = m.group(1)
            if stage == "subtract":
                seen = inside = True
            elif stage in ("pack", "end"):
                inside = False
        elif inside:
            ns += k.end - k.start
    if not seen:
        return None
    return ns / 1e6 / view.windows
