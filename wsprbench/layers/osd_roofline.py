"""osd_roofline: the OSD kernel's share of its population-count roofline,
in %. Operations: the active decodes a launch (two jiggle lanes for each
active rescue lane, from the decoder's OSD tally averaged over the decodes
it covers) times the population counts of a decode at the configuration's
order (``_osd_popc.py``); time: the device time of ``osd_kernel`` a launch
in the trace. None where the program has no tally or the trace no OSD
kernel."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "wsprbench_osd_popc", pathlib.Path(__file__).with_name("_osd_popc.py"))
_popc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_popc)


def read(r, view):
    n = r.counters.get("osd_decodes")
    if view is None or not n:
        return None
    ks = view.kernels(r"osd_kernel")
    if not ks:
        return None
    per_launch_s = sum(k.end - k.start for k in ks) / 1e9 / len(ks)
    order = min(r.config["pipeline"]["demod"]["osd_depth"], 4)
    decodes = 2 * r.counters["osd_active_lanes"] / n
    ops = decodes * _popc.popcounts(order)
    return 100.0 * ops / _popc.POPC_PER_S / per_launch_s
