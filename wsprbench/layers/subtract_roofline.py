"""subtract_roofline: the multipass subtraction kernel's share of its
roofline, in %. Work: the frames a launch subtracts (the decoder's
multipass tally, frames subtracted over its decodes times the passes
between which it subtracts) times one frame's float64 multiply-adds and
bytes at the program's lag search (``_subtract_work.py``); bound:
the larger of the multiply-adds at the card's float64 rate and the bytes
at its HBM rate; time: the device time of ``subtract_lanes_kernel`` a
launch in the trace. None where the program has no tally or the trace no
subtraction kernel."""

import importlib.util
import pathlib


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "wsprbench_" + name.lstrip("_"),
        pathlib.Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_work = _load("_subtract_work")
_peaks = _load("_peaks")


def read(r, view):
    n = r.counters.get("mp_decodes")
    mp = r.config["pipeline"].get("multipass")
    if view is None or not n or not mp or mp["passes"] < 2:
        return None
    ks = view.kernels(r"subtract_lanes_kernel")
    if not ks:
        return None
    per_launch_s = sum(k.end - k.start for k in ks) / 1e9 / len(ks)
    frames = r.counters["mp_subtracted"] / (n * (mp["passes"] - 1))
    bound_s = frames * max(
        _work.fmas() / _work.DFMA_PER_S,
        _work.BYTES_PER_FRAME / _peaks.HBM_BYTES_PER_S)
    return 100.0 * bound_s / per_launch_s
