"""select_best_roofline: the selection kernel's share of its HBM roofline,
in %. Bytes from the configuration's own shapes, whatever implements the
selection: the (W*C, 5, 26, M) float32 grid read once, the M-byte model
bank and the (W*C,) float32 best and int32 index written. Time: the
device time of ``select_best_kernel`` a launch in the trace."""

import math

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "wsprbench_peaks", pathlib.Path(__file__).with_name("_peaks.py"))
_peaks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_peaks)


def shape(coarse: dict, batch: int) -> tuple:
    """(lanes, 5, 26, models) of a batch under the configuration's coarse
    search."""
    df = coarse["fs"] / (2 * coarse["spb"])
    hpbm = math.ceil(coarse["halfbandwidth"] / df)
    C = min(coarse["maxfreqs"], (2 * hpbm - 1) // 2)
    M = (2 * coarse["maxdrift"] + 1) + (125 if coarse["search_nonlinear"]
                                        else 0)
    return batch * C, 5, 26, M


def grid_bytes(shp: tuple) -> int:
    L, F, K, M = shp
    return L * F * K * M * 4


def bytes_moved(shp: tuple) -> int:
    L, _, _, M = shp
    return grid_bytes(shp) + M + L * (4 + 4)


def read(r, view):
    if view is None:
        return None
    ks = view.kernels(r"select_best_kernel")
    if not ks:
        return None
    per_launch_s = sum(k.end - k.start for k in ks) / 1e9 / len(ks)
    shp = shape(r.config["pipeline"]["coarse"], view.windows // view.requests)
    return 100.0 * bytes_moved(shp) / _peaks.HBM_BYTES_PER_S / per_launch_s
