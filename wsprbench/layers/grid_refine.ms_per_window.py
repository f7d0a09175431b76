"""grid_refine.ms_per_window: device time of every kernel but the Fano, the
selection and the OSD (copies and sets left out): the STFT, the coarse
grid, the refinement, the soft symbols and the packing, over the
channel-windows of the traced requests."""

import re

_OTHERS = re.compile(r"(fano_kernel|select_best_kernel|osd_kernel)")


def read(r, view):
    if view is None or not view.windows:
        return None
    ks = [k for k in view.kernels() if not _OTHERS.search(k.name)]
    if not ks:
        return None
    return sum(k.end - k.start for k in ks) / 1e6 / view.windows
