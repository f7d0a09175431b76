"""subtract.lanes_per_window: the frames the device multipass subtracted,
from the decoder's multipass tally, over the decodes it covers times the
batch's windows. None where the program has no tally."""


def read(r, view):
    n = r.counters.get("mp_decodes")
    if not n:
        return None
    return r.counters["mp_subtracted"] / (n * r.traffic["batch"])
