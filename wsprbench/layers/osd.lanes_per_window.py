"""osd.lanes_per_window: the rescue lanes the device OSD decoded (the
Fano-failed worth candidates it took, each on two jiggle lanes), from the
decoder's OSD tally, over the decodes it covers times the batch's
windows. None where the program has no tally."""


def read(r, view):
    n = r.counters.get("osd_decodes")
    if not n:
        return None
    return r.counters["osd_active_lanes"] / (n * r.traffic["batch"])
