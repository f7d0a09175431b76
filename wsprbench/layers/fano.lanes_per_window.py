"""fano.lanes_per_window: the gated (candidate, jiggle) lanes the Fano took,
the program's ``fano_attempts`` summed over the window's requests, over
the channel-windows completed."""


def read(r, view):
    if not r.windows_done:
        return None
    return r.counters.get("fano_attempts", 0) / r.windows_done
