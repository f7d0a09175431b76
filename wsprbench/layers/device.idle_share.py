"""device.idle_share: 1 - (union of kernel, copy and set intervals) / wall
time of the traced requests."""


def read(r, view):
    if view is None or view.window_s <= 0:
        return None
    return 1.0 - view.busy_s() / view.window_s
