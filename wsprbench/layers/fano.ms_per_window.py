"""fano.ms_per_window: device time of ``fano_kernel`` in the trace over the
channel-windows of the traced requests."""


def read(r, view):
    if view is None or not view.windows:
        return None
    ks = view.kernels(r"fano_kernel")
    if not ks:
        return None
    return sum(k.end - k.start for k in ks) / 1e6 / view.windows
