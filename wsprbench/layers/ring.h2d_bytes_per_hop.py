"""ring.h2d_bytes_per_hop: host-to-device copy bytes in the trace over the
traced hops (the hop block itself is channels x 2 x hop x 4 bytes)."""


def read(r, view):
    if view is None or not view.requests:
        return None
    b = sum(v for k, v in view.copy_bytes().items() if "HtoD" in k)
    return b / view.requests if b else None
