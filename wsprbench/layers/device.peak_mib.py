"""device.peak_mib: torch.cuda.max_memory_allocated() over the system's
set-up and the window (the traffic's generation left out), in MiB."""


def read(r, view):
    b = r.counters.get("peak_bytes", 0)
    return b / 2 ** 20 if b else None
