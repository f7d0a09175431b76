"""captured.return_ms: host clock from a batch's ``decode_windows_ri`` call
to its return, before ``fetch`` (the input copy's queueing and the graph's
replay); the median over the window's requests."""


def read(r, view):
    xs = sorted(r.return_s)
    if not xs:
        return None
    n = len(xs)
    return 1e3 * (xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2)
