"""Driver loop: host batches of windows into ``DeviceDecoder``:
``decode_windows_ri`` (returns once the batch is queued), then ``fetch``
and ``spots`` per window.

Closed loop, two batches in flight: the client submits batch k+1 before it
fetches batch k. A request's latency runs from its ``decode_windows_ri``
call (the batch in host memory) to its spots on the host; the host time
to that call's return is kept apart (``captured.return_ms``). Inputs
cycle through the traffic's pool of batches. Set-up makes the pool,
builds the decoder at the serving point for the batch width and decodes
``WARM_BATCHES`` batches (the first captures the program). The request
checked is a batch of the window drawn from the seed, every window of it
through the reference, ``check.windows`` of them (drawn from the seed)
through the Fano.
"""

from __future__ import annotations

import gc
import time
from collections import deque

import numpy as np
import torch

from wsprbench import gen

WARM_BATCHES = 2


def run(r) -> None:
    from uwspr_tpu_torch.config import with_serving_defaults
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    r.mark("port import")
    t = r.traffic
    W = t["batch"]
    pool = gen.generate(t, r.seed, r.device)["pool"]
    B = pool.shape[0]
    r.mark("traffic")
    r.reset_peak()
    dec = DeviceDecoder(with_serving_defaults(r.pipeline_config(), W),
                        device=r.device)
    for k in range(WARM_BATCHES):
        out = dec.fetch(dec.decode_windows_ri(pool[k % B]))
        [dec.spots(out.window(w)) for w in range(W)]
    r.mark("capture and warm-up")
    r.tracer.prime(r.sync)
    r.sync()

    r.tracer.windows_per_request = W
    inflight = deque()
    outs = []
    submitted = 0

    def submit():
        nonlocal submitted
        ts = time.perf_counter()
        h = dec.decode_windows_ri(pool[submitted % B])
        r.return_s.append(time.perf_counter() - ts)
        inflight.append((ts, submitted % B, h))
        submitted += 1

    def complete():
        ts, b, h = inflight.popleft()
        out = dec.fetch(h)
        for w in range(W):
            dec.spots(out.window(w))
        r.latencies.append(time.perf_counter() - ts)
        outs.append((b, out))
        r.attempted += W
        r.windows_done += W

    r.t_first = time.time()
    t0 = time.perf_counter()
    i = 0
    r.tracer.boundary(i, r.sync)
    submit()
    while time.perf_counter() - t0 < r.seconds:
        submit()
        complete()
        i += 1
        r.tracer.boundary(i, r.sync)
    complete()
    r.window_s = time.perf_counter() - t0
    r.tracer.stop(r.sync, min(i - r.tracer.start, r.tracer.n))
    r.counters["peak_bytes"] = r.peak_bytes()
    r.counters["fano_attempts"] = int(sum(int(o.fano_attempts.sum())
                                          for _, o in outs))
    r.counters["requests"] = len(outs)
    del dec
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng([r.seed & 0xFFFF_FFFF_FFFF_FFFF, 1])
    b, out = outs[int(rng.integers(len(outs)))]
    sample = np.sort(rng.choice(W, t["check"]["windows"], replace=False))
    r.reference().run(r, out, pool[b], sample)
