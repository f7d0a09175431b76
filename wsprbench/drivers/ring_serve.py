"""Driver loop: a continuous multichannel stream into ``RingServe.push``,
the object behind ``uwspr-torch serve --runtime ring``, with
``DeviceRingDecoder`` beneath it.

Closed loop, one hop in flight: each request pushes one hop's block of
every channel (complex64, from host memory) and takes back that hop's
spots; its latency runs from the push to the spots on the host. Set-up
makes the stream, builds the server and fills the ring (the first hop
that decodes captures the decode), then pushes ``WARM_HOPS`` more. The
request checked is a hop of the window drawn from the seed: every window
of it through the reference up to the Fano, and ``check.windows`` of its
channels, drawn from the seed, through the Fano too.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from wsprbench import gen

WARM_HOPS = 2


def ring_windows(stream: np.ndarray, pushes: int, hop: int, fl: int
                 ) -> np.ndarray:
    """The (C, 2, fl) float32 windows a ring holds after ``pushes`` hops of
    the periodic stream: its newest fl samples."""
    N = stream.shape[1]
    idx = (pushes * hop - fl + np.arange(fl)) % N
    z = stream[:, idx]
    return np.stack([z.real, z.imag], axis=1).astype(np.float32)


def run(r) -> None:
    from uwspr_tpu_torch.pipeline.device_ring import RingServe
    r.mark("port import")
    t = r.traffic
    C, hop = t["channels"], t["hop_samples"]
    data = gen.generate(t, r.seed, r.device)
    stream, N = data["stream"], data["period"]
    n_hops = N // hop
    r.mark("traffic")
    r.reset_peak()
    serve = RingServe(r.pipeline_config(), n_channels=C, device=r.device,
                      apply_serving_defaults=True)
    fl = serve.ring.fl
    last = {}
    fetch = serve.ring.fetch

    def recording_fetch(h):
        last["out"] = fetch(h)
        return last["out"]
    serve.ring.fetch = recording_fetch

    pushes = 0

    def push():
        nonlocal pushes
        k = pushes % n_hops
        res = serve.push(stream[:, k * hop:(k + 1) * hop])
        pushes += 1
        return res
    while not push():
        pass
    r.mark("prefill and capture")
    for _ in range(WARM_HOPS):
        push()
    r.tracer.prime(r.sync)
    r.sync()
    r.mark("warm-up")

    r.tracer.windows_per_request = C
    outs = []
    r.t_first = time.time()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < r.seconds:
        r.tracer.boundary(i, r.sync)
        ts = time.perf_counter()
        res = push()
        r.latencies.append(time.perf_counter() - ts)
        outs.append((pushes, last["out"]))
        r.attempted += C
        r.failed += C - len(res)
        r.windows_done += len(res)
        i += 1
    r.window_s = time.perf_counter() - t0
    r.tracer.stop(r.sync, min(i - r.tracer.start, r.tracer.n))
    r.counters["peak_bytes"] = r.peak_bytes()
    r.counters["fano_attempts"] = int(sum(int(o.fano_attempts.sum())
                                          for _, o in outs))
    r.counters["requests"] = len(outs)
    del serve, fetch
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng([r.seed & 0xFFFF_FFFF_FFFF_FFFF, 1])
    n_at, out = outs[int(rng.integers(len(outs)))]
    sample = np.sort(rng.choice(C, t["check"]["windows"], replace=False))
    ri = ring_windows(stream, n_at, hop, fl)
    r.reference().run(r, out, ri, sample)
