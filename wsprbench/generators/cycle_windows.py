"""Traffic kind ``cycle_windows``: ``pool_batches`` batches of ``batch``
cycle-aligned windows, each holding ``signals`` frames at slots spread
evenly over +-``slot_span_hz`` with +-``jitter_hz`` of jitter, starts
uniform in [0, ``start_max``) and distinct messages, in AWGN at
``snr_db``."""

from __future__ import annotations

import numpy as np
import torch

from wsprbench import gen
from wsprbench.gen import CHUNK, FL, P


def generate(t: dict, seed: int, device: torch.device) -> dict:
    """A ``cycle_windows`` traffic file -> {"pool": (B, W, 2, fl) float32 on
    the host}."""
    rng, g = gen.rngs(seed, device)
    B, W, S = t["pool_batches"], t["batch"], t["signals"]
    texts, _, syms = gen.message_table()
    n = B * W
    base = np.linspace(-t["slot_span_hz"], t["slot_span_hz"], S)
    freq = base[None, :] + rng.uniform(-t["jitter_hz"], t["jitter_hz"],
                                       (n, S))
    start = rng.integers(0, t["start_max"], (n, S))
    msg = np.stack([rng.choice(len(texts), S, replace=False)
                    for _ in range(n)])
    pool = gen.noise_sigma(t["snr_db"]) * torch.randn(
        (n, 2, FL), generator=g, device=device)
    if int(start.max()) + P.FRAME_SAMPLES > FL:
        raise ValueError("a frame runs past its window")
    flat_pool = pool.view(-1)
    win = np.repeat(np.arange(n), S)
    msg_f, freq_f, start_f = msg.reshape(-1), freq.reshape(-1), \
        start.reshape(-1)
    span = torch.arange(P.FRAME_SAMPLES, device=device)
    for a in range(0, n * S, CHUNK):
        sl = slice(a, a + CHUNK)
        frames = gen.synth_frames(syms[msg_f[sl]], freq_f[sl], device)
        w = torch.as_tensor(win[sl], device=device)[:, None]
        s0 = torch.as_tensor(start_f[sl], device=device)[:, None]
        for ri in range(2):
            flat_pool.index_add_(0, ((w * 2 + ri) * FL + s0 + span)
                                 .reshape(-1), frames[:, ri].reshape(-1))
    return {"pool": pool.reshape(B, W, 2, FL).cpu().numpy()}
