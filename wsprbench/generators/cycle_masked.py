"""Traffic kind ``cycle_masked``: ``pool_batches`` batches of ``batch``
cycle-aligned windows, each holding a strong frame and a weak one close
beside it, the case successive cancellation exists for. The strong frame
sits at ``strong_snr_db`` with its offset uniform in +-``jitter_hz``; the
weak one ``weak_rel_db`` below it, offset from it by a separation uniform
in [``sep_min_hz``, ``sep_max_hz``] on a side drawn from the seed. Each
frame starts uniform in [0, ``start_max``) on its own, the two carry
distinct messages, and the AWGN is set by the strong frame's SNR
(``gen.noise_sigma``). The draws come in a fixed order from the seed, so
the same seed gives the same pool; the sent frames are returned with it
(``frames``: window, message index, offset, start, strong or weak)."""

from __future__ import annotations

import numpy as np
import torch

from wsprbench import gen
from wsprbench.gen import CHUNK, FL, P


def generate(t: dict, seed: int, device: torch.device) -> dict:
    """A ``cycle_masked`` traffic file -> {"pool": (B, W, 2, fl) float32 on
    the host, "frames": the sent frames, two a window}."""
    rng, g = gen.rngs(seed, device)
    B, W = t["pool_batches"], t["batch"]
    n = B * W
    texts, _, syms = gen.message_table()
    strong_f = rng.uniform(-t["jitter_hz"], t["jitter_hz"], n)
    side = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    weak_f = strong_f + side * rng.uniform(t["sep_min_hz"], t["sep_max_hz"],
                                           n)
    start = rng.integers(0, t["start_max"], (n, 2))
    msg = np.stack([rng.choice(len(texts), 2, replace=False)
                    for _ in range(n)])
    if int(start.max()) + P.FRAME_SAMPLES > FL:
        raise ValueError("a frame runs past its window")
    pool = gen.noise_sigma(t["strong_snr_db"]) * torch.randn(
        (n, 2, FL), generator=g, device=device)
    flat_pool = pool.view(-1)
    # frame k of window w at 2 w + k: k 0 the strong one, 1 the weak one
    win = np.repeat(np.arange(n), 2)
    freq = np.stack([strong_f, weak_f], axis=1).reshape(-1)
    amp = np.tile([1.0, 10.0 ** (t["weak_rel_db"] / 20.0)], n)
    msg_f, start_f = msg.reshape(-1), start.reshape(-1)
    span = torch.arange(P.FRAME_SAMPLES, device=device)
    for a in range(0, 2 * n, CHUNK):
        sl = slice(a, a + CHUNK)
        frames = gen.synth_frames(syms[msg_f[sl]], freq[sl], device)
        frames *= torch.as_tensor(amp[sl], dtype=torch.float32,
                                  device=device)[:, None, None]
        w = torch.as_tensor(win[sl], device=device)[:, None]
        s0 = torch.as_tensor(start_f[sl], device=device)[:, None]
        for ri in range(2):
            flat_pool.index_add_(0, ((w * 2 + ri) * FL + s0 + span)
                                 .reshape(-1), frames[:, ri].reshape(-1))
    return {"pool": pool.reshape(B, W, 2, FL).cpu().numpy(),
            "frames": {"window": win, "message": msg_f, "freq": freq,
                       "start": start_f, "weak": np.tile([False, True], n)}}
