"""Traffic kind ``ring_stream``: ``channels`` beacons, each sending a frame
every ``cycle_samples`` (WSPR's 120 s cycle) with a probability
``tx_share``, after a propagation delay of its own. Delays are stratified
over one cycle and shuffled by the seed, so every seed has the same set of
frame phases against the hop grid. Each frame draws its frequency offset
(uniform in +-``freq_max_hz``) and its message. The stream is periodic over
``cycles`` cycles: a frame that runs past the end wraps to the start, and a
client cycles through it. Complex AWGN at ``snr_db``."""

from __future__ import annotations

import numpy as np
import torch

from wsprbench import gen
from wsprbench.gen import CHUNK, P


def generate(t: dict, seed: int, device: torch.device) -> dict:
    """A ``ring_stream`` traffic file -> {"stream": (C, N) complex64 on the
    host, "frames": per frame (channel, start, message index, offset),
    "period": N}."""
    rng, g = gen.rngs(seed, device)
    C, cyc, n_cyc = t["channels"], t["cycle_samples"], t["cycles"]
    N = cyc * n_cyc
    if N % t["hop_samples"]:
        raise ValueError("the stream must hold a whole number of hops")
    delay = ((rng.permutation(C) + rng.uniform(size=C)) * cyc / C
             ).astype(np.int64)
    texts, _, syms = gen.message_table()
    ch, start, msg, freq = [], [], [], []
    for c in range(C):
        for k in range(n_cyc):
            if rng.uniform() < t["tx_share"]:
                ch.append(c)
                start.append((int(delay[c]) + k * cyc) % N)
                msg.append(int(rng.integers(len(texts))))
                freq.append(float(rng.uniform(-t["freq_max_hz"],
                                              t["freq_max_hz"])))
    sig = gen.noise_sigma(t["snr_db"])
    stream = sig * torch.randn((C, N, 2), generator=g, device=device)
    rows = stream.view(C * N, 2)
    for a in range(0, len(ch), CHUNK):
        frames = gen.synth_frames(syms[msg[a:a + CHUNK]],
                              np.asarray(freq[a:a + CHUNK]), device)
        pos = (torch.as_tensor(start[a:a + CHUNK], device=device)[:, None]
               + torch.arange(P.FRAME_SAMPLES, device=device)) % N
        flat = torch.as_tensor(ch[a:a + CHUNK], device=device)[:, None] * N
        rows.index_add_(0, (flat + pos).reshape(-1),
                        frames.transpose(1, 2).reshape(-1, 2))
    host = torch.view_as_complex(stream).cpu().numpy()
    return {"stream": host, "period": N,
            "frames": {"channel": np.asarray(ch), "start": np.asarray(start),
                       "message": np.asarray(msg), "freq": np.asarray(freq)}}
