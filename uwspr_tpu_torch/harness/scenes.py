"""Every scene the reference's result harnesses decode, as functions of
their seed, bitwise equal to the reference's windows (numpy's generator,
the port's held-equal copies of the synthesiser and the channel).

The exception is the 4096-channel scene (``serve_4096_scene``): the
reference synthesises it on the TPU with JAX's generator; here it is
synthesised on the card with a seeded ``torch.Generator`` and the same 4-FSK
modulation, so only its frame placement (numpy's draws) is the
reference's. Its check is the count of embedded frames found.
"""

from __future__ import annotations

import numpy as np
import torch

from uwspr_tpu_torch.demod.finesync import complex_to_ri
from uwspr_tpu_torch.io.channel import awgn, noise_sigma
from uwspr_tpu_torch.protocol.constants import (SAMPLE_RATE,
                                                SAMPLES_PER_SYMBOL,
                                                TONE_OFFSETS, TONE_SPACING,
                                                WINDOW_HOP_SAMPLES,
                                                WINDOW_SAMPLES)
from uwspr_tpu_torch.protocol.fec_encode import channel_symbols
from uwspr_tpu_torch.protocol.messages import pack_message
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

MESSAGE = ("VE3EMB", "FN25", 30)
EXPECTED = "VE3EMB FN25 30"
# scripts/bench_matrix.py:55-58: the multi-signal scenes' messages
CALLS = ["K1ABC", "W9XYZ", "N2AB", "VE3EMB", "G4CDE",
         "JA1FG", "VK2HI", "PY3JK", "ZS6LM", "OH2NP"]
GRIDS = ["FN42", "EM12", "FN31", "FN25", "IO91",
         "PM95", "QF56", "GF49", "KG33", "KP20"]
FL = WINDOW_SAMPLES
HOP = WINDOW_HOP_SAMPLES


def to_ri(windows) -> np.ndarray:
    """(W, n) complex windows or channel blocks -> (W, 2, n) float32
    real/imag (bench_ring_ingest.py's complex_to_ri_block too)."""
    return np.stack([complex_to_ri(z) for z in windows])


def _noise(rng, sigma: float) -> np.ndarray:
    return (rng.normal(scale=sigma, size=FL)
            + 1j * rng.normal(scale=sigma, size=FL)).astype(np.complex64)


# ------------------------------------------------------------ bench.py

def bench_windows(n: int, snr_db: float = -18.0, seed: int = 0):
    """bench.py:39-51 (``make_windows``): one frame per window at a random
    offset (+/-5 Hz) and start (0..2000 samples) -> (windows (n, fl)
    complex64, expected messages)."""
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(n):
        f = float(rng.uniform(-5, 5))
        start = int(rng.integers(0, 2000))
        z = synthesize_frame(*MESSAGE, start_sample=start, freq_offset=f)
        windows.append(awgn(z, snr_db, rng=rng))
    return np.stack(windows), [EXPECTED] * n


# ---------------------------------------------------- bench_matrix.py

def wideband_scene(n_windows: int = 32, n_sig: int = 10,
                   snr_db: float = -15.0, seed: int = 3):
    """scripts/bench_matrix.py:106-133: ``n_sig`` frames per window across
    +/-170 Hz in noise -> (windows, expected message sets)."""
    rng = np.random.default_rng(seed)
    sigma = noise_sigma(snr_db)
    windows, expected = [], []
    base = np.linspace(-170, 170, n_sig)
    for _ in range(n_windows):
        z = _noise(rng, sigma)
        exp = set()
        for k in range(n_sig):
            f = float(base[k] + rng.uniform(-2, 2))
            z += synthesize_frame(CALLS[k], GRIDS[k], 30,
                                  start_sample=int(rng.integers(0, 2000)),
                                  freq_offset=f, pad_to=FL)
            exp.add(f"{CALLS[k]} {GRIDS[k]} 30")
        windows.append(z)
        expected.append(exp)
    return np.stack(windows), expected


def _frames_in_awgn(rng, n: int, snr_db: float) -> np.ndarray:
    """bench_matrix.py's one-frame recipe: start then offset, then AWGN."""
    windows = []
    for _ in range(n):
        z = synthesize_frame(*MESSAGE,
                             start_sample=int(rng.integers(0, 2000)),
                             freq_offset=float(rng.uniform(-5, 5)))
        windows.append(awgn(z, snr_db, rng=rng))
    return np.stack(windows)


def deepsnr_scenes(n_windows: int = 32, seed: int = 5,
                   snrs=(-29.0, -30.0, -31.0)):
    """scripts/bench_matrix.py:157-180: one generator draws every point's
    windows in turn -> [(snr, windows)]."""
    rng = np.random.default_rng(seed)
    return [(snr, _frames_in_awgn(rng, n_windows, snr)) for snr in snrs]


def channels_scene(n_ch: int = 256, snr_db: float = -18.0, seed: int = 4):
    """scripts/bench_matrix.py:214-226: one window per channel."""
    return _frames_in_awgn(np.random.default_rng(seed), n_ch, snr_db)


def noise_only_scene(n_windows: int = 128, seed: int = 11):
    """scripts/bench_matrix.py:258-268: complex noise at the -12 dB
    sigma, no frame."""
    rng = np.random.default_rng(seed)
    sigma = noise_sigma(-12.0)
    return np.stack([_noise(rng, sigma) for _ in range(n_windows)])


def dense_deepsnr_scene(n_windows: int = 64, n_sig: int = 3,
                        snr_db: float = -29.0, seed: int = 12):
    """scripts/bench_matrix.py:285-306: ``n_sig`` frames 6 Hz apart per
    window at ``snr_db`` -> (windows, expected message sets)."""
    rng = np.random.default_rng(seed)
    sigma = noise_sigma(snr_db)
    base = np.asarray([-6.0, 0.0, 6.0])
    windows, expected = [], []
    for _ in range(n_windows):
        z = _noise(rng, sigma)
        exp = set()
        for k in range(n_sig):
            f = float(base[k] + rng.uniform(-1, 1))
            z += synthesize_frame(CALLS[k], GRIDS[k], 30,
                                  start_sample=int(rng.integers(0, 2000)),
                                  freq_offset=f, pad_to=FL)
            exp.add(f"{CALLS[k]} {GRIDS[k]} 30")
        windows.append(z)
        expected.append(exp)
    return np.stack(windows), expected


def serve_4096_placement(n_ch: int = 4096, seed: int = 13):
    """scripts/bench_matrix.py:336-363's numpy draws: the embedded
    channels (a random eighth, sorted), each frame's offset (float32) and
    start (int32)."""
    rng = np.random.default_rng(seed)
    emb = np.sort(rng.choice(n_ch, n_ch // 8, replace=False))
    f_off = rng.uniform(-5, 5, len(emb)).astype(np.float32)
    start = rng.integers(0, 2000, len(emb)).astype(np.int32)
    return emb, f_off, start


def serve_4096_scene(n_ch: int = 4096, snr_db: float = -18.0,
                     seed: int = 13, *, device: torch.device):
    """The (n_ch, 2, fl) float32 scene of scripts/bench_matrix.py:336-391,
    synthesised on ``device``: noise from a ``torch.Generator`` seeded with
    ``seed`` and the frames by the same in-graph 4-FSK modulation (float32
    phase accumulation), at the reference's placement. -> (scene, emb)."""
    emb, f_off, start = serve_4096_placement(n_ch, seed)
    payload = np.asarray(pack_message(*MESSAGE))[:7]
    bits = np.unpackbits(payload.astype(np.uint8))[:50]
    sym = torch.as_tensor(np.asarray(channel_symbols(bits), np.int64),
                          device=device)
    sps = SAMPLES_PER_SYMBOL
    frame_len = 162 * sps
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    f32 = torch.float32
    scene = noise_sigma(snr_db) * torch.randn((n_ch, 2, FL), generator=gen,
                                              device=device, dtype=f32)
    tones = torch.as_tensor(TONE_OFFSETS, dtype=f32, device=device)
    tone = (tones[sym] * TONE_SPACING)[None, :] \
        + torch.as_tensor(f_off, device=device)[:, None]     # (n_f, 162)
    inst = torch.repeat_interleave(tone, sps, dim=1)          # (n_f, L)
    dphi = 2.0 * np.pi * inst / SAMPLE_RATE
    phase = torch.cumsum(dphi, dim=1) - dphi                  # phase[0] = 0
    t = (torch.arange(FL, device=device)[None, :]
         - torch.as_tensor(start, device=device, dtype=torch.int64)[:, None])
    inside = (t >= 0) & (t < frame_len)
    tc = t.clamp(0, frame_len - 1)
    add = torch.stack([torch.where(inside, torch.gather(fn(phase), 1, tc),
                                   0.0) for fn in (torch.cos, torch.sin)],
                      dim=1)                                  # (n_f, 2, fl)
    scene[torch.as_tensor(emb, device=device)] += add
    return scene, emb


# ------------------------------------------------- the SNR sweep's trials

def skip_sweep_trials(rng: np.random.Generator, trials: int) -> None:
    """Advance ``rng`` past ``trials`` trials of pipeline/sweep.py's
    make_trial (no interference) without building them: the offset, the
    start and the window's two normal draws of awgn."""
    for _ in range(trials):
        rng.uniform(-5.0, 5.0)
        rng.integers(0, 750)
        rng.normal(size=FL)
        rng.normal(size=FL)


# ------------------------------------------- OSD sweeps and calibration

def osd_trial(snr: float | None, t: int, seed_base: int = 31000):
    """Trial t of scripts/sweep_osd_artifact.py:51-58 (and
    sweep_osd_device_artifact.py:54-63, osd_calibrate.py:50-61): seed
    seed_base + t, offset +/-5 Hz, start 0..750; snr None is
    osd_calibrate's noise-only window at the -10 dB sigma."""
    rng = np.random.default_rng(seed_base + t)
    if snr is None:
        return _noise(rng, noise_sigma(-10.0))
    f = float(rng.uniform(-5, 5))
    start = int(rng.integers(0, 750))
    return awgn(synthesize_frame(*MESSAGE, start_sample=start,
                                 freq_offset=f), snr, rng=rng)


def osd_batch(snr: float, trials: int, seed_base: int = 31000) -> np.ndarray:
    """sweep_osd_device_artifact.py's make_batch: (trials, 2, fl)."""
    return to_ri([osd_trial(snr, t, seed_base) for t in range(trials)])


# ------------------------------------------------------------- multipass

STRONG_SNR = -13.0      # scripts/multipass_artifact.py:32-37
SEP_HZ = 1.5
STRONG_MSG = "VE3EMB FN25 30"
WEAK_MSG = "K1ABC FN42 37"


def multipass_trial(rel_db: float, t: int, seed_base: int = 1000):
    """Trial t of scripts/multipass_artifact.py:45-56: a strong frame at
    0 Hz and a weak one SEP_HZ above it, rel_db below, both starting at
    500..2500 samples, in AWGN at STRONG_SNR."""
    rng = np.random.default_rng(seed_base + t)
    strong = synthesize_frame("VE3EMB", "FN25", 30,
                              start_sample=int(rng.integers(500, 2500)),
                              freq_offset=0.0)
    weak = synthesize_frame("K1ABC", "FN42", 37,
                            start_sample=int(rng.integers(500, 2500)),
                            freq_offset=SEP_HZ)
    return awgn(strong + 10.0 ** (rel_db / 20.0) * weak, STRONG_SNR,
                rng=rng)


# ------------------------------------------------------------- the ring

def ring_streams(C: int = 128, hops: int = 13, seed: int = 0) -> np.ndarray:
    """scripts/bench_ring_ingest.py:50-72 (``make_streams``): (C, fl +
    (hops + 4) * hop) streams, each channel's frame repeating every 13
    hops from a start in 0..500, in AWGN at -18 dB."""
    rng = np.random.default_rng(seed)
    n = FL + (hops + 4) * HOP
    period = 13 * HOP
    out = np.zeros((C, n), np.complex64)
    for c in range(C):
        z = synthesize_frame(*MESSAGE, start_sample=0,
                             freq_offset=float(rng.uniform(-4, 4)))
        z = z[:41472 + 256]                 # the frame proper
        s0 = int(rng.integers(0, 500))
        for s in range(s0, n, period):
            seg = min(len(z), n - s)
            out[c, s:s + seg] += z[:seg]
        out[c] = awgn(out[c], -18, rng=rng)
    return out


__all__ = ["CALLS", "EXPECTED", "FL", "GRIDS", "HOP", "MESSAGE",
           "STRONG_MSG", "WEAK_MSG", "bench_windows", "channels_scene",
           "deepsnr_scenes", "dense_deepsnr_scene", "multipass_trial",
           "noise_only_scene", "osd_batch", "osd_trial",
           "ring_streams", "serve_4096_placement", "serve_4096_scene",
           "skip_sweep_trials", "to_ri", "wideband_scene"]
