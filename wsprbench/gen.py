"""What the traffic generators share, and the lookup that finds one: a
traffic file's ``kind`` names its generator, ``wsprbench/generators/<kind>.py``,
whose ``generate(traffic, seed, device)`` makes the cell's inputs from the
file's parameters and the seed, on the device in a few large calls. A new
kind of traffic is a new generator file.

Messages are "CALL GRID 30" over the call and grid lists below. Small
draws come from numpy's generator seeded with the seed, the noise from a
``torch.Generator`` on the device seeded with it. Noise sigma follows the
WSPR convention: the SNR of a unit-power frame in 2,500 Hz.
"""

from __future__ import annotations

import numpy as np
import torch

from wsprbench.reference import protocol as P

CALLS = ["K1ABC", "W9XYZ", "N2AB", "VE3EMB", "G4CDE",
         "JA1FG", "VK2HI", "PY3JK", "ZS6LM", "OH2NP"]
GRIDS = ["FN42", "EM12", "FN31", "FN25", "IO91",
         "PM95", "QF56", "GF49", "KG33", "KP20"]
POWER_DBM = 30
FL = 45000
CHUNK = 256            # frames synthesised per call


def message_table() -> tuple[list[str], np.ndarray, np.ndarray]:
    """(texts, payloads (M, 7) uint8, channel symbols (M, 162) uint8) of
    every call and grid pair."""
    texts, pays, syms = [], [], []
    for c in CALLS:
        for g in GRIDS:
            pay = P.pack_type1(c, g, POWER_DBM)
            texts.append(f"{c} {g} {POWER_DBM}")
            pays.append(np.frombuffer(pay, np.uint8))
            syms.append(P.channel_symbols(pay))
    return texts, np.stack(pays), np.stack(syms)


def noise_sigma(snr_db: float) -> float:
    """Per-component sigma of complex AWGN for a unit-power frame."""
    return float(np.sqrt(10.0 ** (-snr_db / 10.0) * P.SAMPLE_RATE
                         / 2500.0 / 2.0))


def synth_frames(symbols: np.ndarray, freq_hz: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """(F, 162) channel symbols and (F,) offsets -> (F, 2, 41472) float32
    real/imag frames: phase-continuous 4-FSK, phase integrated in float64
    from 0 at the first sample."""
    out = torch.empty((len(symbols), 2, P.FRAME_SAMPLES),
                      dtype=torch.float32, device=device)
    tones = torch.as_tensor(P.TONE_OFFSETS * P.TONE_SPACING,
                            dtype=torch.float64, device=device)
    for a in range(0, len(symbols), CHUNK):
        sym = torch.as_tensor(symbols[a:a + CHUNK].astype(np.int64),
                              device=device)
        f = torch.as_tensor(freq_hz[a:a + CHUNK], dtype=torch.float64,
                            device=device)
        inst = torch.repeat_interleave(tones[sym] + f[:, None], P.SPB, dim=1)
        dphi = (2.0 * np.pi / P.SAMPLE_RATE) * inst
        phase = torch.cumsum(dphi, dim=1) - dphi
        out[a:a + CHUNK, 0] = torch.cos(phase).float()
        out[a:a + CHUNK, 1] = torch.sin(phase).float()
    return out


def rngs(seed: int, device: torch.device):
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)
    return np.random.default_rng(seed & 0xFFFF_FFFF_FFFF_FFFF), g


def generate(traffic: dict, seed: int, device: torch.device) -> dict:
    from wsprbench.run import ROOT, load_module
    kind = load_module(ROOT / "wsprbench" / "generators"
                       / f"{traffic['kind']}.py")
    return kind.generate(traffic, seed, device)
