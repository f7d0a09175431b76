"""Synthetic channel impairments for closed-loop simulation.

Replaces the reference's manual closed-loop flowgraph rig
(examples/WaveFilePlusNoiseDecode.grc: signal gain + interference + AWGN by
ear) with a deterministic, scriptable channel: AWGN at a calibrated SNR,
linear frequency drift, and SLM Doppler trajectories.

The port's own copy of uwspr_tpu/io/channel.py (imports pointed inside
uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import numpy as np

from uwspr_tpu_torch.models.slm import slm_frequency_drift
from uwspr_tpu_torch.protocol.constants import SAMPLE_RATE


def awgn(samples: np.ndarray, snr_db: float, *, signal_power: float | None = None,
         noise_bandwidth: float = 2500.0, rng: np.random.Generator | None = None,
         ) -> np.ndarray:
    """Add complex AWGN for a target SNR in ``noise_bandwidth`` Hz.

    WSPR convention: SNR is quoted in a 2500 Hz reference bandwidth. At
    complex sample rate fs the full-band noise power is scaled so that the
    power falling in ``noise_bandwidth`` gives the requested SNR:
    N_full = S / snr_lin * fs / noise_bandwidth.
    """
    rng = rng or np.random.default_rng(0)
    z = np.asarray(samples, dtype=np.complex64)
    if signal_power is None:
        nz = z[np.abs(z) > 0]
        signal_power = float(np.mean(np.abs(nz) ** 2)) if len(nz) else 1.0
    snr_lin = 10.0 ** (snr_db / 10.0)
    noise_power = signal_power / snr_lin * (SAMPLE_RATE / noise_bandwidth)
    sigma = np.sqrt(noise_power / 2.0)
    noise = rng.normal(0, sigma, len(z)) + 1j * rng.normal(0, sigma, len(z))
    return (z + noise).astype(np.complex64)


def noise_sigma(snr_db: float, signal_power: float = 1.0,
                noise_bandwidth: float = 2500.0) -> float:
    """Per-component complex-AWGN sigma for a target SNR (2500 Hz ref bw).

    For continuous streams where noise must be generated hop-by-hop rather
    than added to a complete frame by :func:`awgn`."""
    snr_lin = 10.0 ** (snr_db / 10.0)
    noise_power = signal_power / snr_lin * (SAMPLE_RATE / noise_bandwidth)
    return float(np.sqrt(noise_power / 2.0))


def apply_linear_drift(samples: np.ndarray, drift_hz_per_frame: float,
                       n_symbols: int = 162) -> np.ndarray:
    """Linear drift: deviation +/- drift/2 across the frame, 0 at center.

    Mirrors the coarse model f(k) = (k-81)/81 * drift/2 (lib/FDR_impl.cc:353)
    applied continuously over the frame duration.
    """
    z = np.asarray(samples, dtype=np.complex64)
    n = len(z)
    frame_samples = n_symbols * 256
    t = np.arange(n, dtype=np.float64)
    f = (t - frame_samples / 2) / (frame_samples / 2) * drift_hz_per_frame / 2
    phase = 2 * np.pi * np.cumsum(f) / SAMPLE_RATE
    return (z * np.exp(1j * phase)).astype(np.complex64)


def apply_slm_doppler(samples: np.ndarray, v1: float, v2: float, p1: float,
                      p2: float, cf: float) -> np.ndarray:
    """Frequency-modulate by the SLM Doppler drift trajectory."""
    z = np.asarray(samples, dtype=np.complex64)
    t = np.arange(len(z), dtype=np.float64) / SAMPLE_RATE
    f = slm_frequency_drift(v1, v2, p1, p2, cf, t)
    phase = 2 * np.pi * np.cumsum(f) / SAMPLE_RATE
    return (z * np.exp(1j * phase)).astype(np.complex64)


__all__ = ["awgn", "noise_sigma", "apply_linear_drift", "apply_slm_doppler"]
