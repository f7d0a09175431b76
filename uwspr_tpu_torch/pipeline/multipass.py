"""Multipass decode with successive interference cancellation.

A WSPR frame occupies ~6 Hz, so a strong frame's spectral skirt masks
weaker co-channel frames; the reference decodes each candidate
independently and has no way to recover them
(lib/sync_and_demodulate_impl.cc handles candidates in isolation).
This module adds the successive-cancellation pass structure popularized
by K9AN's wsprd: re-encode each decoded message, re-synthesize the
phase-continuous 4-FSK replica at the spot's refined (freq, shift,
drift), estimate the per-symbol complex channel gain against the
received samples, subtract the fitted replica, and run the decoder
again on the cleaned window.

The channel-gain estimate is per symbol (162 independent projections
onto the replica segment) smoothed with a count-weighted boxcar — the
replica is phase-continuous, so the per-symbol gains vary only with
the channel and any residual frequency error. That residual (the fine
sync grid quantizes frequency to 0.05 Hz) is itself estimated from the
phase slope of consecutive gains and folded back into the replica
before the final fit, which is what pushes cancellation deep enough to
unmask signals ~10 dB below the subtracted one.

All of this is plain NumPy on the host: subtraction happens once per
decoded spot (a handful per window), between batched device passes —
it is orchestration, not a hot loop.

The port's own copy of uwspr_tpu/pipeline/multipass.py (imports pointed
inside uwspr_tpu_torch), held equal to it by tests/test_torch_multipass.py.
It stays numpy: the float64 phase accumulation of the replica is what the
cancellation depth rests on, and the decoders it drives take and return
host arrays.
"""

from __future__ import annotations

import numpy as np

from uwspr_tpu_torch.coarse.search import MODE_NONLINEAR
from uwspr_tpu_torch.config import PipelineConfig
from uwspr_tpu_torch.demod.finesync import jiggle_offsets
from uwspr_tpu_torch.models import slm
from uwspr_tpu_torch.protocol.constants import (
    SAMPLE_RATE,
    SAMPLES_PER_SYMBOL,
    TONE_OFFSETS,
    TONE_SPACING,
)
from uwspr_tpu_torch.protocol.fec_encode import channel_symbols

_NSYM = 162
_FRAME = _NSYM * SAMPLES_PER_SYMBOL
_TSYM = SAMPLES_PER_SYMBOL / SAMPLE_RATE       # symbol period, s


def spot_channel_symbols(payload: bytes) -> np.ndarray:
    """Decoded 7-byte payload -> the 162 4-ary channel symbols that were
    transmitted (re-encode: the code is deterministic)."""
    bits = np.unpackbits(np.frombuffer(payload[:7], np.uint8))[:50]
    return channel_symbols(bits)


def spot_drift_offsets(spot, cf: float) -> np.ndarray:
    """(162,) per-symbol frequency offset in Hz for one spot — mirrors
    demod.finesync.drift_offsets for a single candidate."""
    i = np.arange(_NSYM, dtype=np.float64)
    if spot.mode == MODE_NONLINEAR and len(spot.slm_params) == 4:
        t = (np.arange(_NSYM) * 111 // 162).astype(np.float64)
        v1, v2, p1, p2 = (float(x) for x in spot.slm_params)
        return np.asarray(
            slm.slm_frequency_drift(v1, v2, p1, p2, cf, t), np.float64)
    return (float(spot.drift) / 2.0) * (i - 81.0) / 81.0


def spot_lag(spot, config: PipelineConfig) -> int:
    """The window-local sample index of the decoded frame's first sample:
    the refined shift plus the successful jiggle's offset (the same
    jiggle schedule the decoders use — demod.finesync.jiggle_offsets)."""
    off = jiggle_offsets(int(spot.jiggle) + 1, config.demod.iifac)
    return int(spot.shift) + int(off[int(spot.jiggle)])


def _replica(symbols: np.ndarray, freq: float,
             dsym: np.ndarray) -> np.ndarray:
    """Phase-continuous unit-amplitude 4-FSK replica (41472,) complex64."""
    tone_hz = (TONE_OFFSETS[symbols] * TONE_SPACING + freq + dsym)
    inst = np.repeat(tone_hz, SAMPLES_PER_SYMBOL)
    dphi = 2.0 * np.pi * inst / SAMPLE_RATE
    phase = np.concatenate([[0.0], np.cumsum(dphi)[:-1]])
    return np.exp(1j * phase).astype(np.complex64)


def _symbol_gains(z: np.ndarray, ref: np.ndarray, lag: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-symbol complex channel gain c[i] = <z_i, ref_i> / |seg_i| over
    the part of each symbol that lies inside the window.

    Returns (c (162,) complex128, cnt (162,) in-window sample counts)."""
    n0 = max(0, -lag)
    n1 = min(_FRAME, len(z) - lag)
    zz = np.zeros(_FRAME, np.complex128)
    w = np.zeros(_FRAME, np.float64)
    if n1 > n0:
        zz[n0:n1] = z[lag + n0: lag + n1]
        w[n0:n1] = 1.0
    prod = (zz * np.conj(ref)).reshape(_NSYM, SAMPLES_PER_SYMBOL)
    cnt = w.reshape(_NSYM, SAMPLES_PER_SYMBOL).sum(axis=1)
    c = prod.sum(axis=1) / np.maximum(cnt, 1.0)
    return c, cnt


def _residual_freq_drift(c: np.ndarray, cnt: np.ndarray
                         ) -> tuple[float, float]:
    """Residual (frequency Hz, linear drift Hz/frame) from the phase
    advance between consecutive per-symbol gains.

    The replica is phase-continuous, so a frequency error e rotates c by
    2*pi*e*Tsym per symbol; a drift error tilts that rotation rate across
    the frame. Split-half estimator: the mean pair rotation of each half
    gives the residual frequency at the half centers (~81 symbols apart
    = half a frame), so drift_err = 2 * (f_late - f_early) in the
    reference's convention offset_i = drift * (i - 81) / 162."""
    wpair = np.minimum(cnt[1:], cnt[:-1])
    r = c[1:] * np.conj(c[:-1]) * wpair
    half = len(r) // 2

    def f_of(seg):
        rot = np.sum(seg)
        return (np.angle(rot) / (2.0 * np.pi * _TSYM)
                if abs(rot) > 0.0 else 0.0)

    f_early, f_late = f_of(r[:half]), f_of(r[half:])
    return (f_early + f_late) / 2.0, 2.0 * (f_late - f_early)


# the subtraction's settings, also the device multipass's
# (pipeline/device_decoder.py): the gains' boxcar in symbols, the residual
# frequency and drift polishes, the lag polish in +- samples, and the
# frequency gap within which a later spot of an earlier payload is a
# duplicate
NFILT = 5
FREQ_ITERS = 3
LAG_SEARCH = 16
DUP_FREQ_HZ = 5.0


def _smooth_gains(c: np.ndarray, cnt: np.ndarray, nfilt: int) -> np.ndarray:
    """Count-weighted complex boxcar over symbols: channel estimates from
    partially-in-window symbols contribute proportionally."""
    kernel = np.ones(nfilt)
    num = np.convolve(c * cnt, kernel, mode="same")
    den = np.convolve(cnt, kernel, mode="same")
    return num / np.maximum(den, 1.0)


def subtract_spot(z: np.ndarray, spot, config: PipelineConfig | None = None,
                  nfilt: int = NFILT, freq_iters: int = FREQ_ITERS,
                  lag_search: int = LAG_SEARCH) -> np.ndarray:
    """Return a copy of window ``z`` with the decoded frame of ``spot``
    subtracted.

    nfilt: boxcar width (symbols) for the channel-gain smoothing; wider
    averages more noise out of the estimate but tracks channel/frequency
    variation less.  freq_iters: residual-frequency/drift polish passes.
    lag_search: the decoder's lag is quantized (fine-lag step 16, jiggle
    step 8) and a residual time offset cannot be absorbed by the
    per-symbol gains at tone-switch boundaries, so the lag is polished to
    the sample over +/-lag_search (maximum captured replica energy),
    before and after the frequency polish (each estimate sharpens the
    other).
    """
    config = config or PipelineConfig()
    symbols = spot_channel_symbols(spot.payload)
    dsym = spot_drift_offsets(spot, float(config.coarse.cf))
    lag = spot_lag(spot, config)
    z = np.asarray(z)

    def polish_lag(ref, lag):
        def captured(lg):
            c, cnt = _symbol_gains(z, ref, lg)
            return float(np.sum(cnt * np.abs(c) ** 2))
        return max(range(lag - lag_search, lag + lag_search + 1),
                   key=captured)

    freq = float(spot.freq)
    i = np.arange(_NSYM, dtype=np.float64)
    drift_ramp = (i - 81.0) / 162.0          # offset_i = drift * ramp
    if lag_search > 0:
        lag = polish_lag(_replica(symbols, freq, dsym), lag)
    for _ in range(max(0, freq_iters)):
        ref = _replica(symbols, freq, dsym)
        c, cnt = _symbol_gains(z, ref, lag)
        dfreq, ddrift = _residual_freq_drift(c, cnt)
        if abs(dfreq) < 1e-4 and abs(ddrift) < 1e-3:
            break
        freq += dfreq
        dsym = dsym + ddrift * drift_ramp    # fold residual drift in
    ref = _replica(symbols, freq, dsym)
    if lag_search > 0:
        lag = polish_lag(ref, lag)
    c, cnt = _symbol_gains(z, ref, lag)
    cs = _smooth_gains(c, cnt, nfilt)

    fitted = (np.repeat(cs, SAMPLES_PER_SYMBOL) * ref).astype(np.complex64)
    n0 = max(0, -lag)
    n1 = min(_FRAME, len(z) - lag)
    out = np.array(z, dtype=np.complex64, copy=True)
    if n1 > n0:
        out[lag + n0: lag + n1] -= fitted[n0:n1]
    return out


def _is_duplicate(spot, seen, freq_tol: float = DUP_FREQ_HZ) -> bool:
    return any(spot.payload == s.payload
               and abs(spot.freq - s.freq) < freq_tol for s in seen)


def multipass_spots(window: np.ndarray, decode_fn,
                    config: PipelineConfig | None = None,
                    passes: int = 2, nfilt: int = NFILT) -> list:
    """Run ``decode_fn(window) -> list[Spot]`` up to ``passes`` times,
    subtracting every newly decoded frame between passes.

    Engine-agnostic: ``decode_fn`` may be the host WindowDecoder, the
    all-device DeviceDecoder, or the hybrid engine — each already emits
    spots with the refined (freq, shift, drift, jiggle) the subtraction
    needs.  Returns the deduplicated spot list; each spot's
    ``pass_index`` records the pass that decoded it."""
    config = config or PipelineConfig()
    z = np.asarray(window, dtype=np.complex64)
    spots: list = []
    for p in range(max(1, passes)):
        new = [s for s in decode_fn(z) if not _is_duplicate(s, spots)]
        for s in new:
            s.pass_index = p
        spots.extend(new)
        if p == passes - 1 or not new:
            break
        for s in new:
            z = subtract_spot(z, s, config, nfilt=nfilt)
    return spots


__all__ = ["subtract_spot", "multipass_spots", "spot_channel_symbols",
           "spot_drift_offsets", "spot_lag"]
