"""4-FSK WSPR baseband synthesis — the framework's ``wsprsim`` replacement.

Generates 375 S/s complex baseband frames from channel symbols with
phase-continuous MFSK. Together with protocol.messages.pack_message and
protocol.fec_encode.channel_symbols this synthesizes arbitrary valid frames
(the reference relies on the external K1JT ``wsprsim`` tool for this,
README.md:35-43).

The port's own copy of uwspr_tpu/protocol/modulate.py (imports pointed
inside uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import numpy as np

from uwspr_tpu_torch.protocol.constants import (
    FRAME_SAMPLES,
    SAMPLE_RATE,
    SAMPLES_PER_SYMBOL,
    TONE_OFFSETS,
    TONE_SPACING,
    WINDOW_SAMPLES,
)
from uwspr_tpu_torch.protocol.fec_encode import channel_symbols
from uwspr_tpu_torch.protocol.messages import pack_message


def modulate_symbols(symbols: np.ndarray, amplitude: float = 1.0,
                     freq_offset: float = 0.0) -> np.ndarray:
    """162 channel symbols -> 41472-sample complex64 baseband frame.

    Phase-continuous 4-FSK: tone for symbol s is
    (TONE_OFFSETS[s] * TONE_SPACING + freq_offset) Hz.
    """
    symbols = np.asarray(symbols)
    tone_hz = TONE_OFFSETS[symbols] * TONE_SPACING + freq_offset  # (162,)
    inst_freq = np.repeat(tone_hz, SAMPLES_PER_SYMBOL)            # per sample
    # integrate frequency -> phase (phase at sample n uses freqs 0..n-1)
    dphi = 2.0 * np.pi * inst_freq / SAMPLE_RATE
    phase = np.concatenate([[0.0], np.cumsum(dphi)[:-1]])
    return (amplitude * np.exp(1j * phase)).astype(np.complex64)


def synthesize_frame(callsign: str, grid: str | None, power_dbm: int,
                     amplitude: float = 1.0, freq_offset: float = 0.0,
                     pad_to: int | None = WINDOW_SAMPLES,
                     start_sample: int = 0) -> np.ndarray:
    """Message -> complex baseband, optionally padded into a window.

    All message types (pack_message dispatch): "CALL GRID dBm",
    compound "PFX/CALL dBm" / "CALL/SFX dBm" (grid=None), or a 6-char
    locator for type-3 hash frames. ``start_sample`` places the frame
    start inside the padded window (the reference's nominal start is 2 s
    into the stream; coarse search resolves offsets of 0..26
    half-symbols, lib/FDR_impl.cc:346).
    """
    payload = pack_message(callsign, grid, power_dbm)
    sym = channel_symbols(_payload_bits(payload))
    frame = modulate_symbols(sym, amplitude, freq_offset)
    if pad_to is None:
        return frame
    out = np.zeros(pad_to, dtype=np.complex64)
    n = min(len(frame), pad_to - start_sample)
    out[start_sample:start_sample + n] = frame[:n]
    return out


def _payload_bits(payload: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(payload[:7], dtype=np.uint8))[:50]


__all__ = ["modulate_symbols", "synthesize_frame", "FRAME_SAMPLES"]
