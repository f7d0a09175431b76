"""WAV audio ingest (16-bit PCM mono, as in the reference's examples/).

The port's own copy of uwspr_tpu/io/wavfile.py, held equal to it by
tests/test_torch_copies.py.
"""

from __future__ import annotations

import os
import wave

import numpy as np


def read_wav(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Returns (float32 samples scaled to [-1, 1), sample_rate)."""
    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        rate = w.getframerate()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


def write_wav(path: str | os.PathLike, samples: np.ndarray, rate: int) -> None:
    """Write float samples in [-1, 1) as 16-bit PCM mono."""
    x = np.clip(np.asarray(samples, dtype=np.float64), -1.0, 32767.0 / 32768.0)
    pcm = (x * 32768.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


__all__ = ["read_wav", "write_wav"]
