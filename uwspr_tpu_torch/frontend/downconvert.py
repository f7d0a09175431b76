"""Audio-rate front end: 12 kS/s real audio <-> 375 S/s complex baseband.

Counterpart of uwspr_tpu/frontend/downconvert.py. Receiver (reference
chain, examples/AudioSourceDecode.grc: band-pass at 1500 +/- 10 Hz ->
freq-translate -1500 Hz -> low-pass -> decimate x32): one fused stage,
a complex mix to baseband, then a 257-tap windowed-sinc anti-alias
low-pass evaluated only at the decimated output points. ``Downconverter``
runs that stage on the device the caller names, as one strided
``conv1d`` over the (re, im) planes under ``exact_f32`` (cuDNN's default
TF32 would leave ~1e-3 relative error on a 257-tap sum). The mixer's
cos/-sin is computed in float64 on the host and cast to float32, as the
reference does: a float32 phase ramp is garbage past 2^24 samples.

``design_lowpass``, ``StreamingDownconverter`` (block-wise, for live
sources) and ``upconvert`` (the sender, examples/c2ToWaveFile.grc) stay
on the host in numpy: copies of the reference's, held equal to it by
tests/test_torch_copies.py.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from uwspr_tpu_torch.config import FrontendConfig
from uwspr_tpu_torch.device import exact_f32, resolve_device


def design_lowpass(num_taps: int, cutoff_hz: float, fs: float) -> np.ndarray:
    """Hamming windowed-sinc low-pass FIR, unity DC gain."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    fc = cutoff_hz / fs
    h = 2 * fc * np.sinc(2 * fc * n)
    h *= np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


class Downconverter:
    """(N,) float audio at audio_rate -> (N//decim,) complex64 baseband,
    mixed and filtered on ``device``."""

    def __init__(self, cfg: FrontendConfig | None = None, num_taps: int = 257,
                 *, device: str | torch.device):
        self.cfg = cfg or FrontendConfig()
        self.device = resolve_device(device)
        # stopband must begin by fs_out - halfbandwidth to protect the
        # passband from decimation aliasing; center the cutoff well below
        fs_out = self.cfg.audio_rate / self.cfg.decimation
        cutoff = min(100.0, fs_out / 3)
        self.taps = design_lowpass(num_taps, cutoff, self.cfg.audio_rate)
        # conv1d is a correlation, as the reference's conv_general_dilated:
        # both take the taps reversed
        self._kernel = torch.from_numpy(self.taps[::-1].copy()).reshape(
            1, 1, -1).to(self.device)

    def mixer(self, n: int) -> np.ndarray:
        """(2, n) float32 cos/-sin of the mixer, from a float64 ramp."""
        cfg = self.cfg
        w = ((-2.0 * np.pi * cfg.center_freq / cfg.audio_rate)
             * np.arange(n, dtype=np.float64))
        return np.stack([np.cos(w), np.sin(w)]).astype(np.float32)

    def planes(self, x: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        """The device half: (n,) audio and the (2, n) mixer, n a multiple of
        the decimation, -> (2, n // decim) float32 real/imag planes."""
        with torch.no_grad(), exact_f32():
            mixed = x[None, :] * lo                             # (2, n)
            return F.conv1d(mixed[:, None, :], self._kernel,
                            stride=self.cfg.decimation,
                            padding=self._kernel.shape[-1] // 2)[:, 0]

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        n = (len(audio) // self.cfg.decimation) * self.cfg.decimation
        x = torch.from_numpy(np.ascontiguousarray(audio[:n], np.float32))
        lo = torch.from_numpy(self.mixer(n))
        out = self.planes(x.to(self.device), lo.to(self.device)).cpu().numpy()
        return (out[0] + 1j * out[1]).astype(np.complex64)


def downconvert(audio: np.ndarray, cfg: FrontendConfig | None = None, *,
                device: str | torch.device) -> np.ndarray:
    return Downconverter(cfg, device=device)(audio)


class StreamingDownconverter:
    """Block-wise downconversion for live audio sources (stdin, sound
    card): carries the FIR tail and the mixer phase across pushes, so a
    continuous stream fed in arbitrary chunks equals the one-shot
    Downconverter output up to a fixed (num_taps//2)-audio-sample group
    delay. Host-side numpy — the per-block FLOPs (~3 M MAC/s of audio) are
    negligible next to the decode itself."""

    def __init__(self, cfg: FrontendConfig | None = None, num_taps: int = 257):
        self.cfg = cfg or FrontendConfig()
        fs_out = self.cfg.audio_rate / self.cfg.decimation
        cutoff = min(100.0, fs_out / 3)
        self.taps = design_lowpass(num_taps, cutoff, self.cfg.audio_rate
                                   ).astype(np.float64)
        self._tail = np.zeros(num_taps - 1, np.float32)
        self._pos = -(num_taps - 1)       # absolute index of _tail[0]
        self._rem = np.zeros(0, np.float32)

    def push(self, audio: np.ndarray) -> np.ndarray:
        """(n,) audio samples -> (m,) complex64 baseband (m = n//decim once
        buffered remainders even out)."""
        cfg = self.cfg
        audio = np.concatenate([self._rem,
                                np.asarray(audio, dtype=np.float32)])
        n = (len(audio) // cfg.decimation) * cfg.decimation
        self._rem = audio[n:]
        if n == 0:
            return np.zeros(0, np.complex64)
        x = np.concatenate([self._tail, audio[:n]])
        t = self._pos + np.arange(len(x), dtype=np.float64)
        lo = np.exp(-2j * np.pi * cfg.center_freq / cfg.audio_rate * t)
        y = np.convolve(x * lo, self.taps, mode="valid")[::cfg.decimation]
        self._pos += n
        self._tail = x[n:].copy()
        return y.astype(np.complex64)


def upconvert(baseband: np.ndarray, cfg: FrontendConfig | None = None,
              num_taps: int = 513, amplitude: float = 0.5) -> np.ndarray:
    """375 S/s complex baseband -> real audio at audio_rate centered at cf.

    Mirrors examples/c2ToWaveFile.grc: x32 zero-stuff interpolation with a
    200 Hz low-pass, translate to +cf, take the real part.
    """
    cfg = cfg or FrontendConfig()
    decim = cfg.decimation
    z = np.asarray(baseband, dtype=np.complex64)
    up = np.zeros(len(z) * decim, dtype=np.complex64)
    up[::decim] = z
    taps = design_lowpass(num_taps, 200.0, cfg.audio_rate) * decim
    up = np.convolve(up, taps, mode="same")
    t = np.arange(len(up), dtype=np.float64)
    lo = np.exp(2j * np.pi * cfg.center_freq * t / cfg.audio_rate)
    audio = (up * lo).real
    peak = np.abs(audio).max() or 1.0
    return (amplitude * audio / peak).astype(np.float32)


__all__ = ["Downconverter", "StreamingDownconverter", "downconvert",
           "upconvert", "design_lowpass"]
