"""Live audio capture — the soundcard twin of the reference's
``audio_source`` (examples/AudioSourceDecode.grc uses GNU Radio's ALSA
audio source at 12 kS/s; README.md:45-55).

The framework's live-audio transport has always been s16 mono on stdin
(portable, testable); this module adds a real CAPTURE backend behind the
same sample contract: 16-bit mono blocks at ``rate`` S/s, yielded as
numpy int16 arrays. Backends are probed in order at open():

  sounddevice  (PortAudio via the sounddevice package)
  pyaudio      (PortAudio via the pyaudio package)
  alsa         (ctypes on libasound.so.2 — snd_pcm_* directly, no
                Python package needed)
  arecord      (subprocess on the alsa-utils CLI)

None of these are baked into every runtime image (this one has none);
``AudioCapture.open`` raises ``AudioUnavailable`` with the probe log so
callers (cli.py) can fall back to stdin with a clear message, and tests
inject a fake backend via the ``backend=`` hook.

The port's own copy of uwspr_tpu/io/audio.py, held equal to it by
tests/test_torch_copies.py except ``_ArecordBackend.read``: a short read
with an odd byte count is truncated to whole samples, and a read of fewer
than 2 bytes ends the stream with EOFError (the original hands numpy an
odd-length buffer, which raises ValueError).
"""

from __future__ import annotations

import numpy as np


class AudioUnavailable(RuntimeError):
    """No capture backend could be opened; .probes lists what was tried."""

    def __init__(self, probes: list[str]):
        super().__init__(
            "no audio capture backend available: " + "; ".join(probes))
        self.probes = probes


class _SounddeviceBackend:
    name = "sounddevice"

    def __init__(self, rate: int, device: str | None, blocksize: int):
        import sounddevice as sd
        self._sd = sd
        self._stream = sd.RawInputStream(
            samplerate=rate, channels=1, dtype="int16",
            device=device or None, blocksize=blocksize)
        self._stream.start()
        self.blocksize = blocksize

    def read(self) -> np.ndarray:
        data, _overflow = self._stream.read(self.blocksize)
        return np.frombuffer(bytes(data), "<i2")

    def close(self):
        self._stream.stop()
        self._stream.close()


class _PyaudioBackend:
    name = "pyaudio"

    def __init__(self, rate: int, device: str | None, blocksize: int):
        import pyaudio
        self._pa = pyaudio.PyAudio()
        idx = int(device) if device else None
        self._stream = self._pa.open(
            format=pyaudio.paInt16, channels=1, rate=rate, input=True,
            input_device_index=idx, frames_per_buffer=blocksize)
        self.blocksize = blocksize

    def read(self) -> np.ndarray:
        data = self._stream.read(self.blocksize,
                                 exception_on_overflow=False)
        return np.frombuffer(data, "<i2")

    def close(self):
        self._stream.stop_stream()
        self._stream.close()
        self._pa.terminate()


class _AlsaBackend:
    """Direct libasound capture via ctypes — no Python audio package.

    Uses the blocking snd_pcm_readi path: open -> set_params(S16_LE,
    interleaved, 1 channel, rate, resample=1, latency=500ms) -> readi.
    """

    name = "alsa"

    def __init__(self, rate: int, device: str | None, blocksize: int):
        import ctypes
        import ctypes.util

        lib = ctypes.util.find_library("asound")
        if not lib:
            raise OSError("libasound not found")
        a = ctypes.CDLL(lib)
        self._a = a
        self._ct = ctypes
        pcm = ctypes.c_void_p()
        dev = (device or "default").encode()
        # SND_PCM_STREAM_CAPTURE = 1, blocking mode (0)
        rc = a.snd_pcm_open(ctypes.byref(pcm), dev, 1, 0)
        if rc < 0:
            raise OSError(f"snd_pcm_open({dev!r}) -> {rc}")
        self._pcm = pcm
        # SND_PCM_FORMAT_S16_LE=2, SND_PCM_ACCESS_RW_INTERLEAVED=3
        rc = a.snd_pcm_set_params(pcm, 2, 3, 1, rate, 1, 500000)
        if rc < 0:
            a.snd_pcm_close(pcm)
            raise OSError(f"snd_pcm_set_params -> {rc}")
        self.blocksize = blocksize

    def read(self) -> np.ndarray:
        buf = np.empty(self.blocksize, "<i2")
        ct = self._ct
        got = self._a.snd_pcm_readi(
            self._pcm, buf.ctypes.data_as(ct.c_void_p),
            ct.c_ulong(self.blocksize))
        if got < 0:   # xrun etc: try to recover once, else raise
            rc = self._a.snd_pcm_recover(self._pcm, got, 1)
            if rc < 0:
                raise OSError(f"snd_pcm_readi -> {got}")
            return np.zeros(0, "<i2")
        return buf[:got]

    def close(self):
        self._a.snd_pcm_close(self._pcm)


class _ArecordBackend:
    name = "arecord"

    def __init__(self, rate: int, device: str | None, blocksize: int):
        import shutil
        import subprocess
        exe = shutil.which("arecord")
        if not exe:
            raise OSError("arecord not on PATH")
        cmd = [exe, "-q", "-f", "S16_LE", "-c", "1", "-r", str(rate),
               "-t", "raw"]
        if device:
            cmd += ["-D", device]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        self.blocksize = blocksize

    def read(self) -> np.ndarray:
        data = self._proc.stdout.read(2 * self.blocksize)
        n = len(data) // 2 * 2          # whole samples only
        if n == 0:
            raise EOFError("arecord stream ended")
        return np.frombuffer(data[:n], "<i2")

    def close(self):
        self._proc.terminate()
        self._proc.wait(timeout=5)


_BACKENDS = [_SounddeviceBackend, _PyaudioBackend, _AlsaBackend,
             _ArecordBackend]


class AudioCapture:
    """Mono s16 capture stream at ``rate`` S/s.

    Iterate to receive int16 blocks (typically ``blocksize`` samples).
    ``backend`` forces a specific backend class or instance (tests pass a
    fake here); by default every known backend is probed in order.
    """

    def __init__(self, rate: int = 12000, device: str | None = None,
                 blocksize: int = 4096, backend=None):
        self.rate = rate
        probes = []
        if backend is not None:
            self._b = (backend if not isinstance(backend, type)
                       else backend(rate, device, blocksize))
        else:
            self._b = None
            for cls in _BACKENDS:
                try:
                    self._b = cls(rate, device, blocksize)
                    break
                except Exception as e:  # noqa: BLE001 — probe log
                    probes.append(f"{cls.name}: {e}")
            if self._b is None:
                raise AudioUnavailable(probes)

    @property
    def backend_name(self) -> str:
        return getattr(self._b, "name", type(self._b).__name__)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        try:
            block = self._b.read()
        except EOFError:
            raise StopIteration from None
        return np.asarray(block, dtype=np.int16)

    def close(self):
        self._b.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


__all__ = ["AudioCapture", "AudioUnavailable"]
