"""The port's soundcard capture (``uwspr_tpu_torch.io.audio``).

No capture stack exists here, so the backend probe must fail cleanly and
name every backend; a fake backend drives capture -> streaming
downconversion -> decode on a frame upconverted to 12 kS/s s16 (as
tests/test_audio_capture.py does for the JAX package); and an arecord
stand-in that ends on an odd byte count ends the port's stream cleanly,
where the JAX package's reader raises ValueError.
"""

import os
import stat
import sys

import numpy as np
import pytest

from uwspr_tpu.io import audio as jaudio
from uwspr_tpu_torch.config import CoarseConfig, DemodConfig, PipelineConfig
from uwspr_tpu_torch.frontend.downconvert import (StreamingDownconverter,
                                                  upconvert)
from uwspr_tpu_torch.io import audio as taudio
from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
from uwspr_tpu_torch.protocol.modulate import synthesize_frame


class FakeBackend:
    """Replays a prepared s16 stream in blocks, then EOF."""

    name = "fake"

    def __init__(self, samples: np.ndarray, blocksize: int = 4096):
        self._s = np.asarray(samples, np.int16)
        self._pos = 0
        self.blocksize = blocksize

    def read(self) -> np.ndarray:
        if self._pos >= len(self._s):
            raise EOFError
        block = self._s[self._pos:self._pos + self.blocksize]
        self._pos += self.blocksize
        return block

    def close(self):
        pass


def test_probe_fails_cleanly_and_names_every_backend():
    with pytest.raises(taudio.AudioUnavailable) as e:
        taudio.AudioCapture(rate=12000)
    log = "; ".join(e.value.probes)
    for name in ("sounddevice", "pyaudio", "alsa", "arecord"):
        assert name in log, log
    assert str(e.value).startswith("no audio capture backend available")


def test_fake_capture_decodes_frame():
    z = synthesize_frame("VE3EMB", "FN25", 30, freq_offset=1.5)
    audio = upconvert(z, amplitude=0.5)
    s16 = np.clip(np.round(audio * 32767), -32768, 32767).astype(np.int16)
    with taudio.AudioCapture(rate=12000, backend=FakeBackend(s16)) as cap:
        assert cap.backend_name == "fake"
        dc = StreamingDownconverter()
        chunks = [dc.push(b.astype(np.float32) / 32768.0) for b in cap]
    zb = np.concatenate([c for c in chunks if len(c)])
    assert len(zb) >= 44000
    window = np.zeros(45000, np.complex64)
    window[:len(zb[:45000])] = zb[:45000]
    dec = WindowDecoder(PipelineConfig(coarse=CoarseConfig(maxfreqs=13),
                                       demod=DemodConfig(maxcycles=2000)),
                        device="cpu")
    assert "VE3EMB FN25 30" in {s.message for s in dec(window).spots}


@pytest.fixture
def fake_arecord(tmp_path, monkeypatch):
    """An ``arecord`` on PATH that writes UWSPR_FAKE_BYTES bytes of s16
    (sample k = k) and exits."""
    exe = tmp_path / "arecord"
    exe.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        "n = int(os.environ['UWSPR_FAKE_BYTES'])\n"
        "data = b''.join(k.to_bytes(2, 'little') for k in range(n // 2 + 1))\n"
        "sys.stdout.buffer.write(data[:n])\n")
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")

    def start(n_bytes, module):
        monkeypatch.setenv("UWSPR_FAKE_BYTES", str(n_bytes))
        return module.AudioCapture(
            backend=module._ArecordBackend(12000, None, 4096))
    return start


@pytest.mark.parametrize("n_bytes", [201, 1])
def test_arecord_odd_byte_count_ends_cleanly(fake_arecord, n_bytes):
    cap = fake_arecord(n_bytes, taudio)
    assert cap.backend_name == "arecord"
    blocks = list(cap)              # stops with StopIteration (EOFError)
    cap.close()
    got = np.concatenate(blocks) if blocks else np.zeros(0, np.int16)
    np.testing.assert_array_equal(got, np.arange(n_bytes // 2))
    assert got.dtype == np.int16


def test_jax_arecord_raises_on_odd_byte_count(fake_arecord):
    """The difference the port repairs: the JAX reader hands numpy an
    odd-length buffer."""
    cap = fake_arecord(201, jaudio)
    with pytest.raises(ValueError):
        list(cap)
    cap.close()
