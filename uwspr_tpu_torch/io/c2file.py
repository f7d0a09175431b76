""".c2 baseband capture files (K1JT WSPR format).

Layout (reference lib/c2file_source_impl.cc:80-96): 14-byte name field,
int32 WSPR type ("ntrmin"), float64 dial frequency, then 2 x 45000 float32
interleaved I/Q at 375 S/s. The reference *negates Q on ingest*
(c2file_source_impl.cc:91) — read_c2 reproduces that so the returned array
is exactly what the reference decoder sees; write_c2 applies the inverse so
write(read(x)) round-trips.

The port's own copy of uwspr_tpu/io/c2file.py (imports pointed inside
uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

C2_SAMPLES = 45000
_HEADER = struct.Struct("<14sid")


@dataclass
class C2File:
    samples: np.ndarray          # complex64, Q already negated (decoder view)
    name: str = ""
    wspr_type: int = 2
    dial_freq_hz: float = 0.0


def read_c2(path: str | os.PathLike) -> C2File:
    with open(path, "rb") as f:
        raw = f.read()
    name, wspr_type, freq = _HEADER.unpack_from(raw, 0)
    iq = np.frombuffer(raw, dtype="<f4", offset=_HEADER.size,
                       count=2 * C2_SAMPLES)
    z = np.empty(C2_SAMPLES, dtype=np.complex64)
    z.real = iq[0::2]
    z.imag = -iq[1::2]  # Q negation, c2file_source_impl.cc:91
    return C2File(z, name.split(b"\0")[0].decode("ascii", "replace"),
                  wspr_type, freq)


def write_c2(path: str | os.PathLike, samples: np.ndarray, name: str = "",
             wspr_type: int = 2, dial_freq_hz: float = 0.0) -> None:
    z = np.asarray(samples, dtype=np.complex64)
    if len(z) != C2_SAMPLES:
        padded = np.zeros(C2_SAMPLES, dtype=np.complex64)
        padded[:min(len(z), C2_SAMPLES)] = z[:C2_SAMPLES]
        z = padded
    iq = np.empty(2 * C2_SAMPLES, dtype="<f4")
    iq[0::2] = z.real
    iq[1::2] = -z.imag  # inverse of the ingest negation
    with open(path, "wb") as f:
        f.write(_HEADER.pack(name.encode("ascii", "replace")[:14],
                             wspr_type, dial_freq_hz))
        f.write(iq.tobytes())


def array_stream(z: np.ndarray, *, repeat: bool = False, block: int = 3375):
    """Yield consecutive ``block``-sample chunks of an array, wrapping
    seamlessly when ``repeat`` — the reference c2file_source's work-loop
    semantics (c2file_source_impl.cc:108-138), shared by every
    follow-a-file source (c2, wav, GRC wav mixes)."""
    z = np.asarray(z)
    if len(z) == 0:
        return
    pos = 0
    while True:
        chunk = z[pos % len(z):(pos % len(z)) + block]
        if len(chunk) < block and repeat:
            chunk = np.concatenate([chunk, z[:block - len(chunk)]])
        if len(chunk) == 0:
            return
        yield chunk
        pos += len(chunk)
        if not repeat and pos >= len(z):
            return


def c2_stream(path: str | os.PathLike, *, repeat: bool = False,
              drift_rate: float = 0.0, block: int = 3375):
    """Stream a .c2 capture as consecutive sample blocks: optional
    ``repeat`` restarts the file when exhausted, and the simulated
    linear-drift phase ramp accumulates over the *absolute* stream index
    (the reference keeps ``drift`` in a static across work() calls,
    c2file_source_impl.cc:117-133)."""
    z = read_c2(path).samples
    pos = 0
    for chunk in array_stream(z, repeat=repeat, block=block):
        if drift_rate:
            # phase(n) = (n mod N) * pi * drift(n) / 375 with drift(n)
            # accumulating rate/375 per ABSOLUTE sample: the reference's
            # sample_idx resets each repeat pass while its static drift
            # keeps growing (c2file_source_impl.cc:117-133,139)
            n = pos + np.arange(len(chunk), dtype=np.float64)
            phase = np.pi * (n % len(z)) * n * drift_rate / (375.0 * 375.0)
            chunk = (chunk * np.exp(1j * phase)).astype(np.complex64)
        yield chunk
        pos += len(chunk)


def apply_sim_drift(samples: np.ndarray, drift_rate: float) -> np.ndarray:
    """Synthetic linear-drift phase ramp, matching c2file_source's injector.

    The reference multiplies sample n by exp(j*n*pi*d[n]/375) where d[n]
    accumulates drift_rate/375 per sample (c2file_source_impl.cc:117-133,
    rate scaling at :37), i.e. phase[n] = pi * n^2 * drift_rate / 375^2.
    """
    n = np.arange(len(samples), dtype=np.float64)
    phase = np.pi * n * n * drift_rate / (375.0 * 375.0)
    return (np.asarray(samples) * np.exp(1j * phase)).astype(np.complex64)


__all__ = ["C2File", "C2_SAMPLES", "read_c2", "write_c2", "array_stream",
           "c2_stream", "apply_sim_drift"]
