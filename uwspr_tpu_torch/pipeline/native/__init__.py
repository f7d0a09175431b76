"""ctypes bindings for the native streaming windower (stream_native.cc).

Counterpart of uwspr_tpu/pipeline/native/__init__.py. The library is built
with g++ from the port's own ``stream_native.cc`` into the port's build
directory at first use (``utils.gxx_build``). There is no fallback: a
failed build raises, and the caller gets that error, not another windower.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from uwspr_tpu_torch.utils.gxx_build import load_gxx_library

SOURCE = pathlib.Path(__file__).resolve().parent / "stream_native.cc"


def _configure(lib: ctypes.CDLL) -> None:
    i64, i32, p = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    lib.uwspr_stream_create.argtypes = [i32, i64, i64, i32]
    lib.uwspr_stream_create.restype = p
    lib.uwspr_stream_destroy.argtypes = [p]
    lib.uwspr_stream_destroy.restype = None
    lib.uwspr_stream_push.argtypes = [p, p, i64]
    lib.uwspr_stream_push.restype = None
    lib.uwspr_stream_ready.argtypes = [p]
    lib.uwspr_stream_ready.restype = i64
    lib.uwspr_stream_dropped.argtypes = [p]
    lib.uwspr_stream_dropped.restype = i64
    lib.uwspr_stream_buffered.argtypes = [p, i32]
    lib.uwspr_stream_buffered.restype = i64
    lib.uwspr_stream_pop_batch.argtypes = [p, p, p, i64]
    lib.uwspr_stream_pop_batch.restype = i64
    lib.uwspr_stream_num_threads.argtypes = []
    lib.uwspr_stream_num_threads.restype = i32


def load_windower() -> ctypes.CDLL:
    """stream_native.cc built with g++ and loaded once per process."""
    return load_gxx_library(SOURCE, _configure)


class NativeWindower:
    """Multichannel ring-buffer windower backed by the C++ runtime.

    push() ingests (channels, n) complex or planar (channels, 2, n) float32
    blocks; pop_batch() extracts up to max_windows ready (2, fl) windows
    straight into a batched (W, 2, fl) float32 array. Window semantics are
    those of pipeline.stream.SlidingWindow (tests/test_torch_stream.py)."""

    def __init__(self, n_channels: int, fl: int, hop: int,
                 capacity_windows: int = 2):
        self._lib = load_windower()
        self.n_channels = n_channels
        self.fl = fl
        self.hop = hop
        self.capacity_windows = capacity_windows
        self._h = self._lib.uwspr_stream_create(n_channels, fl, hop,
                                                capacity_windows)
        if not self._h:
            raise OSError("uwspr_stream_create failed")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.uwspr_stream_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    @staticmethod
    def to_planar(samples: np.ndarray) -> np.ndarray:
        """(channels, n) complex or (channels, 2, n) real -> contiguous
        planar (channels, 2, n) float32."""
        samples = np.asarray(samples)
        if np.iscomplexobj(samples):
            samples = np.atleast_2d(samples)
            return np.ascontiguousarray(
                np.stack([samples.real, samples.imag], axis=1),
                dtype=np.float32)
        if samples.ndim != 3 or samples.shape[1] != 2:
            raise ValueError(f"real samples must be planar (channels, 2, n),"
                             f" got {samples.shape}")
        return np.ascontiguousarray(samples, dtype=np.float32)

    def push(self, samples: np.ndarray) -> int:
        """Ingest one block for every channel; returns windows now ready."""
        planar = self.to_planar(samples)
        if planar.shape[0] != self.n_channels:
            raise ValueError(f"block has {planar.shape[0]} channels, the "
                             f"windower {self.n_channels}")
        self._lib.uwspr_stream_push(self._h, planar.ctypes.data,
                                    planar.shape[2])
        return self.ready

    @property
    def ready(self) -> int:
        return int(self._lib.uwspr_stream_ready(self._h))

    @property
    def dropped(self) -> int:
        """Samples lost to ring overflow (backpressure observability)."""
        return int(self._lib.uwspr_stream_dropped(self._h))

    def buffered(self, channel: int) -> int:
        if not 0 <= channel < self.n_channels:
            raise IndexError(f"channel {channel} of {self.n_channels}")
        return int(self._lib.uwspr_stream_buffered(self._h, channel))

    def pop_batch(self, max_windows: int):
        """-> (ri (W, 2, fl) float32, channels (W,) int32), W <= max_windows,
        in channel order."""
        out = np.empty((max_windows, 2, self.fl), dtype=np.float32)
        chans = np.empty(max_windows, dtype=np.int32)
        n = int(self._lib.uwspr_stream_pop_batch(
            self._h, out.ctypes.data, chans.ctypes.data, max_windows))
        return out[:n], chans[:n]


def num_threads() -> int:
    return int(load_windower().uwspr_stream_num_threads())


__all__ = ["NativeWindower", "SOURCE", "load_windower", "num_threads"]
