"""Streaming serve runtimes: continuous sample streams -> overlapped windows
-> decoded spots, with checkpoint/resume.

Counterpart of uwspr_tpu/pipeline/stream.py. Window semantics match the
reference's sliding_window_stream_to_pdu
(lib/sliding_window_stream_to_pdu_impl.cc:97-138): a ring buffer of
capacity capacity_windows*fl samples; once >= fl samples are buffered, a
120 s window is emitted and the ring advances by the 9 s hop (111 s
overlap), so every 111 s frame lies wholly inside some window.

- ``StreamDecoder``: one window per decode, engine "host" (WindowDecoder),
  "device" (DeviceDecoder), "hybrid" (DeviceDecoder, Fano on the host) or
  "auto" ("device" on a CUDA device, "host" on the CPU); with passes > 1
  each window is decoded again after the decoded frames are subtracted
  (pipeline/multipass.py);
- ``BatchedStreamDecoder``: the native C++ windower feeding fixed-width
  DeviceDecoder batches.

Every runtime names its device. On a CUDA device the device engines take
``with_serving_defaults`` for the fields left at their defaults, as the
JAX runtimes do on a TPU; on the CPU the config is used as given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from uwspr_tpu_torch.config import (PipelineConfig, StreamConfig,
                                    with_serving_defaults)
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.pipeline.decoder import DecodeResult, Spot, WindowDecoder
from uwspr_tpu_torch.pipeline.device_decoder import (DeviceDecoder,
                                                     DeviceDecoderOutput)
from uwspr_tpu_torch.pipeline.multipass import multipass_spots
from uwspr_tpu_torch.pipeline.native import NativeWindower
from uwspr_tpu_torch.protocol.messages import HashTable

ENGINES = ("host", "device", "hybrid", "auto")


class SlidingWindow:
    """Single-channel ring buffer with fl-window / shift-hop emission."""

    def __init__(self, cfg: StreamConfig | None = None):
        self.cfg = cfg or StreamConfig()
        self._buf = np.zeros(0, dtype=np.complex64)

    @property
    def hop(self) -> int:
        return self.cfg.shift * self.cfg.fs

    def push(self, samples: np.ndarray) -> list[np.ndarray]:
        """Append samples; return every complete window now available."""
        cap = self.cfg.capacity_windows * self.cfg.fl
        buf = np.concatenate(
            [self._buf, np.asarray(samples, dtype=np.complex64)])
        # circular-buffer overflow drops the oldest samples (the reference's
        # boost::circular_buffer of capacity C*fl)
        self._buf = buf[-cap:] if len(buf) > cap else buf
        out = []
        while len(self._buf) >= self.cfg.fl:
            out.append(self._buf[:self.cfg.fl].copy())
            self._buf = self._buf[self.hop:]
        return out

    def state(self) -> np.ndarray:
        return self._buf.copy()

    def restore(self, buf: np.ndarray) -> None:
        self._buf = np.asarray(buf, dtype=np.complex64).copy()


@dataclass
class StreamStats:
    windows: int = 0
    candidates: int = 0
    fano_attempts: int = 0
    spots: int = 0
    decode_seconds: float = 0.0

    def add(self, r: DecodeResult) -> None:
        self.windows += 1
        self.candidates += r.n_candidates
        self.fano_attempts += r.n_fano_attempts
        self.spots += len(r.spots)


def device_result(dec: DeviceDecoder, one: DeviceDecoderOutput,
                  hashtable: HashTable | None) -> DecodeResult:
    """One window's DeviceDecoder output -> DecodeResult."""
    r = DecodeResult(spots=dec.spots(one, hashtable))
    r.n_candidates = int(one.valid.sum())
    r.n_fano_attempts = int(one.fano_attempts)
    return r


def serving_config(config: PipelineConfig, device: torch.device,
                   batch_windows: int) -> PipelineConfig:
    """``with_serving_defaults(config, batch_windows)`` on a CUDA device,
    ``config`` itself on the CPU."""
    if device.type == "cuda":
        return with_serving_defaults(config, batch_windows)
    return config


class StreamDecoder:
    """Continuous decoder over one or many channels, one window per decode.

    engine: "host" (WindowDecoder), "device" (DeviceDecoder's per-window
    program), "hybrid" (the same with the Fano on the host) or "auto",
    which follows ``device``: "device" on CUDA, "host" on the CPU.
    passes > 1: successive interference cancellation between decodes of
    the window (stream.py:118-136)."""

    def __init__(self, config: PipelineConfig | None = None,
                 n_channels: int = 1, hashtable: HashTable | None = None,
                 engine: str = "auto", passes: int = 1, *,
                 device: str | torch.device):
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r} not in {ENGINES}")
        self.config = config or PipelineConfig()
        self.passes = passes
        self.device = resolve_device(device)
        if engine == "auto":
            engine = "device" if self.device.type == "cuda" else "host"
        self.engine = engine
        self.hashtable = hashtable if hashtable is not None else HashTable()
        if engine in ("device", "hybrid"):
            self._device = DeviceDecoder(
                serving_config(self.config, self.device, 1),
                device=self.device,
                fano_mode="host" if engine == "hybrid" else "device")
            self.decoder = None
        else:
            self._device = None
            self.decoder = WindowDecoder(self.config, device=self.device,
                                         hashtable=self.hashtable)
        self.windows = [SlidingWindow(self.config.stream)
                        for _ in range(n_channels)]
        self.stats = StreamStats()

    def _decode_once(self, window: np.ndarray) -> DecodeResult:
        if self._device is None:
            return self.decoder(window)
        return device_result(self._device, self._device(window),
                             self.hashtable)

    def _decode(self, window: np.ndarray) -> DecodeResult:
        if self.passes <= 1:
            return self._decode_once(window)
        # successive interference cancellation between passes: candidates
        # are the most of any pass, Fano attempts the sum over passes
        meta = {"cand": 0, "fano": 0}

        def decode_fn(z):
            r = self._decode_once(z)
            meta["cand"] = max(meta["cand"], r.n_candidates)
            meta["fano"] += r.n_fano_attempts
            return r.spots

        out = DecodeResult(spots=multipass_spots(window, decode_fn,
                                                 self.config,
                                                 passes=self.passes))
        out.n_candidates = meta["cand"]
        out.n_fano_attempts = meta["fano"]
        return out

    def push(self, samples: np.ndarray) -> list[tuple[int, DecodeResult]]:
        """samples: (n,) or (channels, n). Returns [(channel, result), ...]."""
        samples = np.atleast_2d(np.asarray(samples, dtype=np.complex64))
        results: list[tuple[int, DecodeResult]] = []
        for ch, row in enumerate(samples):
            for window in self.windows[ch].push(row):
                t0 = time.perf_counter()
                r = self._decode(window)
                self.stats.decode_seconds += time.perf_counter() - t0
                self.stats.add(r)
                results.append((ch, r))
        return results

    # -- checkpoint/resume (stream.py:154-178) -----------------------------

    def save_checkpoint(self, directory: str | os.PathLike) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez(os.path.join(directory, "ring_buffers.npz"),
                 **{f"ch{i}": w.state() for i, w in enumerate(self.windows)})
        self.hashtable.save(os.path.join(directory, "hashtable.txt"))
        with open(os.path.join(directory, "stats.json"), "w") as f:
            json.dump(dataclasses.asdict(self.stats), f)

    def load_checkpoint(self, directory: str | os.PathLike) -> None:
        with np.load(os.path.join(directory, "ring_buffers.npz")) as data:
            for i, w in enumerate(self.windows):
                key = f"ch{i}"
                if key in data:
                    w.restore(data[key])
        ht_path = os.path.join(directory, "hashtable.txt")
        if os.path.exists(ht_path):
            self.hashtable = HashTable.load(ht_path)
            if self.decoder is not None:
                self.decoder.hashtable = self.hashtable
        stats_path = os.path.join(directory, "stats.json")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                self.stats = StreamStats(**json.load(f))


class BatchedStreamDecoder:
    """Native C++ ingest and windowing + fixed-width batched device decode.

    The native windower (pipeline/native/stream_native.cc) ingests
    multichannel blocks and extracts ready windows straight into a batched
    (W, 2, fl) feed array, and one DeviceDecoder call of fixed width
    ``batch_windows`` decodes each batch. Short batches at flush are
    zero-padded to that width and the padding's results dropped.

    push() returns [(channel, DecodeResult), ...] for every batch that
    filled; flush() drains the remaining ready windows."""

    def __init__(self, config: PipelineConfig | None = None,
                 n_channels: int = 1, batch_windows: int = 32,
                 hashtable: HashTable | None = None,
                 fano_mode: str = "device", *,
                 device: str | torch.device):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        scfg = self.config.stream
        self.batch_windows = batch_windows
        self.hashtable = hashtable if hashtable is not None else HashTable()
        hop = scfg.shift * scfg.fs
        # the ring must hold a full batch of ready windows per channel, or
        # push() (which drains only full batches) would never fire and the
        # ring would drop samples forever: ``ready`` saturates at
        # (cap - fl)/hop + 1, so cap needs fl + (batch_windows - 1)*hop
        need = -(-(scfg.fl + (batch_windows - 1) * hop) // scfg.fl)
        self.windower = NativeWindower(n_channels, scfg.fl, hop,
                                       max(scfg.capacity_windows, need))
        self._device = DeviceDecoder(
            serving_config(self.config, self.device, batch_windows),
            device=self.device, fano_mode=fano_mode)
        self.stats = StreamStats()

    def _decode_batch(self, ri: np.ndarray, chans: np.ndarray):
        W = len(ri)
        if W < self.batch_windows:          # pad to the batch width
            ri = np.concatenate(
                [ri, np.zeros((self.batch_windows - W,) + ri.shape[1:],
                              dtype=ri.dtype)])
        t0 = time.perf_counter()
        out = self._device.decode_ri_batch(ri)
        self.stats.decode_seconds += time.perf_counter() - t0
        results = []
        for w in range(W):
            r = device_result(self._device, out.window(w), self.hashtable)
            self.stats.add(r)
            results.append((int(chans[w]), r))
        return results

    def _drain(self, full_only: bool):
        results = []
        while True:
            ready = self.windower.ready
            if ready == 0 or (full_only and ready < self.batch_windows):
                break
            ri, chans = self.windower.pop_batch(self.batch_windows)
            results.extend(self._decode_batch(ri, chans))
        return results

    def push(self, samples: np.ndarray):
        """samples: (n,) or (channels, n) complex, or planar (channels, 2,
        n). Decodes every full ``batch_windows``-wide batch now ready."""
        self.windower.push(np.atleast_2d(np.asarray(samples)))
        return self._drain(full_only=True)

    def flush(self):
        """Decode all remaining ready windows (zero-padded final batch)."""
        return self._drain(full_only=False)


@dataclass
class SpotAggregator:
    """Dedupe spots across overlapping windows: the same message within
    tolerance_hz is the same transmission."""

    tolerance_hz: float = 1.5
    seen: dict = field(default_factory=dict)
    unique: list[Spot] = field(default_factory=list)

    def add(self, spot: Spot) -> bool:
        # bucket by freq, but check the neighbour buckets with a real
        # |delta f| comparison: two decodes 0.02 Hz apart must not pass as
        # distinct because they straddle a bucket edge
        b = round(spot.freq / self.tolerance_hz)
        for nb in (b - 1, b, b + 1):
            prev = self.seen.get((spot.message, nb))
            if prev is not None and (abs(prev.freq - spot.freq)
                                     < self.tolerance_hz):
                return False
        self.seen[(spot.message, b)] = spot
        self.unique.append(spot)
        return True


__all__ = ["BatchedStreamDecoder", "ENGINES", "SlidingWindow",
           "SpotAggregator", "StreamDecoder", "StreamStats",
           "device_result", "serving_config"]
