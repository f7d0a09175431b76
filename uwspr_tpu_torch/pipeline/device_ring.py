"""Device-resident streaming ring: hop-sized ingest, full-window decode.

Counterpart of uwspr_tpu/pipeline/device_ring.py. A serving engine that
ships whole windows to the device sends every byte of the 111 s overlap
again at each hop: a (2, 45000) float32 window is 360,000 bytes per
channel, of which one hop (2 x 3375 float32) is 27,000 bytes of new data.
This engine keeps a (C, 2, fl) float32 ring on the device holding every
channel's newest window; each hop sends only the (C, 2, hop) block (or, with
ingest_dtype "int16", an int16 block and one float32 scale per channel,
dequantised on the device), shifts the ring by ``hop``, appends the block
and decodes all C channels as one DeviceDecoder batch.

The shift is ``torch.cat([cur[..., hop:], new], out=other)`` between two
preallocated rings that swap each hop: an in-place shift of one ring is a
partial self-overlap, and a fresh ring per hop would allocate C*2*fl*4
bytes every 9 s. Both rings live on the compute stream, so a hop's decode
has read its ring before the hop after next writes it again.

On a card each hop's decode is the decoder's captured program
(pipeline/captured.py), the counterpart of the JAX ring's one program per
hop (device_ring.py:94-118): the current ring is copied into the graph's
static input (C x 2 x fl x 4 bytes, 46 MB at C = 128, tens of
microseconds at the HBM rate), so one graph serves both ring buffers. The
shift and the append stay eager launches beside it, and ``push_hops``
replays it once a hop (JAX scans the K hops in one program).

``stage()`` starts a block's host-to-device copy from pinned memory on a
copy stream and records an event; ``push_hop`` makes the compute stream
wait on it. A numpy block given to ``push_hop`` or ``push_hops`` goes out
from pinned memory on the compute stream without blocking. Every entry
returns once its work is queued, without waiting for the card, as the JAX
ring's dispatch does; the returned packed tensor is the handle ``fetch``
turns into typed output, and ``fetch`` waits. Holding several handles
overlaps the hops' copies, decodes and fetches, the device OSD
(osd_depth > 0) included.

Tracing: while a profiler runs, ``push_hop`` is the host span
``uwspr.ring.push_hop`` and ``RingServe.push`` the span ``uwspr.ring.push``
with ``uwspr.ring.buffer`` (the host buffer) and ``uwspr.ring.results``
(the per-channel results) inside it (utils/profiler.py). ``hops`` counts
the decoded hops; a hop's number tags its spans.

Window alignment: the host windower emits the first fl samples once
ceil(fl/hop) hops arrived; the ring always decodes the newest fl samples,
so its windows start ceil(fl/hop)*hop - fl = 2250 samples later, and it
decodes nothing for the first ceil(fl/hop) - 1 = 13 hops.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from uwspr_tpu_torch.config import PipelineConfig, with_serving_defaults
from uwspr_tpu_torch.device import resolve_device, to_device
from uwspr_tpu_torch.pipeline.device_decoder import (DeviceDecoder,
                                                     DeviceDecoderOutput)
from uwspr_tpu_torch.pipeline.stream import StreamStats, device_result
from uwspr_tpu_torch.utils.profiler import span

INGEST_DTYPES = ("f32", "int16")


@dataclass
class StagedBlock:
    """A hop block whose host-to-device copy ``stage()`` started: the
    device block and scale (None for f32 ingest), the event the copy
    recorded (None on the CPU) and the pinned host buffers, kept until the
    block is pushed."""

    block: torch.Tensor
    scale: torch.Tensor | None
    event: torch.cuda.Event | None
    host: tuple


class DeviceRingDecoder:
    """Hop-fed, device-resident multichannel streaming decoder.

        ring = DeviceRingDecoder(n_channels=C, device="cuda")
        for block in stream:            # (C, hop) complex or (C, 2, hop)
            h = ring.push_hop(block)    # None until the ring holds fl
            if h is not None:           # samples
                out = ring.fetch(h)     # DeviceDecoderOutput, axis 0 channel

    apply_serving_defaults None means: on a CUDA device."""

    def __init__(self, config: PipelineConfig | None = None,
                 n_channels: int = 1, fano_mode: str = "device",
                 apply_serving_defaults: bool | None = None,
                 ingest_dtype: str = "f32", *,
                 device: str | torch.device):
        if ingest_dtype not in INGEST_DTYPES:
            raise ValueError(f"ingest_dtype {ingest_dtype!r} not in "
                             f"{INGEST_DTYPES}")
        self.device = resolve_device(device)
        self.config = config or PipelineConfig()
        scfg = self.config.stream
        self.n_channels = n_channels
        self.fl = scfg.fl
        self.hop = scfg.shift * scfg.fs
        self.ingest_dtype = ingest_dtype
        if apply_serving_defaults is None:
            apply_serving_defaults = self.device.type == "cuda"
        dcfg = (with_serving_defaults(self.config, n_channels)
                if apply_serving_defaults else self.config)
        self.decoder = DeviceDecoder(dcfg, device=self.device,
                                     fano_mode=fano_mode)
        self._rings = [torch.zeros((n_channels, 2, self.fl),
                                   dtype=torch.float32, device=self.device)
                       for _ in range(2)]
        self._cur = 0
        self._filled = 0
        self.hops = 0           # decoded hops so far
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    # -- ingest -------------------------------------------------------------

    def _as_blocks(self, block: np.ndarray):
        """-> (block (C, 2, hop) float32 or int16, scale (C,) float32): the
        quantiser of device_ring.py:123-142, bit for bit."""
        C, hop = self.n_channels, self.hop
        block = np.asarray(block)
        if np.iscomplexobj(block):
            block = np.stack([block.real.astype(np.float32),
                              block.imag.astype(np.float32)], axis=-2)
        if block.shape != (C, 2, hop):
            raise ValueError(
                f"hop block must be ({C}, [2,] {hop}), got {block.shape}")
        if self.ingest_dtype == "f32":
            return (np.ascontiguousarray(block, dtype=np.float32),
                    np.ones(C, np.float32))
        if block.dtype == np.int16:
            # caller pre-quantised: unit scale (they own the scaling)
            return np.ascontiguousarray(block), np.ones(C, np.float32)
        peak = np.abs(block).reshape(C, -1).max(axis=1).astype(np.float32)
        scale = np.where(peak > 0, peak / 32767.0, 1.0).astype(np.float32)
        q = np.round(block / scale[:, None, None]).astype(np.int16)
        return np.ascontiguousarray(q), scale

    def _host_tensors(self, block: np.ndarray, scale: np.ndarray):
        """Host tensors of one block (or a stack of blocks) to send: f32
        ingest sends the block alone, int16 the block and its scales."""
        b = torch.from_numpy(block)
        return (b, None) if self.ingest_dtype == "f32" else (
            b, torch.from_numpy(scale))

    def _upload(self, block: np.ndarray, scale: np.ndarray):
        b, s = self._host_tensors(block, scale)
        return (to_device(b, self.device),
                None if s is None else to_device(s, self.device))

    def stage(self, block) -> StagedBlock:
        """Start the host-to-device copy of a future hop block now, from
        pinned memory on the copy stream (on a CUDA device), so that it
        overlaps the current decode; pass the result to push_hop. Returns
        once the copy is queued, without waiting for the card."""
        b, s = self._host_tensors(*self._as_blocks(block))
        if self._copy_stream is None:
            return StagedBlock(b, s, None, ())
        host = tuple(x.pin_memory() for x in (b, s) if x is not None)
        with torch.cuda.stream(self._copy_stream):
            dev = [x.to(self.device, non_blocking=True) for x in host]
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return StagedBlock(dev[0], dev[1] if len(dev) > 1 else None, event,
                           host)

    def _staged(self, staged: StagedBlock):
        """The device tensors of a staged block, made safe to read on the
        compute stream."""
        if staged.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.event)
            for x in (staged.block, staged.scale):
                if x is not None:
                    x.record_stream(stream)
        return staged.block, staged.scale

    def _append(self, new: torch.Tensor, scale: torch.Tensor | None
                ) -> torch.Tensor:
        """Shift the ring left by hop and append ``new`` into the other ring
        buffer, which becomes the current one; returns it."""
        if scale is not None:
            new = new.to(torch.float32) * scale[:, None, None]
        cur, nxt = self._rings[self._cur], self._rings[1 - self._cur]
        torch.cat([cur[..., self.hop:], new], dim=-1, out=nxt)
        self._cur = 1 - self._cur
        return nxt

    def next_hop(self) -> int | None:
        """The number the next pushed hop decodes under, or None while it
        would only fill the ring."""
        return self.hops if self._filled + self.hop >= self.fl else None

    def push_hop(self, block) -> torch.Tensor | None:
        """Ingest one hop of new samples for every channel.

        block: (C, hop) complex, (C, 2, hop) float32 real/imag, a
        pre-quantised (C, 2, hop) int16 block (unit scale, with
        ingest_dtype "int16"), or a StagedBlock from stage(). Returns the
        packed decode of all channels on the device once the ring holds a
        full window, else None (prefill). Returns once the hop's copy,
        shift and decode are queued, without waiting for the card; ``fetch``
        waits for the handle."""
        with span("ring.push_hop", self.next_hop()):
            if isinstance(block, StagedBlock):
                b, s = self._staged(block)
            else:
                b, s = self._upload(*self._as_blocks(block))
            ring = self._append(b, s)
            self._filled += self.hop
            if self._filled < self.fl:
                return None
            self.hops += 1
            return self.decoder.decode_windows_ri(ring)

    def push_hops(self, blocks) -> torch.Tensor:
        """Ingest K hops at once with one host-to-device copy, decoding
        after each; returns the packed (K, C, ...) results. The ring must
        already be full (prefill with push_hop). blocks: (K, C, hop)
        complex or (K, C, 2, hop) float32/int16. Returns once the K hops
        are queued, without waiting for the card, as push_hop does."""
        if self._filled + self.hop < self.fl:
            raise RuntimeError("prefill the ring with push_hop first")
        blocks = np.asarray(blocks)
        staged = [self._as_blocks(blk) for blk in blocks]
        b, s = self._upload(np.stack([x[0] for x in staged]),
                            np.stack([x[1] for x in staged]))
        outs = []
        for k in range(len(staged)):
            ring = self._append(b[k], None if s is None else s[k])
            outs.append(self.decoder.decode_windows_ri(ring))
        self._filled += len(staged) * self.hop
        self.hops += len(staged)
        return torch.stack(outs)

    # -- results ------------------------------------------------------------

    def fetch(self, handle: torch.Tensor) -> DeviceDecoderOutput:
        """A push_hop or push_hops handle -> DeviceDecoderOutput (leading
        axes: hop for push_hops, then channel)."""
        return self.decoder.fetch(handle)

    def spots(self, out: DeviceDecoderOutput, hashtable=None):
        """(channel, Spot) pairs of one fetched output; a push_hops output
        yields the union over its hops (out.window(k) is hop k)."""
        if out.success.ndim > 2:
            results = []
            for k in range(out.success.shape[0]):
                results.extend(self.spots(out.window(k), hashtable))
            return results
        return [(c, s) for c in range(self.n_channels)
                for s in self.decoder.spots(out.window(c), hashtable)]

    # -- checkpoint/resume ----------------------------------------------------

    def state(self) -> dict:
        # a copy: on the CPU .numpy() would share the live ring's memory
        return {"ring": self._rings[self._cur].to("cpu", copy=True).numpy(),
                "filled": self._filled}

    def restore(self, state: dict) -> None:
        ring = np.asarray(state["ring"], np.float32)
        if ring.shape != (self.n_channels, 2, self.fl):
            raise ValueError(f"ring state shape {ring.shape} != "
                             f"{(self.n_channels, 2, self.fl)}")
        self._rings[self._cur].copy_(torch.from_numpy(ring))
        self._filled = int(state["filled"])


class RingServe:
    """StreamDecoder-interface adapter over DeviceRingDecoder: push
    (channels, n) complex blocks of any length, get [(channel,
    DecodeResult)] as full windows decode. Buffers to hop alignment on the
    host; windowing and decoding are on the device (hop-only ingest)."""

    def __init__(self, config: PipelineConfig | None = None,
                 n_channels: int = 1, hashtable=None,
                 fano_mode: str = "device",
                 apply_serving_defaults: bool | None = None,
                 ingest_dtype: str = "f32", *,
                 device: str | torch.device):
        self.ring = DeviceRingDecoder(
            config, n_channels=n_channels, fano_mode=fano_mode,
            apply_serving_defaults=apply_serving_defaults,
            ingest_dtype=ingest_dtype, device=device)
        self.config = self.ring.config
        self.hashtable = hashtable
        self.stats = StreamStats()
        self._buf = np.zeros((n_channels, 0), np.complex64)

    def push(self, samples: np.ndarray):
        """Buffer ``samples`` and decode every whole hop they complete. The
        span ``uwspr.ring.push`` carries the number of the push's first
        hop when that hop decodes."""
        samples = np.atleast_2d(np.asarray(samples))
        ring, hop = self.ring, self.ring.hop
        first = (ring.next_hop()
                 if self._buf.shape[1] + samples.shape[1] >= hop else None)
        with span("ring.push", first):
            with span("ring.buffer"):
                self._buf = np.concatenate(
                    [self._buf, samples.astype(np.complex64)], axis=1)
            results = []
            while self._buf.shape[1] >= hop:
                t0 = time.perf_counter()
                n = ring.next_hop()
                with span("ring.buffer"):
                    block, self._buf = self._buf[:, :hop], self._buf[:, hop:]
                h = ring.push_hop(block)
                if h is None:
                    continue
                out = ring.fetch(h)
                self.stats.decode_seconds += time.perf_counter() - t0
                with span("ring.results", n):
                    for c in range(ring.n_channels):
                        r = device_result(ring.decoder, out.window(c),
                                          self.hashtable)
                        self.stats.add(r)
                        results.append((c, r))
            return results

    def flush(self):
        return []


__all__ = ["DeviceRingDecoder", "INGEST_DTYPES", "RingServe", "StagedBlock"]
