"""uwspr-torch command-line interface: the port's user-facing surface.

    python -m uwspr_tpu_torch.cli decode capture.c2
    python -m uwspr_tpu_torch.cli decode capture.wav
    python -m uwspr_tpu_torch.cli encode "VE3EMB" "FN25" 30 -o frame.c2
    python -m uwspr_tpu_torch.cli sweep --snr -15 -30 -1 --trials 20
    python -m uwspr_tpu_torch.cli serve --channels 4 --windows 30
    python -m uwspr_tpu_torch.cli --device cpu decode capture.c2

Counterpart of uwspr_tpu/cli.py, with its subcommands and flags, except:

- ``--device {cuda,cpu}`` (default cuda, accepted before or after the
  subcommand) names the device; a machine without CUDA exits with
  ``resolve_device``'s message unless ``--device cpu`` is given. Nothing
  falls back. ``--engine auto`` is "device" on CUDA and "host" on the CPU,
  and on CUDA the device and hybrid engines of ``decode`` take
  ``with_serving_defaults(config, 1)``.
- ``serve`` takes the soundcard only for ``--input audio`` or
  ``audio:<device>``; any other name is a file. ``--maxcycles``,
  ``--jiggles`` and ``--osd-depth`` reach every runtime.
- ``serve --mesh CxT`` runs one torch.distributed rank per (channel,
  time) shard and names its backend, ``--dist-backend nccl`` (a card per
  rank) or ``gloo`` (the CPU, or ranks that share a card); nothing chooses
  one. A mesh of more than one rank runs under a launcher, ``python -m
  torch.distributed.run --nproc-per-node C*T``; ``1x1`` runs in a world of
  one. Every rank reads the synthetic and file sources itself; rank 0
  reads stdin and the soundcard and broadcasts each block. Rank 0 alone
  prints and logs.
- The GRC live receiver reads s16 from stdin only when no capture backend
  opens; an error during capture propagates.
- ``decode`` and ``serve`` close with the lanes the device engine's lane
  caps dropped (the packed ``fano_overflow``, refine overflow included).
- ``warmup`` builds the CUDA kernels and the g++ libraries, then runs one
  zero batch per width and engine, which on a card captures the serving
  program; there is no compile cache to fill (a graph lives as long as its
  process).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig,
                                    PipelineConfig, with_serving_defaults)
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.frontend.downconvert import (StreamingDownconverter,
                                                  downconvert, upconvert)
from uwspr_tpu_torch.io.c2file import (apply_sim_drift, array_stream,
                                       c2_stream, read_c2, write_c2)
from uwspr_tpu_torch.io.channel import noise_sigma
from uwspr_tpu_torch.io.wavfile import read_wav, write_wav
from uwspr_tpu_torch.protocol.messages import HashTable
from uwspr_tpu_torch.protocol.modulate import synthesize_frame
from uwspr_tpu_torch.utils.spotlog import SpotLogger

DEVICES = ("cuda", "cpu")


def _device(args) -> torch.device:
    """The named device, or exit with resolve_device's reason."""
    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"uwspr-torch: {e} (pass --device cpu to run on "
                         "the CPU)") from None


def _args_config(args):
    """PipelineConfig from CLI tuning flags (None = library defaults)."""
    overrides = {}
    if getattr(args, "osd_depth", 0):
        overrides["osd_depth"] = args.osd_depth
    if getattr(args, "maxcycles", None):
        overrides["maxcycles"] = args.maxcycles
    if getattr(args, "jiggles", None):
        overrides["n_jiggles"] = args.jiggles
    if not overrides:
        return None
    return PipelineConfig(demod=DemodConfig(**overrides))


def _engine_name(engine: str, device: torch.device) -> str:
    if engine == "auto":
        return "device" if device.type == "cuda" else "host"
    return engine


class _Engine:
    """One window at a time through the engine ``args.engine`` names.

    'device': DeviceDecoder's per-window program (the selection and Fano
    kernels on a card); 'hybrid': the same through the gates, the Fano on
    the host (native C++); 'host': WindowDecoder (the probe and selection
    kernels on a card). ``lanes_shed`` sums the lanes the device engine's
    caps dropped."""

    def __init__(self, args, hashtable: HashTable, device: torch.device):
        self.name = _engine_name(args.engine, device)
        self.hashtable = hashtable
        self.lanes_shed = 0
        config = _args_config(args)
        if self.name in ("device", "hybrid"):
            from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
            if device.type == "cuda":
                config = with_serving_defaults(config or PipelineConfig(), 1)
            self.decoder = DeviceDecoder(
                config, device=device,
                fano_mode="host" if self.name == "hybrid" else "device")
        else:
            from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
            self.decoder = WindowDecoder(config, device=device,
                                         hashtable=hashtable)
        self.config = self.decoder.config

    def spots(self, window: np.ndarray):
        if self.name == "host":
            return self.decoder(window).spots
        out = self.decoder(window)
        self.lanes_shed += int(out.fano_overflow)
        return self.decoder.spots(out, self.hashtable)


def _logger(args):
    if args.messagelog or args.jsonl or args.spots or args.allwspr:
        return SpotLogger(args.messagelog, args.jsonl, args.spots,
                          args.allwspr)
    return None


def _read_wav_checked(path, expected_rate: int = 12000):
    """read_wav + sample-rate validation: the downconversion chain is
    designed for 12 kS/s audio; silently decoding a 48 kHz file would
    produce zero spots with no hint why."""
    audio, rate = read_wav(path)
    if rate != expected_rate:
        raise SystemExit(f"{path}: {rate} S/s audio; the frontend expects "
                         f"{expected_rate} S/s")
    return audio


def _cmd_decode(args):
    from uwspr_tpu_torch.pipeline.stream import SpotAggregator
    from uwspr_tpu_torch.utils.profiler import trace

    device = _device(args)
    ht = HashTable.load(args.hashtable) if args.hashtable else HashTable()
    engine = _Engine(args, ht, device)
    decode_spots = engine.spots
    if args.passes > 1:
        from uwspr_tpu_torch.pipeline.multipass import multipass_spots

        def decode_spots(w):
            return multipass_spots(w, engine.spots, engine.config,
                                   passes=args.passes)
    logger = _logger(args)

    if args.wav or str(args.file).lower().endswith(".wav"):
        z = downconvert(_read_wav_checked(args.file), device=device)
    else:
        z = read_c2(args.file).samples
    if args.sim_drift:
        # synthetic linear drift injection to exercise the drift search
        # (reference: c2file_source drift_rate, c2file_source_impl.cc:117-133)
        z = apply_sim_drift(z, args.sim_drift)

    fl = engine.config.stream.fl
    hop = engine.config.stream.shift * engine.config.stream.fs
    n_windows = max(1, (len(z) - fl) // hop + 1)
    t0 = time.time()
    total = 0
    agg = SpotAggregator()
    with trace(args.trace_dir, device=device):
        for w in range(n_windows):
            window = z[w * hop: w * hop + fl]
            if len(window) < fl:
                break
            for s in decode_spots(window):
                if not args.all_spots and not agg.add(s):
                    continue   # same message already seen in an
                               # overlapping window / adjacent candidate
                total += 1
                tag = f", osd{s.osd}" if s.osd else ""
                print(f"{s.message}    (freq {s.freq:+.2f} Hz, SNR "
                      f"{s.snr:.1f} dB, sync {s.sync:.2f}, "
                      f"{'nonlinear' if s.mode else 'linear'}{tag})")
                if logger:
                    logger.log(s)
    dt = time.time() - t0
    print(f"# {total} spot(s) from {n_windows} window(s) in {dt:.2f}s "
          f"({engine.name} engine on {device.type}; {engine.lanes_shed} "
          f"lanes shed by the lane caps)", file=sys.stderr)
    if logger:
        logger.close()
    if args.hashtable:
        ht.save(args.hashtable)


def _cmd_encode(args):
    z = synthesize_frame(args.callsign, args.grid, args.power,
                         start_sample=args.start,
                         freq_offset=args.freq_offset)
    write_c2(args.output, z, name=args.callsign[:13])
    print(f"wrote {args.output}: '{args.callsign} {args.grid} {args.power}'"
          f" at {args.freq_offset:+.2f} Hz, start sample {args.start}")


def _cmd_c2towav(args):
    """c2 baseband -> 12 kS/s wav at 1500 Hz (examples/c2ToWaveFile.grc)."""
    z = read_c2(args.file).samples
    if args.drift_rate:
        z = apply_sim_drift(z, args.drift_rate)
    audio = upconvert(z, amplitude=args.amplitude)
    write_wav(args.output, audio, 12000)
    print(f"wrote {args.output}: {len(audio)} samples @ 12 kS/s")


def _cmd_wavtoc2(args):
    """12 kS/s wav -> c2 baseband capture (inverse of c2towav), downconverted
    on --device."""
    device = _device(args)
    z = downconvert(_read_wav_checked(args.file), device=device)
    write_c2(args.output, z[:45000])
    print(f"wrote {args.output}")


def _cmd_sweep(args):
    from uwspr_tpu_torch.pipeline.sweep import snr_sweep

    device = _device(args)
    snrs = np.arange(args.snr[0], args.snr[1] + args.snr[2] / 2, args.snr[2])
    interference = None
    if args.whales:
        interference = downconvert(_read_wav_checked(args.whales),
                                   device=device)

    def progress(snr, t, ok):
        print(f"\rSNR {snr:+6.1f} dB: trial {t + 1}, {ok} ok", end="",
              file=sys.stderr)

    engine = _engine_name(args.engine, device)
    r = snr_sweep(snrs, trials=args.trials, interference=interference,
                  progress=progress, seed=args.seed, engine=engine,
                  config=_args_config(args), device=device)
    print("", file=sys.stderr)
    doc = {"trials": r.trials, "seed": args.seed, "engine": engine,
           "backend": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
           "callsign": "VE3EMB", "grid": "FN25", "power": 30,
           "snr_convention": "2500 Hz reference bandwidth",
           "randomized": "freq offset +/-5 Hz, start 0..2 s per trial",
           "decode_rate": r.as_dict()}
    print(json.dumps(doc))
    if args.output:
        with open(args.output, "w") as f:
            f.write(json.dumps(doc, indent=1) + "\n")
        print(f"wrote {args.output}", file=sys.stderr)


def _synthetic_source(args, hop, info):
    """Self-generated traffic: frames stream contiguously across hop
    boundaries (a 111 s frame spans ~13 hops), riding on hop-by-hop AWGN
    at the requested SNR — the streaming analogue of the reference's
    closed-loop flowgraph (examples/WaveFilePlusNoiseDecode.grc). The
    blocks equal uwspr_tpu.cli's for the same arguments."""
    rng = np.random.default_rng(0)
    sigma = noise_sigma(args.snr)
    pending = [np.zeros(0, np.complex64) for _ in range(args.channels)]
    for _ in range(args.windows):
        block = (rng.normal(scale=sigma, size=(args.channels, hop))
                 + 1j * rng.normal(scale=sigma, size=(args.channels, hop))
                 ).astype(np.complex64)
        for ch in range(args.channels):
            if len(pending[ch]) == 0 and rng.random() < args.duty:
                pending[ch] = synthesize_frame(
                    "VE3EMB", "FN25", 30, pad_to=None,
                    freq_offset=rng.uniform(-5, 5)).copy()
                info["sent"] += 1
            n = min(hop, len(pending[ch]))
            if n:
                block[ch, :n] += pending[ch][:n]
                pending[ch] = pending[ch][n:]
        yield block


def _stdin_source(args, hop):
    """Live external samples on stdin — the path that makes ``serve`` a
    real receiver (reference flagship examples/AudioSourceDecode.grc):
    cf32 = interleaved float32 I/Q at 375 S/s baseband; s16 = 12 kS/s
    signed 16-bit mono audio, downconverted block-by-block with carried
    filter/mixer state."""
    if args.format == "cf32":
        buf = b""
        while True:
            data = sys.stdin.buffer.read(8 * hop)
            if not data:
                return
            buf += data
            n = (len(buf) // 8) * 8
            if n == 0:
                continue
            iq = np.frombuffer(buf[:n], "<f4")
            buf = buf[n:]
            yield (iq[0::2] + 1j * iq[1::2]).astype(np.complex64)[None, :]
    else:                                   # s16 audio at 12 kS/s
        dc = StreamingDownconverter()
        buf = b""
        while True:
            data = sys.stdin.buffer.read(2 * 32 * hop)
            if not data:
                return
            buf += data
            n = (len(buf) // 2) * 2         # whole samples only
            audio = np.frombuffer(buf[:n], "<i2").astype(np.float32) / 32768.0
            buf = buf[n:]
            z = dc.push(audio)
            if len(z):
                yield z[None, :]


def _is_soundcard(name: str) -> bool:
    """``audio`` or ``audio:<device>``; ``audio1.wav`` is a file."""
    return name == "audio" or name.startswith("audio:")


def _audio_capture_source(args, hop):
    """Live soundcard capture — the reference's ``audio_source``
    (examples/AudioSourceDecode.grc). ``--input audio`` or
    ``--input audio:<device>`` opens io.audio.AudioCapture (sounddevice /
    pyaudio / ctypes-ALSA / arecord, first available) at 12 kS/s s16
    mono and downconverts block-by-block like the stdin path. Exits with
    every probed backend named when no soundcard stack exists (use '-'
    with an external recorder piping s16 then)."""
    from uwspr_tpu_torch.io.audio import AudioCapture, AudioUnavailable

    device = args.input.split(":", 1)[1] if ":" in args.input else None
    try:
        cap = AudioCapture(rate=12000, device=device,
                           blocksize=2 * 32 * hop // 2)
    except AudioUnavailable as e:
        raise SystemExit(
            f"{e}\nhint: pipe an external recorder instead, e.g. "
            "`arecord -f S16_LE -r 12000 -c 1 -t raw | uwspr-torch serve "
            "--input - --format s16`") from None
    print(f"# audio capture via {cap.backend_name}"
          + (f" (device {device})" if device else ""), flush=True)
    dc = StreamingDownconverter()
    with cap:
        for block in cap:
            if not len(block):
                continue
            z = dc.push(block.astype(np.float32) / 32768.0)
            if len(z):
                yield z[None, :]


def _file_source(args, hop, device):
    """Follow a capture file (.c2 or .wav), optionally looping (the
    reference c2file_source's ``repeat``); --windows bounds the repeated
    stream."""
    limit = args.windows * hop if args.repeat else None
    if str(args.input).lower().endswith(".wav"):
        z = downconvert(_read_wav_checked(args.input), device=device)
        src = array_stream(z, repeat=args.repeat, block=hop)
    else:
        src = c2_stream(args.input, repeat=args.repeat,
                        drift_rate=args.sim_drift, block=hop)
    sent = 0
    for chunk in src:
        if limit is not None and sent >= limit:
            return
        sent += len(chunk)
        yield chunk[None, :]


def _serve_source(args, hop, info, device):
    if args.input == "synthetic":
        return _synthetic_source(args, hop, info)
    if args.input == "-":
        return _stdin_source(args, hop)
    if _is_soundcard(args.input):
        return _audio_capture_source(args, hop)
    return _file_source(args, hop, device)


def _parse_mesh(spec: str):
    """'CxT' -> (n_channel, n_time) with a helpful error."""
    try:
        c, t = spec.lower().split("x")
        c, t = int(c), int(t)
    except ValueError:
        c = t = 0
    if c < 1 or t < 1:
        raise SystemExit(f"--mesh expects CxT (e.g. 2x4), got {spec!r}")
    return c, t


def _broadcast_source(source, rank: int):
    """Rank 0 reads ``source`` (None elsewhere) and broadcasts each block;
    every rank yields the same blocks. The end of the stream goes out as
    None."""
    import torch.distributed as dist
    blocks = iter(source) if rank == 0 else None
    while True:
        box = [next(blocks, None) if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return
        yield box[0]


def _cmd_serve_mesh(args):
    """serve --mesh CxT: the stream sharded over a (channel, time) mesh of
    torch.distributed ranks and decoded by ShardedStreamDecoder, as
    uwspr_tpu/cli.py:349-407 does over a jax mesh. External inputs are one
    channel, replicated across --channels."""
    import torch.distributed as dist

    from uwspr_tpu_torch.parallel.distributed import (SharedDeviceError,
                                                      global_mesh, initialize)
    from uwspr_tpu_torch.parallel.mesh import ShardedStreamDecoder

    if args.runtime == "native":
        raise SystemExit("--mesh uses the sharded runtime; drop --runtime "
                         "native")
    if args.passes > 1:
        raise SystemExit("--passes is a single-device (python runtime) "
                         "feature; drop it for --mesh")
    device = _device(args)
    engine = args.engine
    if engine == "auto":
        # the device engine on a card; on the CPU its plain Fano walks a
        # cut frame's lanes to the whole budget, so the host Fano (hybrid)
        # is the default there, as the JAX CLI takes hybrid off the TPU
        engine = "device" if device.type == "cuda" else "hybrid"
    elif engine not in ("device", "hybrid"):
        raise SystemExit("--mesh serves through the sharded device engines; "
                         "use --engine device or hybrid")
    if args.dist_backend is None:
        raise SystemExit("--mesh needs --dist-backend: nccl (one rank per "
                         "card) or gloo (the CPU, or ranks that share a "
                         "card)")
    if args.dist_backend == "nccl" and device.type != "cuda":
        raise SystemExit("--dist-backend nccl needs --device cuda")
    n_ch, n_time = _parse_mesh(args.mesh)
    external = args.input != "synthetic"
    channels = max(1, args.channels) if external else args.channels
    if channels % n_ch:
        raise SystemExit(f"--channels {channels} must be a multiple of the "
                         f"mesh channel axis {n_ch}")
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not launched and n_ch * n_time > 1:
        raise SystemExit(
            f"--mesh {args.mesh} runs {n_ch * n_time} ranks, one process "
            f"each: start it under a launcher, python -m "
            f"torch.distributed.run --nproc-per-node {n_ch * n_time} -m "
            f"uwspr_tpu_torch.cli serve --mesh {args.mesh} ...")
    with contextlib.ExitStack() as stack:
        if launched:
            created = initialize(args.dist_backend)
        else:                               # a world of one
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            created = initialize(args.dist_backend,
                                 init_method=f"file://{tmp}/store",
                                 world_size=1, rank=0)
        if created:
            stack.callback(dist.destroy_process_group)
        try:
            mesh = global_mesh(n_ch, n_time, device.type)
        except (ValueError, SharedDeviceError) as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}") from None
        rank = dist.get_rank()
        ht = HashTable.load(args.hashtable) if args.hashtable else HashTable()
        sd = ShardedStreamDecoder(_args_config(args), mesh,
                                  n_channels=channels,
                                  wins_per_shard=args.wins_per_shard,
                                  hashtable=ht, engine=engine)
        info = {"sent": 0}
        if args.input == "-" or _is_soundcard(args.input):
            source = _broadcast_source(
                _serve_source(args, sd.hop, info, device) if rank == 0
                else None, rank)
        else:
            source = _serve_source(args, sd.hop, info, device)
        logger = _logger(args) if rank == 0 else None

        def emit(results):
            if rank:
                return
            for ch, w, s in results:
                print(f"ch{ch} w{w}: {s.message} ({s.freq:+.2f} Hz)",
                      flush=True)
                if logger:
                    logger.log(s)

        t0 = time.time()
        for block in source:
            if block.shape[0] != channels:
                block = np.broadcast_to(block, (channels, block.shape[-1]))
            emit(sd.push(block))
        emit(sd.flush())
        dt = time.time() - t0
        if rank:
            return
        st = sd.stats
        sent = f"{info['sent']} frames sent, " if not external else ""
        print(f"# mesh {n_ch}x{n_time} ({engine}): {st.steps} steps, "
              f"{st.windows} windows, {sent}{st.spots} spots, "
              f"{st.windows * 45000 / max(dt, 1e-9):.0f} window-samples/s",
              file=sys.stderr)
        if logger:
            logger.close()
        if args.hashtable:
            ht.save(args.hashtable)


def _cmd_serve(args):
    """Continuous receiver: decode a live or synthetic multichannel stream.

    --input synthetic (default) generates closed-loop traffic; '-' reads
    raw samples from stdin; 'audio' or 'audio:<device>' captures from the
    soundcard; any other value is a .c2/.wav path to follow (--repeat to
    loop). External inputs are single-channel."""
    if args.mesh:
        return _cmd_serve_mesh(args)
    device = _device(args)
    external = args.input != "synthetic"
    channels = 1 if external else args.channels
    ht = HashTable.load(args.hashtable) if args.hashtable else HashTable()
    config = _args_config(args)
    fano_mode = "host" if args.engine == "hybrid" else "device"
    if args.runtime in ("native", "ring") and args.passes > 1:
        # the device engine's batch program runs the passes and subtracts
        # between them on the device (MultipassConfig); the python runtime
        # keeps the host subtraction (StreamDecoder(passes=...))
        if fano_mode == "host":
            raise SystemExit("--passes with --runtime native or ring needs "
                             "--engine device (the hybrid engine decodes "
                             "one pass), or --runtime python")
        base = config or PipelineConfig()
        config = dataclasses.replace(base, multipass=dataclasses.replace(
            base.multipass, passes=args.passes))
    if args.runtime == "native":
        if args.engine == "host":
            raise SystemExit("--runtime native serves through the batched "
                             "device engines; use --engine device/hybrid, "
                             "or --runtime python for host orchestration")
        from uwspr_tpu_torch.pipeline.stream import BatchedStreamDecoder
        sd = BatchedStreamDecoder(config, n_channels=channels,
                                  batch_windows=args.batch, hashtable=ht,
                                  fano_mode=fano_mode, device=device)
        hop = sd.config.stream.shift * sd.config.stream.fs
    elif args.runtime == "ring":
        if args.engine == "host":
            raise SystemExit("--runtime ring serves through the batched "
                             "device engines; use --engine device/hybrid")
        from uwspr_tpu_torch.pipeline.device_ring import RingServe
        sd = RingServe(config, n_channels=channels, hashtable=ht,
                       fano_mode=fano_mode, device=device)
        hop = sd.ring.hop
    else:
        from uwspr_tpu_torch.pipeline.stream import StreamDecoder
        sd = StreamDecoder(config, n_channels=channels, hashtable=ht,
                           engine=args.engine, passes=args.passes,
                           device=device)
        hop = sd.windows[0].hop
    logger = _logger(args)
    info = {"sent": 0}
    source = _serve_source(args, hop, info, device)

    def emit(results):
        for ch, r in results:
            for s in r.spots:
                print(f"ch{ch}: {s.message} ({s.freq:+.2f} Hz)", flush=True)
                if logger:
                    logger.log(s)

    t0 = time.time()
    for block in source:
        emit(sd.push(block))
    if args.runtime == "native":
        emit(sd.flush())
    dt = time.time() - t0
    st = sd.stats
    sent = f"{info['sent']} frames sent, " if not external else ""
    print(f"# {st.windows} windows, {sent}{st.spots} spots, "
          f"{st.windows * 45000 / max(dt, 1e-9):.0f} window-samples/s, "
          f"{st.lanes_shed} lanes shed by the lane caps", file=sys.stderr)
    if logger:
        logger.close()
    if args.hashtable:
        ht.save(args.hashtable)


def _grc_receiver_source(src, cfg, hop, windows_limit, device):
    """SourceSpec -> generator of (1, hop) baseband blocks."""
    if src.kind == "c2":
        limit = windows_limit * hop if src.repeat else None
        sent = 0
        for chunk in c2_stream(src.files[0], repeat=src.repeat,
                               drift_rate=src.drift_rate, block=hop):
            if limit is not None and sent >= limit:
                return
            sent += len(chunk)
            yield chunk[None, :]
        return
    if src.kind in ("wav", "wav_mix"):
        tracks = []
        for path, gain in zip(src.files, src.gains):
            audio, rate = read_wav(path)
            if rate != cfg.frontend.audio_rate:
                raise SystemExit(f"{path}: {rate} S/s, flowgraph expects "
                                 f"{cfg.frontend.audio_rate}")
            tracks.append(audio * np.float32(gain))
        # the longest file sets the stream length; shorter files loop over
        # it (GRC repeat=True semantics), independent of XML block order
        target = max(len(a) for a in tracks)
        mixed = np.zeros(target, np.float32)
        for a in tracks:
            reps = int(np.ceil(target / len(a)))
            mixed += np.tile(a, reps)[:target]
        z = downconvert(mixed, cfg.frontend, device=device)
        limit = windows_limit * hop if src.repeat else len(z)
        sent = 0
        for chunk in array_stream(z, repeat=src.repeat, block=hop):
            if sent >= limit:
                return
            yield chunk[None, :]
            sent += len(chunk)
        return
    # live audio (AudioSourceDecode.grc): a real soundcard via
    # io.audio.AudioCapture when a capture backend opens, else s16 on
    # stdin (the portable transport an external recorder can feed); an
    # error during capture propagates
    from uwspr_tpu_torch.io.audio import AudioCapture, AudioUnavailable
    dc = StreamingDownconverter(cfg.frontend)
    decim = cfg.frontend.decimation
    try:
        cap = AudioCapture(rate=cfg.frontend.audio_rate,
                           blocksize=decim * hop)
    except AudioUnavailable:
        cap = None
    if cap is not None:
        print(f"# audio capture via {cap.backend_name}", file=sys.stderr)
        with cap:
            for block in cap:
                if not len(block):
                    continue
                z = dc.push(block.astype(np.float32) / 32768.0)
                if len(z):
                    yield z[None, :]
        return
    print("# no soundcard backend; reading s16 audio from stdin",
          file=sys.stderr)
    buf = b""
    while True:
        data = sys.stdin.buffer.read(2 * decim * hop)
        if not data:
            return
        buf += data
        n = (len(buf) // 2) * 2             # whole samples only
        audio = np.frombuffer(buf[:n], "<i2").astype(np.float32) / 32768.0
        buf = buf[n:]
        z = dc.push(audio)
        if len(z):
            yield z[None, :]


def _cmd_grc(args):
    """Run a reference GRC flowgraph through the port."""
    from uwspr_tpu_torch.grc import (classify, describe, parse_grc,
                                     pipeline_config)

    fg = parse_grc(args.file)
    files_dir = args.files_dir or os.path.dirname(os.path.abspath(args.file))
    print(describe(fg, files_dir), file=sys.stderr)
    if args.show:
        return
    kind, src, sink = classify(fg, files_dir)
    cfg = pipeline_config(fg)

    if kind == "sender":
        z = read_c2(src.files[0]).samples
        audio = upconvert(z, cfg.frontend)
        out = args.output
        if out is None and sink and sink.kind == "wav" and sink.file:
            out = os.path.basename(str(sink.file))  # author's path -> cwd
        if out is None:
            raise SystemExit("flowgraph sinks to the soundcard; "
                             "use -o out.wav")
        write_wav(out, audio, sink.rate if sink else 12000)
        print(f"wrote {out}: {len(audio)} samples @ "
              f"{sink.rate if sink else 12000} S/s")
        return

    from uwspr_tpu_torch.pipeline.stream import StreamDecoder
    device = _device(args)
    ht = HashTable.load(args.hashtable) if args.hashtable else HashTable()
    sd = StreamDecoder(cfg, n_channels=1, hashtable=ht, engine=args.engine,
                       device=device)
    hop = cfg.stream.shift * cfg.stream.fs
    t0 = time.time()
    for block in _grc_receiver_source(src, cfg, hop, args.windows, device):
        for ch, r in sd.push(block):
            for s in r.spots:
                print(f"{s.message}    (freq {s.freq:+.2f} Hz, SNR "
                      f"{s.snr:.1f} dB)", flush=True)
    st = sd.stats
    print(f"# {st.windows} windows, {st.spots} spots in "
          f"{time.time() - t0:.2f}s", file=sys.stderr)
    if args.hashtable:
        ht.save(args.hashtable)


def _cmd_warmup(args):
    """Build what a cold ``serve`` would build at its first decode (the
    CUDA kernels on a card, the g++ native Fano and windower) and run one
    zero batch per (batch width, engine), printing the seconds of each. On
    a card that first call also captures the serving program (the JAX
    package's pre-compile): its warm-up and capture seconds and the MiB of
    its graph pool (``torch.cuda.memory_reserved`` before and after) are
    printed. A graph lives as long as its process, unlike JAX's persistent
    compile cache: this measures what a cold ``serve`` pays, and fills no
    cache for a later process."""
    from uwspr_tpu_torch.fec.host import load_native_fano
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    from uwspr_tpu_torch.pipeline.native import load_windower

    device = _device(args)
    widths = [int(w) for w in args.batch.split(",")]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    if device.type == "cuda":
        from uwspr_tpu_torch.utils import cuda_build
        t0 = time.time()
        cuda_build.load_library()
        print(f"  cuda kernels: {cuda_build.build_info['library']} in "
              f"{time.time() - t0:.1f}s")
    t0 = time.time()
    load_native_fano()
    load_windower()
    print(f"  g++ libraries (native Fano, windower) in "
          f"{time.time() - t0:.1f}s")
    band = "wideband" if args.wideband else "narrowband"
    for w in widths:
        coarse = (CoarseConfig(halfbandwidth=187, maxfreqs=200)
                  if args.wideband else CoarseConfig())
        cfg = with_serving_defaults(PipelineConfig(coarse=coarse), w)
        for engine in args.engines.split(","):
            dec = DeviceDecoder(
                cfg, device=device,
                fano_mode="host" if engine == "hybrid" else "device")
            ri = torch.zeros((w, 2, cfg.stream.fl), dtype=torch.float32,
                             device=device)
            t0 = time.time()
            dec.fetch(dec.decode_windows_ri(ri))
            line = (f"  W={w} engine={engine} {band}: ran in "
                    f"{time.time() - t0:.1f}s")
            if dec.program is not None:
                cap = dec.program.captures[tuple(ri.shape)]
                line += (f" (warm-up {cap['warmup_s']:.2f}s, capture "
                         f"{cap['capture_s']:.2f}s, graph pool "
                         f"{cap['pool_mib']:.1f} MiB)")
            print(line)


def _parser() -> argparse.ArgumentParser:
    # --device goes before or after the subcommand; a subcommand's own
    # --device wins (SUPPRESS: absent there, the top-level value stands)
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", choices=DEVICES, default=argparse.SUPPRESS,
                     help="device to run on (default cuda; nothing falls "
                          "back to the CPU)")
    p = argparse.ArgumentParser(prog="uwspr-torch",
                                description="WSPR decoder on PyTorch + CUDA")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="device to run on (default cuda; nothing falls "
                        "back to the CPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", parents=[dev],
                       help="decode a .c2 or .wav capture")
    d.add_argument("file")
    d.add_argument("--wav", action="store_true")
    d.add_argument("--engine", choices=["auto", "host", "device", "hybrid"],
                   default="auto",
                   help="device = batched device program (CUDA default); "
                        "host = staged orchestration (CPU default)")
    d.add_argument("--hashtable", default=None)
    d.add_argument("--messagelog", default=None)
    d.add_argument("--jsonl", default=None)
    d.add_argument("--spots", default=None,
                   help="append wsprd-style wspr_spots.txt lines here")
    d.add_argument("--allwspr", default=None,
                   help="append wsprd-style ALL_WSPR.TXT lines here")
    d.add_argument("--sim-drift", type=float, default=0.0,
                   help="inject synthetic linear drift (Hz/minute) before "
                        "decoding, like the reference c2file_source")
    d.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace (TensorBoard format)")
    d.add_argument("--osd-depth", type=int, default=0,
                   help="ordered-statistics decoding fallback when Fano "
                        "fails (deep-SNR; spots tagged 'osd')")
    d.add_argument("--passes", type=int, default=1,
                   help="successive-interference-cancellation passes: "
                        "decoded frames are re-synthesized, fitted, "
                        "subtracted, and the window re-decoded")
    d.add_argument("--all-spots", action="store_true",
                   help="print every (window, candidate) decode instead of "
                        "deduplicating by message+frequency")
    d.set_defaults(fn=_cmd_decode)

    cw = sub.add_parser("c2towav", parents=[dev],
                        help="c2 -> 12 kS/s wav at 1500 Hz")
    cw.add_argument("file")
    cw.add_argument("-o", "--output", default="out.wav")
    cw.add_argument("--amplitude", type=float, default=0.5)
    cw.add_argument("--drift-rate", type=float, default=0.0)
    cw.set_defaults(fn=_cmd_c2towav)

    wc = sub.add_parser("wavtoc2", parents=[dev],
                        help="12 kS/s wav -> c2 baseband")
    wc.add_argument("file")
    wc.add_argument("-o", "--output", default="out.c2")
    wc.set_defaults(fn=_cmd_wavtoc2)

    e = sub.add_parser("encode", parents=[dev],
                       help="synthesize a frame to .c2 (wsprsim)")
    e.add_argument("callsign")
    e.add_argument("grid")
    e.add_argument("power", type=int)
    e.add_argument("-o", "--output", default="frame.c2")
    e.add_argument("--freq-offset", type=float, default=0.0)
    e.add_argument("--start", type=int, default=750)
    e.set_defaults(fn=_cmd_encode)

    s = sub.add_parser("sweep", parents=[dev], help="closed-loop SNR sweep")
    s.add_argument("--snr", nargs=3, type=float, default=[-15, -30, -1],
                   metavar=("START", "STOP", "STEP"))
    s.add_argument("--trials", type=int, default=20)
    s.add_argument("--whales", default=None,
                   help="wav file mixed in as interference")
    s.add_argument("--engine", choices=["auto", "host", "device", "hybrid"],
                   default="auto",
                   help="host = per-trial WindowDecoder; device = each "
                        "SNR point's trials batched in one device decode")
    s.add_argument("--osd-depth", type=int, default=0,
                   help="OSD fallback order (0 = off)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("-o", "--output", default=None,
                   help="also write the result JSON to this file")
    s.set_defaults(fn=_cmd_sweep)

    v = sub.add_parser("serve", parents=[dev],
                       help="continuous receiver (live/synthetic)")
    v.add_argument("--input", default="synthetic",
                   help="'synthetic' (default), '-' for raw samples on "
                        "stdin, 'audio' or 'audio:<device>' for live "
                        "soundcard capture, or a .c2/.wav capture to "
                        "follow")
    v.add_argument("--format", choices=["cf32", "s16"], default="cf32",
                   help="stdin sample format: cf32 = interleaved float32 "
                        "I/Q at 375 S/s; s16 = 12 kS/s 16-bit mono audio")
    v.add_argument("--repeat", action="store_true",
                   help="loop a file input (reference c2file_source repeat)")
    v.add_argument("--sim-drift", type=float, default=0.0,
                   help="inject linear drift into a .c2 input (Hz/min)")
    v.add_argument("--engine", choices=["auto", "host", "device", "hybrid"],
                   default="auto")
    v.add_argument("--runtime", choices=["python", "native", "ring"],
                   default="python",
                   help="native = C++ ingest/windowing + fixed-width "
                        "batched decode (BatchedStreamDecoder); ring = "
                        "device-resident sample ring, hop-only ingest "
                        "(RingServe)")
    v.add_argument("--mesh", default=None, metavar="CxT",
                   help="serve through a (channel, time) mesh of "
                        "torch.distributed ranks (ShardedStreamDecoder; "
                        "e.g. 2x2: channels sharded, the time axis decodes "
                        "hop blocks with a chained halo exchange); more "
                        "than one rank runs under python -m "
                        "torch.distributed.run --nproc-per-node C*T")
    v.add_argument("--wins-per-shard", type=int, default=4,
                   help="windows decoded per time shard per mesh step "
                        "(larger amortizes the halo exchange; adds "
                        "step latency)")
    v.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="--mesh's torch.distributed backend, named by the "
                        "caller: nccl (one rank per card) or gloo (the "
                        "CPU, or ranks that share a card)")
    v.add_argument("--maxcycles", type=int, default=None,
                   help="Fano budget in cycles/bit (default: the reference "
                        "10000; smaller trades deep-SNR sensitivity for "
                        "bounded worst-case step latency)")
    v.add_argument("--jiggles", type=int, default=None,
                   help="time-jiggle retry attempts per candidate "
                        "(default: the reference 17)")
    v.add_argument("--osd-depth", type=int, default=0,
                   help="ordered-statistics decoding fallback when the "
                        "Fano fails (0 = off; the device engines run "
                        "order min(depth, 4); spots tagged 'osd')")
    v.add_argument("--batch", type=int, default=8,
                   help="windows per batch for --runtime native")
    v.add_argument("--passes", type=int, default=1,
                   help="interference-cancellation passes per window: "
                        "the host subtraction between decodes (python "
                        "runtime), or the device engine's batch program "
                        "subtracting on the device (native and ring "
                        "runtimes, --engine device)")
    v.add_argument("--channels", type=int, default=4)
    v.add_argument("--windows", type=int, default=30,
                   help="hop-blocks to stream (first window after 14); "
                        "bounds synthetic and --repeat inputs")
    v.add_argument("--snr", type=float, default=-18.0)
    v.add_argument("--duty", type=float, default=0.3,
                   help="per-hop probability of starting a new frame")
    v.add_argument("--hashtable", default=None)
    v.add_argument("--messagelog", default=None)
    v.add_argument("--jsonl", default=None)
    v.add_argument("--spots", default=None)
    v.add_argument("--allwspr", default=None)
    v.set_defaults(fn=_cmd_serve)

    wu = sub.add_parser("warmup", parents=[dev],
                        help="build the CUDA and g++ libraries and run one "
                             "zero batch per width and engine (on a card: "
                             "capture its program)")
    wu.add_argument("--batch", default="128",
                    help="comma-separated window-batch widths (default "
                         "128, the serving batch)")
    wu.add_argument("--engines", default="device,hybrid",
                    help="comma-separated engines to warm")
    wu.add_argument("--wideband", action="store_true",
                    help="warm the halfbandwidth=187 wideband config "
                         "instead of narrowband")
    wu.set_defaults(fn=_cmd_warmup)

    g = sub.add_parser("grc", parents=[dev],
                       help="run a GNU Radio Companion flowgraph "
                            "(the reference's .grc files)")
    g.add_argument("file", help="GRC 3.7 XML flowgraph")
    g.add_argument("--show", action="store_true",
                   help="print the parsed mapping and exit")
    g.add_argument("--files-dir", default=None,
                   help="directory to resolve the flowgraph's capture files "
                        "(default: the flowgraph's own directory)")
    g.add_argument("--windows", type=int, default=30,
                   help="hop-blocks to stream for repeating sources")
    g.add_argument("--engine", choices=["auto", "host", "device", "hybrid"],
                   default="auto")
    g.add_argument("--hashtable", default=None)
    g.add_argument("-o", "--output", default=None,
                   help="sender flowgraphs: output wav path")
    g.set_defaults(fn=_cmd_grc)
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
