"""Closed-loop SNR sweep: encoder -> AWGN channel -> decoder curve.

Counterpart of uwspr_tpu/pipeline/sweep.py: a deterministic, scriptable
replacement for the reference's manual closed-loop flowgraph rig
(examples/WaveFilePlusNoiseDecode.grc with hand-tuned gain knobs and
whale-song interference, README.md:61-65). Measures decode success rate
vs SNR (2500 Hz reference bandwidth, the WSPR convention). The trials are
the reference's: the same seed gives the same windows, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from uwspr_tpu_torch.config import PipelineConfig
from uwspr_tpu_torch.demod.finesync import complex_to_ri
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.messages import unpack_message
from uwspr_tpu_torch.protocol.modulate import synthesize_frame


@dataclass
class SweepResult:
    snr_db: list = field(default_factory=list)
    decode_rate: list = field(default_factory=list)
    trials: int = 0

    def as_dict(self) -> dict:
        return {f"{s:g}": r for s, r in zip(self.snr_db, self.decode_rate)}


def snr_sweep(snrs_db, trials: int = 20, *, callsign: str = "VE3EMB",
              grid: str = "FN25", power: int = 30,
              config: PipelineConfig | None = None, seed: int = 0,
              interference: np.ndarray | None = None,
              progress=None, engine: str = "host",
              device: str | torch.device) -> SweepResult:
    """Decode-rate curve over SNR on ``device``. Randomizes frequency
    offset (+/-5 Hz) and frame start (0..2 s) per trial; optional additive
    interference (e.g. the whale-song capture) mixed at unit gain.

    engine="host" runs WindowDecoder per trial; engine="device" (or
    "hybrid", the Fano on the host) decodes each SNR point's trials as one
    DeviceDecoder batch (``decode_ri_batch``)."""
    expect = f"{callsign} {grid} {power:2d}"
    rng = np.random.default_rng(seed)
    result = SweepResult(trials=trials)
    cfg = config or PipelineConfig()
    if interference is not None:
        # tile shorter captures (e.g. the whale-song wav) over the window
        fl = cfg.stream.fl
        reps = int(np.ceil(fl / len(interference)))
        interference = np.tile(np.asarray(interference, np.complex64),
                               reps)[:fl]

    def make_trial(snr):
        f_off = rng.uniform(-5.0, 5.0)
        start = int(rng.integers(0, 750))
        z = synthesize_frame(callsign, grid, power, start_sample=start,
                             freq_offset=f_off)
        z = awgn(z, snr, rng=rng)
        if interference is not None:
            z = z + interference[:len(z)]
        return z

    if engine in ("device", "hybrid"):
        decoder = DeviceDecoder(
            cfg, device=device,
            fano_mode="host" if engine == "hybrid" else "device")
        for snr in snrs_db:
            windows = [make_trial(snr) for _ in range(trials)]
            ri = np.stack([complex_to_ri(w) for w in windows])
            out = decoder.decode_ri_batch(ri)
            ok = 0
            for t in range(trials):
                msgs = []
                for c in np.flatnonzero(out.success[t]):
                    u = unpack_message(bytes(out.payload[t][c]))
                    if u:
                        msgs.append(u.text)
                ok += expect in msgs
                if progress:
                    progress(snr, t, ok)
            result.snr_db.append(float(snr))
            result.decode_rate.append(ok / trials)
        return result

    decoder = WindowDecoder(cfg, device=device)
    for snr in snrs_db:
        ok = 0
        for t in range(trials):
            z = make_trial(snr)
            r = decoder(z)
            if expect in [s.message for s in r.spots]:
                ok += 1
            if progress:
                progress(snr, t, ok)
        result.snr_db.append(float(snr))
        result.decode_rate.append(ok / trials)
    return result


__all__ = ["snr_sweep", "SweepResult"]
