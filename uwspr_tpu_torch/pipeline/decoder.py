"""End-to-end window decoder of the host engine (torch): coarse search ->
fine sync -> Fano -> text.

Counterpart of uwspr_tpu/pipeline/decoder.py. One ``WindowDecoder`` call
decodes one 45000-sample window with every per-candidate stage batched:

- coarse candidates (``coarse.search.CoarseSearch``: FFT STFT, peak pick,
  f32 einsum grid, exact selection through ``ops.select``);
- staged (lag, freq, drift) refinement and the soft symbols of all jiggled
  shifts (``demod.finesync.FineSync``, probe powers through ``ops.probe``);
- sync/rms gates, then one Fano call over every gated (candidate x jiggle)
  lane (``fec.host``, backend ``config.fano_backend``);
- first success in jiggle order == the reference's sequential retry loop
  (impl.cc:457-482), optional OSD fallback, message unpack and hashtable
  update.

The stages hand their results to the host as numpy between steps, as the
JAX host engine does. The device is named by the caller; on a card every
probe-power, selection and (with ``fano_backend="jax"``) Fano call launches
its CUDA kernel, and the whole decode runs under ``exact_f32`` so the
einsum grid's strict ``v > best`` ties and the first-max-wins argmaxes see
full f32 products.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from uwspr_tpu_torch.coarse.search import MODE_NONLINEAR, CoarseSearch
from uwspr_tpu_torch.config import PipelineConfig
from uwspr_tpu_torch.demod.finesync import FineSync
from uwspr_tpu_torch.device import exact_f32, resolve_device
from uwspr_tpu_torch.fec.host import check_backend, fano_decode_batch_host
from uwspr_tpu_torch.fec.osd import accept_osd
from uwspr_tpu_torch.io.c2file import read_c2
from uwspr_tpu_torch.params import host_bank, host_state_numpy
from uwspr_tpu_torch.protocol.constants import FANO_METTAB, deinterleave
from uwspr_tpu_torch.protocol.messages import (HashTable, Unpacked,
                                              unpack_message)
from uwspr_tpu_torch.utils.timers import StageTimers


@dataclass
class Spot:
    """One decoded frame (field names of uwspr_tpu.pipeline.decoder.Spot)."""

    message: str
    payload: bytes            # 7-byte packed message
    freq: float               # baseband Hz (refined)
    snr: float                # 6 Hz SNR, dB
    sync: float
    shift: int                # samples
    drift: float
    mode: int                 # 0 linear, 1 nonlinear
    slm_params: tuple = ()
    candidate: int = 0
    jiggle: int = 0
    fano_metric: int = 0      # final path metric (reference Fano.cc:240-248)
    fano_cycles: int = 0      # forward-look count consumed
    unpacked: Unpacked | None = None
    pass_index: int = 0       # multipass: which cancellation pass found it
    osd: int = 0              # 0 = Fano decode; else the OSD search order


@dataclass
class DecodeResult:
    spots: list[Spot] = field(default_factory=list)
    n_candidates: int = 0
    n_worth_a_try: int = 0
    n_fano_attempts: int = 0


class WindowDecoder:
    """The host engine on ``device``. ``state`` is the drift-bank state of
    uwspr_tpu_torch.params (HOST_STATE_KEYS), by default built from
    ``config``; ``timers`` accumulate the per-stage wall time."""

    def __init__(self, config: PipelineConfig | None = None, *,
                 device: str | torch.device,
                 hashtable: HashTable | None = None,
                 timers: StageTimers | None = None,
                 state: dict[str, np.ndarray] | None = None):
        self.config = config or PipelineConfig()
        if not isinstance(self.config, PipelineConfig):
            raise TypeError(f"config must be uwspr_tpu_torch.config."
                            f"PipelineConfig, got {type(config).__module__}."
                            f"{type(config).__name__}")
        self.device = resolve_device(device)
        bank, jiggles = host_bank(state if state is not None
                                  else host_state_numpy(self.config))
        if jiggles.shape[0] != self.config.demod.n_jiggles:
            raise ValueError("state jiggles do not match n_jiggles")
        check_backend(self.config.fano_backend)
        self.coarse = CoarseSearch(self.config.coarse, device=self.device,
                                   models=bank)
        self.fine = FineSync(self.config.demod, self.config.coarse,
                             device=self.device, jiggles=jiggles)
        self.hashtable = hashtable if hashtable is not None else HashTable()
        self.timers = timers if timers is not None else StageTimers()

    def __call__(self, window: np.ndarray) -> DecodeResult:
        with torch.no_grad(), exact_f32():
            return self._decode(np.asarray(window))

    def _decode(self, window: np.ndarray) -> DecodeResult:
        cfg = self.config
        with self.timers.stage("coarse"):
            cands = self.coarse(window)
        result = DecodeResult(n_candidates=cands.n)
        if cands.n == 0:
            return result

        with self.timers.stage("finesync"):
            ref = self.fine.refine(window, cands)
        result.n_worth_a_try = int(ref.worth_a_try.sum())
        if result.n_worth_a_try == 0:
            return result

        with self.timers.stage("soft_symbols"):
            symbols, sync2, rms = self.fine.soft_symbols(window, cands, ref)
        C, J, _ = symbols.shape
        gate = (ref.worth_a_try[:, None]
                & (sync2 > cfg.demod.minsync2)
                & (rms > cfg.demod.minrms))                     # (C, J)

        flat_syms = deinterleave(symbols.reshape(C * J, 162))
        active = gate.reshape(C * J)
        result.n_fano_attempts = int(active.sum())
        if result.n_fano_attempts == 0:
            return result
        with self.timers.stage("fano"):
            success, data, metric, cycles, _ = fano_decode_batch_host(
                flat_syms, active, backend=cfg.fano_backend,
                device=self.device, mettab=FANO_METTAB,
                delta=cfg.demod.fano_delta, maxcycles=cfg.demod.maxcycles)
        success = success.reshape(C, J)
        data = data.reshape(C, J, -1)
        metric = metric.reshape(C, J)
        cycles = cycles.reshape(C, J)

        for c in range(C):
            if not ref.worth_a_try[c]:
                continue
            js = np.flatnonzero(success[c])
            if len(js) == 0:
                if cfg.demod.osd_depth > 0:
                    spot = self._osd_fallback(c, cands, ref, flat_syms,
                                              gate, sync2)
                    if spot is not None:
                        result.spots.append(spot)
                continue
            j = int(js[0])                  # first success in jiggle order
            payload = bytes(data[c, j, :7])
            unpacked = unpack_message(payload, self.hashtable)
            spot = self._spot(c, j, payload, unpacked, cands, ref, sync2)
            spot.fano_metric = int(metric[c, j])
            spot.fano_cycles = int(cycles[c, j])
            result.spots.append(spot)
        return result

    def _spot(self, c, j, payload, unpacked, cands, ref, sync2) -> Spot:
        return Spot(
            message=unpacked.text if unpacked is not None else "",
            payload=payload,
            freq=float(ref.freq[c]),
            snr=float(cands.snr[c]),
            sync=float(sync2[c, j]),
            shift=int(ref.shift[c]),
            drift=float(ref.drift[c]),
            mode=int(cands.mode[c]),
            slm_params=tuple(float(v) for v in cands.slm_params[c])
            if cands.mode[c] == MODE_NONLINEAR else (),
            candidate=int(c),
            jiggle=int(j),
            unpacked=unpacked,
        )

    def _osd_fallback(self, c, cands, ref, flat_syms, gate, sync2):
        """Ordered-statistics decode of candidate c's best gated lanes when
        every Fano retry failed (decoder.py:149-182): the calibrated
        acceptance rule of fec.osd.accept_osd, then protocol
        unpacking; the spot carries the OSD order."""
        if not gate[c].any():
            return None
        J = gate.shape[1]
        j, payload = accept_osd(flat_syms[c * J:(c + 1) * J], gate[c],
                                sync2[c], self.config.demod)
        if payload is None:
            return None
        unpacked = unpack_message(payload, self.hashtable)
        if unpacked is None:
            return None
        spot = self._spot(c, j, payload, unpacked, cands, ref, sync2)
        spot.osd = int(self.config.demod.osd_depth)
        return spot


def decode_c2_file(path, config: PipelineConfig | None = None, *,
                   device: str | torch.device) -> DecodeResult:
    """Decode one .c2 capture on ``device``."""
    return WindowDecoder(config, device=device)(read_c2(path).samples)


__all__ = ["DecodeResult", "Spot", "WindowDecoder", "decode_c2_file"]
