"""Batched window decoder on one device: samples in, packed messages out.

Counterpart of uwspr_tpu/pipeline/jit_decoder.py::DeviceDecoder, batched
as its ``_decode_windows_batched`` (jit_decoder.py:698-730):

  STFT power (stft_impl "pallas": the fused CUDA kernel, computing only
  the columns read) -> smoothed SNR spectrum -> peak pick -> coarse sync
  grid (conv; the im2col einsum with bf16 operands when hpbm > 32) ->
  exact model selection (CUDA kernel) -> phase A/B probe refinement ->
  joint fine grid, soft symbols over all jiggles, sync/rms gates,
  deinterleave -> two-phase Fano (CUDA kernel) -> first success in jiggle
  order -> on-device OSD of the worth candidates whose gated lanes all
  failed (osd_depth > 0, fec/osd_torch.py) -> packed (W, C, 23) float32.

The lanes the refinement runs on: with cand_compact_lanes > 0 the valid
candidates gathered across the batch (_compact_cand_pre); otherwise all
W*C lanes, and with refine_max_lanes > 0 the post-worth tail on the worth
lanes gathered across the batch (_compact_refine_tail). The Fano: with
fano_compact_lanes > 0 never-drop chunks of gated lanes across the batch
(_compact_fano); otherwise at most fano_max_lanes gated lanes per window
and phase, the rest counted in fano_overflow. The OSD lanes: the failed lanes
of the whole batch, compacted to osd_max_lanes (the rest counted in
fano_overflow). fano_mode "host" (the hybrid engine) stops after the gates
and packs the soft symbols (_pack_prefano); ``host_fano_assemble`` runs
the Fano on the host through ``fec.host`` with ``config.fano_backend``,
and host OSD when osd_depth > 0.

``__call__`` decodes one window with the reference's per-window program
(jit_decoder.py:594-696, :1214-1220): the batch path at W = 1 with the
three batch knobs (cand_compact_lanes, refine_max_lanes,
fano_compact_lanes) at 0, so every lane is refined, each Fano phase takes
at most fano_max_lanes gated lanes and OSD is compacted over the window's
C lanes.

PyTorch runs eagerly, so the JAX decoder's vmap over windows is a batch
dimension written out and its bounded while loops are host loops; the
device-to-host reads are the gated-lane count of each compacted Fano phase,
which sizes the chunk loop (and skips the Fano when nothing is gated), and
with OSD on the failed-lane count, which sizes the OSD batch (and skips it
when no lane failed).

truncate_stage is not ported (CUDA events split the stages,
scripts/torch_stages.py) and raises NotImplementedError.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from uwspr_tpu_torch.coarse.search import (
    coarse_score_grid,
    max_peaks,
    smoothed_snr_spectrum,
)
from uwspr_tpu_torch.config import PipelineConfig
from uwspr_tpu_torch.demod.finesync import (
    complex_to_ri,
    make_shared_probe_lanes,
    probe_constants,
    probe_derotate,
    shared_probe_eval,
)
from uwspr_tpu_torch.device import exact_f32, resolve_device
from uwspr_tpu_torch.fec.fano import fano_decode_batch
from uwspr_tpu_torch.fec.host import check_backend, fano_decode_batch_host
from uwspr_tpu_torch.fec.osd import accept_osd
from uwspr_tpu_torch.fec.osd_torch import bits_to_payload, osd_decode_lanes
from uwspr_tpu_torch.models.slm import slm_frequency_drift_torch
from uwspr_tpu_torch.ops.select import select_best
from uwspr_tpu_torch.ops.stft import stft_constants, stft_power_core
from uwspr_tpu_torch.params import state_from_numpy, state_keys, state_numpy
from uwspr_tpu_torch.pipeline.decoder import Spot
from uwspr_tpu_torch.protocol.constants import FANO_METTAB
from uwspr_tpu_torch.protocol.messages import unpack_message

_NBYTES = 10        # Fano harvest bytes; the payload is the first 7


@dataclass
class DeviceDecoderOutput:
    """Typed fields of the packed output, as jit_decoder.DeviceDecoderOutput
    (all per candidate, leading window axis where batched)."""

    success: np.ndarray
    payload: np.ndarray       # (..., C, 7) uint8 packed message
    freq: np.ndarray
    snr: np.ndarray
    sync: np.ndarray
    shift: np.ndarray
    drift: np.ndarray
    mode: np.ndarray
    slm_params: np.ndarray    # (..., C, 4)
    jiggle: np.ndarray
    valid: np.ndarray
    fano_overflow: np.ndarray  # per window: lanes dropped by the lane caps
    fano_attempts: np.ndarray  # per window: gated (candidate, jiggle) lanes
    osd: np.ndarray            # 0 = Fano decode, else the OSD order

    def window(self, w: int) -> "DeviceDecoderOutput":
        return DeviceDecoderOutput(**{
            f.name: getattr(self, f.name)[w]
            for f in dataclasses.fields(self)})


FANO_MODES = ("device", "host")


def check_slice(config: PipelineConfig, fano_mode: str = "device") -> None:
    """Raise TypeError for a config that is not the port's own class and
    ValueError for an unknown fano_mode."""
    if not isinstance(config, PipelineConfig):
        raise TypeError(f"config must be uwspr_tpu_torch.config."
                        f"PipelineConfig, got {type(config).__module__}."
                        f"{type(config).__name__}")
    if fano_mode not in FANO_MODES:
        raise ValueError(f"fano_mode {fano_mode!r} not in {FANO_MODES}")


class DeviceDecoder:
    """Configuration-baked batched decoder on an explicit device.

    ``state`` is the decoder's constant state as numpy arrays (see
    uwspr_tpu_torch.params); by default it is built from ``config``.
    ``fano_mode`` "device" decodes on the device; "host" is the hybrid
    engine (gates and soft symbols on the device, Fano on the host)."""

    def __init__(self, config: PipelineConfig | None = None, *,
                 device: str | torch.device,
                 state: dict[str, np.ndarray] | None = None,
                 fano_mode: str = "device",
                 truncate_stage: str | None = None):
        if truncate_stage is not None:
            raise NotImplementedError("truncate_stage is not ported")
        self.config = config or PipelineConfig()
        check_slice(self.config, fano_mode)
        if fano_mode == "host":
            check_backend(self.config.fano_backend)
        self.fano_mode = fano_mode
        self.device = resolve_device(device)
        self.n_cand = max_peaks(self.config.coarse)
        self.state = state_from_numpy(
            state if state is not None else state_numpy(self.config),
            self.device, keys=state_keys(self.config))
        if self.state["jiggles"].shape[0] != self.config.demod.n_jiggles:
            raise ValueError("state jiggles do not match n_jiggles")
        # on-device OSD: only when osd_depth > 0 and osd_max_lanes > 0
        # (jit_decoder.py:127-134); the hybrid engine runs the host OSD
        self._osd_G = self.state.get("osd_G") if fano_mode == "device" \
            else None
        self._per_window = None
        # host-built constants, moved to the device once: a copy per call
        # would cost host time and wait for the device each time
        cfg = self.config.coarse
        m = cfg.fft_size // 2
        # column window: only the passband plus reach is ever read
        self._cols = (max(0, m - cfg.hpbm - 10),
                      min(cfg.fft_size, m + cfg.hpbm + 10))
        self._stft_consts = stft_constants(cfg.fft_size, self._cols,
                                           self.device)
        self._probe_consts = probe_constants(self.device)

    # -- public entry -------------------------------------------------------

    def decode_windows_ri(self, ri: torch.Tensor | np.ndarray
                          ) -> torch.Tensor:
        """(W, 2, fl) float32 real/imag windows -> on the decoder's device,
        fano_mode "device": packed (W, C, 23) float32 (column layout of
        jit_decoder.py:178-182; ``unpack_output`` gives the typed fields);
        fano_mode "host": packed prefano (W, C, 12+164J) float32
        (``_pack_prefano``; ``host_fano_assemble`` decodes it)."""
        ri = torch.as_tensor(ri)
        if ri.dim() != 3 or ri.shape[1] != 2:
            raise ValueError(f"ri must be (W, 2, fl), got {tuple(ri.shape)}")
        if ri.dtype != torch.float32:
            raise ValueError(f"ri must be float32, got {ri.dtype}")
        ri = ri.to(self.device)
        with torch.no_grad(), exact_f32():
            pre = self.prefano(ri)
            if self.fano_mode == "host":
                return self._pack_prefano(pre)
            return self._pack(self._fano_select_batch(pre))

    def decode_ri_batch(self, ri: torch.Tensor | np.ndarray
                        ) -> DeviceDecoderOutput:
        """(W, 2, fl) float32 windows -> typed output, following fano_mode
        (jit_decoder.py:1228-1233)."""
        return self.fetch(self.decode_windows_ri(ri))

    def fetch(self, packed: torch.Tensor) -> DeviceDecoderOutput:
        """A packed result of decode_windows_ri (any leading dims) -> typed
        output: unpacked, or in fano_mode "host" Fano-decoded on the host."""
        if self.fano_mode == "host":
            return self.host_fano_assemble(packed)
        return self.unpack_output(packed)

    def decode_batch(self, zs: np.ndarray) -> DeviceDecoderOutput:
        """(W, fl) complex windows -> batched output (leading axis W)."""
        return self.decode_ri_batch(np.stack([complex_to_ri(z)
                                              for z in np.asarray(zs)]))

    def __call__(self, z: np.ndarray) -> DeviceDecoderOutput:
        """One (fl,) complex window -> its output, by the reference's
        per-window program (jit_decoder.py:1214-1220): see
        ``_window_program``."""
        return self._window_program().decode_batch(
            np.asarray(z)[None]).window(0)

    def _window_program(self) -> "DeviceDecoder":
        """This decoder with cand_compact_lanes, refine_max_lanes and
        fano_compact_lanes at 0, sharing its state: a batch of one window
        then runs jit_decoder.py:594-696 (every lane refined, at most
        fano_max_lanes gated lanes per Fano phase, OSD over the window's C
        lanes)."""
        if self._per_window is None:
            demod = dataclasses.replace(
                self.config.demod, cand_compact_lanes=0, refine_max_lanes=0,
                fano_compact_lanes=0)
            w = copy.copy(self)
            w.config = dataclasses.replace(self.config, demod=demod)
            w._per_window = w
            self._per_window = w
        return self._per_window

    # -- coarse stage (jit_decoder.py:302-410) ------------------------------

    def _peaks(self, sm: torch.Tensor):
        """(W, finpb) smoothed spectra -> (valid, if0, snr_db), each (W, C):
        strict local maxima in ascending frequency, capped at C, then stably
        sorted by SNR descending (jit_decoder.py:234-255)."""
        cfg = self.config.coarse
        finpb = 2 * cfg.hpbm
        C = self.n_cand
        m = cfg.fft_size // 2
        j = torch.arange(finpb, device=sm.device)
        left = torch.roll(sm, 1, dims=-1)
        right = torch.roll(sm, -1, dims=-1)
        is_peak = (sm > left) & (sm > right) & (j >= 1) & (j <= finpb - 2)
        rank = torch.cumsum(is_peak.to(torch.int64), dim=-1)
        keep = is_peak & (rank <= C)
        key = torch.where(keep, j, finpb + 1)
        key = torch.cat([key, torch.full(key.shape[:-1] + (C,), finpb + 1,
                                         dtype=key.dtype, device=sm.device)],
                        dim=-1)
        sel = torch.sort(key, dim=-1).values[..., :C]
        valid = sel < finpb
        sel = torch.clamp(sel, max=finpb - 1)
        snr_db = 10.0 * torch.log10(torch.gather(sm, -1, sel))
        sortkey = torch.where(valid, -snr_db, float("inf"))
        order = torch.argsort(sortkey, dim=-1, stable=True)
        sel = torch.gather(sel, -1, order)
        valid = torch.gather(valid, -1, order)
        snr_db = torch.gather(snr_db, -1, order)
        if0 = sel - cfg.hpbm + m
        return valid, if0, torch.where(valid, snr_db, 0.0)

    def coarse_grid(self, z_all: torch.Tensor) -> dict:
        """(W, fl) complex64 -> peaks and the (W, C, 5, 26, M) sync grid the
        model selection walks."""
        cfg = self.config.coarse
        m = cfg.fft_size // 2
        cb0 = self._cols[0]
        stft_impl = "fft" if cfg.stft_impl == "auto" else cfg.stft_impl
        ps = stft_power_core(z_all, n_ffts=cfg.n_ffts, size=cfg.fft_size,
                             hop=cfg.spb // 2, impl=stft_impl,
                             col_window=self._cols, consts=self._stft_consts)
        sm = smoothed_snr_spectrum(ps, hpbm=cfg.hpbm, m=m, col0=cb0)
        valid, if0, snr = self._peaks(sm)
        # conv for narrowband, the im2col GEMM for wideband; bf16 operands
        # for the einsum (jit_decoder.py:350-361); explicit values stand
        grid_impl = cfg.grid_impl
        if grid_impl == "auto":
            grid_impl = "einsum" if cfg.hpbm > 32 else "conv"
        grid_dtype = cfg.grid_dtype
        if grid_dtype == "auto":
            grid_dtype = "bf16" if grid_impl == "einsum" else "f32"
        syncgrid = coarse_score_grid(
            ps, if0 - cb0, self.state["offsets"], self.state["sign"],
            impl=grid_impl,
            f_window=(m - cfg.hpbm - 1 - 6 - cb0, m + cfg.hpbm + 1 + 6 - cb0),
            dtype=grid_dtype)
        return {"valid": valid, "if0": if0, "snr": snr, "grid": syncgrid}

    def _coarse_stage(self, z_all: torch.Tensor) -> dict:
        cfg = self.config.coarse
        cg = self.coarse_grid(z_all)
        grid = cg["grid"]
        W, C = grid.shape[:2]
        Mdim = grid.shape[-1]
        best, best_idx = select_best(grid.reshape((W * C,) + grid.shape[2:]),
                                     self.state["is_nl"],
                                     threshold=float(cfg.threshold))
        best_idx = best_idx.reshape(W, C).to(torch.int64)
        fi = torch.div(best_idx, 26 * Mdim, rounding_mode="floor")
        k0 = torch.div(best_idx, Mdim, rounding_mode="floor") % 26
        mm = best_idx % Mdim
        m_half = cfg.fft_size // 2
        freq = ((cg["if0"] + fi - 2) - m_half).float() * np.float32(cfg.df)
        return {
            "valid": cg["valid"], "snr": cg["snr"], "freq": freq.float(),
            "shift": 128 * k0,
            "drift": self.state["model_drift"][mm],
            "mode": self.state["is_nl"][mm].to(torch.int64),
            "slm_params": self.state["model_slm"][mm],
        }

    # -- refinement (jit_decoder.py:259-267, :412-570) ----------------------

    def _drift_offsets(self, mode, drift, slm_params):
        """(L,) metadata -> (L, 162) per-symbol drift in Hz (float32)."""
        dev = drift.device
        i = torch.arange(162, dtype=torch.float32, device=dev)
        lin = (drift[:, None] / 2.0) * (i[None, :] - 81.0) / 81.0
        t = torch.div(torch.arange(162, device=dev) * 111, 162,
                      rounding_mode="floor").float()
        nl = slm_frequency_drift_torch(
            slm_params[:, 0:1], slm_params[:, 1:2], slm_params[:, 2:3],
            slm_params[:, 3:4], float(self.config.coarse.cf), t[None, :])
        return torch.where((mode == 1)[:, None], nl, lin).float()

    def _refine_common(self, st: dict, probe) -> dict:
        """Phase A (coarse lag/freq joint grid) and phase B (linear drift
        +/-0.5) over the compacted lanes (jit_decoder.py:412-502)."""
        dcfg = self.config.demod
        dev = st["freq"].device
        valid = st["valid"]
        mode, slm_params = st["mode"], st["slm_params"]
        C = valid.shape[0]
        cidx = torch.arange(C, device=dev)
        pdt = dcfg.probe_dtype

        def spe(*a, **k):
            return shared_probe_eval(*a, dtype=pdt,
                                     consts=self._probe_consts, **k)
        f1 = st["freq"].float()
        shift1 = st["shift"]
        drift1 = st["drift"]
        dsym = self._drift_offsets(mode, drift1, slm_params)

        # phase A: W = 640 is exactly minimal for the +/-128 lag grid at
        # block 128 (jit_decoder.py:446-450); never narrow it
        Amat1, base1 = probe(shift1, 128, 640, 128)
        zd1 = probe_derotate(Amat1, dsym)
        lag_grid = shift1[:, None] + torch.arange(-128, 129, 64, device=dev)
        freq_grid = f1[:, None] + _offsets_f32(0.25, dev)[None, :]
        s = spe(zd1, base1, lag_grid, freq_grid, n_lags=5)      # (C, 5, 5)
        li = torch.argmax(s[:, 2, :], dim=1)          # stage 0: lag @ f0
        shift1 = lag_grid[cidx, li]
        fi2 = torch.argmax(s[cidx, :, li], dim=1)     # stage 1: freq @ lag
        f1 = freq_grid[cidx, fi2]
        sync1 = s[cidx, fi2, li]

        # phase B: window centred on the refined lag
        Amat2, base2 = probe(shift1, 96, 640, 128)
        Amat2d = Amat2[..., 96:480]
        base2d = base2 + 96
        is_lin = mode != 1
        driftp = drift1 + 0.5
        driftm = drift1 - 0.5
        sp = spe(probe_derotate(Amat2d, self._drift_offsets(mode, driftp,
                                                            slm_params)),
                 base2d, shift1[:, None], f1[:, None], n_lags=1)[:, 0, 0]
        sm_ = spe(probe_derotate(Amat2d, self._drift_offsets(mode, driftm,
                                                             slm_params)),
                  base2d, shift1[:, None], f1[:, None], n_lags=1)[:, 0, 0]
        updp = is_lin & (sp > sync1)
        updm = is_lin & ~updp & (sm_ > sync1)
        drift1 = torch.where(updp, driftp, torch.where(updm, driftm, drift1))
        sync1 = torch.where(updp, sp, torch.where(updm, sm_, sync1))
        return {
            "valid": valid, "snr": st["snr"], "freq": f1, "shift": shift1,
            "drift": drift1, "mode": mode, "slm_params": slm_params,
            "sync1": sync1, "worth0": sync1 > dcfg.minsync1,
            "Amat2": Amat2, "base2": base2,
        }

    def _prefano_tail(self, st: dict) -> dict:
        """Joint fine grid, soft symbols over all jiggles, gates and
        deinterleave (jit_decoder.py:504-570)."""
        dcfg = self.config.demod
        dev = st["freq"].device
        C = st["shift"].shape[0]
        cidx = torch.arange(C, device=dev)

        def spe(*a, **k):
            return shared_probe_eval(*a, dtype=dcfg.probe_dtype,
                                     consts=self._probe_consts, **k)
        valid = st["valid"]
        f1, shift1, drift1 = st["freq"], st["shift"], st["drift"]
        mode, slm_params, sync1 = st["mode"], st["slm_params"], st["sync1"]
        dsym = self._drift_offsets(mode, drift1, slm_params)
        zd2 = probe_derotate(st["Amat2"], dsym)
        base2 = st["base2"]

        worth = st["worth0"]
        lag_grid = shift1[:, None] + torch.arange(-32, 33, 16, device=dev)
        freq_grid = f1[:, None] + _offsets_f32(0.05, dev)[None, :]
        s = spe(zd2, base2, lag_grid, freq_grid, n_lags=5)      # (C, 5, 5)
        li = torch.argmax(s[:, 2, :], dim=1)
        shift1 = torch.where(worth, lag_grid[cidx, li], shift1)
        # fine freq at the post-fine-lag shift: the chosen-lag column if
        # the lag update fired, the centre column if not
        li = torch.where(worth, li, 2)
        fi2 = torch.argmax(s[cidx, :, li], dim=1)
        f1 = torch.where(worth, freq_grid[cidx, fi2], f1)
        worth = worth & valid

        # soft symbols over all jiggles
        jig = self.state["jiggles"]
        lag_grid = shift1[:, None] + jig[None, :]
        sync2, p = spe(zd2, base2, lag_grid, f1[:, None],
                       n_lags=jig.shape[0], want_symbols=True)
        sync2 = sync2[:, 0, :]                                  # (C, J)
        p = p[:, 0]                                             # (C,J,162,4)
        fsymb = torch.where(self.state["sync_bit"][None, None, :],
                            p[..., 3] - p[..., 1], p[..., 2] - p[..., 0])
        fsum = fsymb.mean(dim=-1, keepdim=True)
        f2sum = (fsymb * fsymb).mean(dim=-1, keepdim=True)
        fac = torch.sqrt(f2sum - fsum * fsum)
        scaled = dcfg.symfac * fsymb / torch.clamp(fac, min=1e-12)
        scaled = torch.clamp(torch.nan_to_num(scaled), -128.0, 127.0)
        symbols = torch.floor(scaled + 128.0).to(torch.uint8)
        y = symbols.float() - 128.0
        rms = torch.sqrt((y * y).mean(dim=-1))                  # (C, J)
        gate = (worth[:, None] & (sync2 > dcfg.minsync2)
                & (rms > dcfg.minrms))
        deint = symbols[..., self.state["perm"]]                # (C, J, 162)
        return {"worth": worth, "freq": f1, "shift": shift1, "sync2": sync2,
                "gate": gate, "deint": deint}

    def prefano(self, ri: torch.Tensor) -> dict:
        """(W, 2, fl) -> per-window candidate state, gates and deinterleaved
        symbols, each (W, C, ...): coarse search on every window, then the
        refinement on the lanes the config picks (see the module doc)."""
        dcfg = self.config.demod
        z_all = torch.complex(ri[:, 0], ri[:, 1])
        coarse = self._coarse_stage(z_all)
        if dcfg.cand_compact_lanes > 0:
            return self._compact_cand_pre(z_all, coarse)
        # every lane of every window (the vmap of _prefano,
        # jit_decoder.py:283-300), as one batch of W*C lanes
        W, C = coarse["valid"].shape
        flat = {k: v.reshape((W * C,) + v.shape[2:]) for k, v in coarse.items()}
        widx = torch.arange(W, device=z_all.device).repeat_interleave(C)
        head = self._refine_common(flat, self._lane_probe(z_all, widx))
        if dcfg.refine_max_lanes > 0:
            return self._compact_refine_tail(head, W, C)
        tail = self._prefano_tail(head)

        def unflat(v):
            return v.reshape((W, C) + v.shape[1:])
        return {
            "valid": coarse["valid"], "snr": coarse["snr"],
            "mode": coarse["mode"], "slm_params": coarse["slm_params"],
            "drift": unflat(head["drift"]),
            **{k: unflat(tail[k]) for k in ("worth", "freq", "shift",
                                            "sync2", "gate", "deint")},
        }

    def _lane_probe(self, z_all: torch.Tensor, widx: torch.Tensor):
        """The probe builder of _refine_common for lanes that read window
        widx[l] of z_all."""
        pdt = "bf16" if self.config.demod.probe_dtype == "bf16" else "c64"
        return lambda center, reach, Wp, block: make_shared_probe_lanes(
            z_all, widx, center, reach=reach, W=Wp, block=block, dtype=pdt)

    def _compact_refine_tail(self, head: dict, W: int, C: int) -> dict:
        """The post-worth tail on at most refine_max_lanes worth lanes
        gathered across the batch, scattered back; worth lanes beyond the
        cap are counted per window in refine_overflow
        (jit_decoder.py:732-778)."""
        dcfg = self.config.demod
        dev = head["freq"].device
        J = dcfg.n_jiggles
        ML = min(dcfg.refine_max_lanes, W * C)
        worthy = head["worth0"] & head["valid"]                 # (W*C,)
        sel = torch.argsort((~worthy).to(torch.int8), stable=True)[:ML]
        sub = {k: head[k][sel]
               for k in ("valid", "freq", "shift", "drift", "mode",
                         "slm_params", "sync1", "Amat2", "base2")}
        sub["worth0"] = worthy[sel]     # padding lanes stay unworthy
        tail = self._prefano_tail(sub)

        def scat(base_flat, vals):
            out = base_flat.clone()
            out[sel] = vals
            return out.reshape((W, C) + vals.shape[1:])

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        selmask = zeros(W * C, torch.bool)
        selmask[sel] = True
        return {
            "valid": head["valid"].reshape(W, C),
            "snr": head["snr"].reshape(W, C),
            "mode": head["mode"].reshape(W, C),
            "slm_params": head["slm_params"].reshape(W, C, -1),
            "drift": head["drift"].reshape(W, C),
            "worth": scat(zeros(W * C, torch.bool), tail["worth"]),
            "freq": scat(head["freq"], tail["freq"]),
            "shift": scat(head["shift"], tail["shift"]),
            "sync2": scat(zeros((W * C, J), torch.float32), tail["sync2"]),
            "gate": scat(zeros((W * C, J), torch.bool), tail["gate"]),
            "deint": scat(zeros((W * C, J, 162), torch.uint8), tail["deint"]),
            "refine_overflow": (worthy & ~selmask).reshape(W, C).sum(dim=1),
        }

    def _compact_cand_pre(self, z_all: torch.Tensor, coarse: dict) -> dict:
        """Refinement on the valid lanes gathered across the batch
        (jit_decoder.py:780-863). Valid lanes beyond cand_compact_lanes are
        dropped weakest coarse SNR first and counted in refine_overflow."""
        dcfg = self.config.demod
        W, C = coarse["valid"].shape
        dev = z_all.device
        J = dcfg.n_jiggles
        ML = min(dcfg.cand_compact_lanes, W * C)
        flat = {k: v.reshape((W * C,) + v.shape[2:]) for k, v in coarse.items()}
        key = torch.where(flat["valid"], -flat["snr"], float("inf"))
        sel = torch.argsort(key, stable=True)[:ML]
        widx = torch.div(sel, C, rounding_mode="floor")
        st = {k: v[sel] for k, v in flat.items()}
        head = self._refine_common(st, self._lane_probe(z_all, widx))

        worthy = head["worth0"] & head["valid"]                 # (ML,)
        ML2 = (min(dcfg.refine_max_lanes, ML) if dcfg.refine_max_lanes > 0
               else ML)
        sel2 = torch.argsort((~worthy).to(torch.int8), stable=True)[:ML2]
        sub = {k: head[k][sel2]
               for k in ("valid", "freq", "shift", "drift", "mode",
                         "slm_params", "sync1", "Amat2", "base2")}
        sub["worth0"] = worthy[sel2]
        tail = self._prefano_tail(sub)
        gsel = sel[sel2]             # global (W*C) indices of the tail lanes

        def scat(base_flat, vals):
            out = base_flat.clone()
            out[gsel] = vals
            return out.reshape((W, C) + vals.shape[1:])

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        # phase A/B results on every selected lane, the fine-grid updates
        # of the tail lanes on top
        freq = flat["freq"].clone()
        freq[sel] = head["freq"]
        shift = flat["shift"].clone()
        shift[sel] = head["shift"]
        drift = flat["drift"].clone()
        drift[sel] = head["drift"]
        kept = zeros(W * C, torch.bool)
        kept[sel] = True
        tailed = zeros(ML, torch.bool)
        tailed[sel2] = True
        worth_dropped = zeros(W * C, torch.bool)
        worth_dropped[sel] = worthy & ~tailed
        overflow = ((flat["valid"] & ~kept).reshape(W, C).sum(dim=1)
                    + worth_dropped.reshape(W, C).sum(dim=1))
        return {
            "valid": coarse["valid"], "snr": coarse["snr"],
            "mode": coarse["mode"], "slm_params": coarse["slm_params"],
            "drift": drift.reshape(W, C),
            "worth": scat(zeros(W * C, torch.bool), tail["worth"]),
            "freq": scat(freq, tail["freq"]),
            "shift": scat(shift, tail["shift"]),
            "sync2": scat(zeros((W * C, J), torch.float32), tail["sync2"]),
            "gate": scat(zeros((W * C, J), torch.bool), tail["gate"]),
            "deint": scat(zeros((W * C, J, 162), torch.uint8), tail["deint"]),
            "refine_overflow": overflow,
        }

    # -- Fano (jit_decoder.py:865-1022) -------------------------------------

    def _compact_fano(self, gate_flat: torch.Tensor, deint_flat: torch.Tensor,
                      cap: int):
        """Every gated lane of the flat batch is decoded in fixed chunks of
        FL = min(cap, N) lanes, gated first; the last chunk is clamped to
        N - FL and re-decodes a few done lanes with identical results
        (jit_decoder.py:865-926). Nothing runs when no lane is gated.
        Returns (success (N,), data (N, 10))."""
        dcfg = self.config.demod
        dev = gate_flat.device
        N = gate_flat.shape[0]
        FL = min(cap, N)
        sel_all = torch.argsort((~gate_flat).to(torch.int8), stable=True)
        n_gated = int(gate_flat.sum())
        succ = torch.zeros(N, dtype=torch.bool, device=dev)
        data = torch.zeros((N, _NBYTES), dtype=torch.uint8, device=dev)
        i = 0
        while i * FL < n_gated:
            start = min(i * FL, N - FL)
            sel = sel_all[start:start + FL]
            g = gate_flat[sel]
            out = fano_decode_batch(deint_flat[sel], self.state["mettab"], g,
                                    maxcycles=dcfg.maxcycles,
                                    delta=dcfg.fano_delta)
            succ[sel] = out["success"] & g
            data[sel] = out["data"]
            i += 1
        return succ, data

    def _fano_phase(self, gate: torch.Tensor, deint: torch.Tensor):
        """One Fano phase over (W, N) gated lanes with (W, N, 162) symbols
        -> success (W, N), data (W, N, 10), overflow (W,). With
        fano_compact_lanes > 0 every gated lane of the batch is decoded
        (_compact_fano); otherwise at most fano_max_lanes gated lanes per
        window, gated first, in one call over W*ML lanes, and the gated
        lanes beyond the cap are the overflow (jit_decoder.py:949-966,
        :984-1000)."""
        dcfg = self.config.demod
        W, N = gate.shape
        dev = gate.device
        cap = dcfg.fano_compact_lanes
        if cap > 0:
            succ, data = self._compact_fano(gate.reshape(W * N),
                                            deint.reshape(W * N, 162), cap)
            return (succ.reshape(W, N), data.reshape(W, N, _NBYTES),
                    torch.zeros(W, dtype=torch.int64, device=dev))
        ML = min(dcfg.fano_max_lanes, N)
        sel = torch.argsort((~gate).to(torch.int8), dim=1, stable=True)[:, :ML]
        g = torch.gather(gate, 1, sel)                          # (W, ML)
        wi = torch.arange(W, device=dev)[:, None]
        out = fano_decode_batch(deint[wi, sel].reshape(W * ML, 162),
                                self.state["mettab"], g.reshape(W * ML),
                                maxcycles=dcfg.maxcycles,
                                delta=dcfg.fano_delta)
        succ = torch.zeros((W, N), dtype=torch.bool, device=dev)
        succ[wi, sel] = out["success"].reshape(W, ML) & g
        data = torch.zeros((W, N, _NBYTES), dtype=torch.uint8, device=dev)
        data[wi, sel] = out["data"].reshape(W, ML, _NBYTES)
        return succ, data, torch.clamp(gate.sum(dim=1) - ML, min=0)

    def _fano_select_batch(self, pre: dict) -> dict:
        """Two-phase Fano (jiggle 0 of every lane, then the other jiggles of
        lanes phase 1 did not decode), first success in jiggle order, then
        on-device OSD when it is on (jit_decoder.py:928-1022)."""
        gate = pre["gate"]
        W, C, J = gate.shape
        dev = gate.device
        widx = torch.arange(W, device=dev)[:, None]
        cidx = torch.arange(C, device=dev)[None, :]
        deint = pre["deint"]
        overflow = pre.get("refine_overflow",
                           torch.zeros(W, dtype=torch.int64, device=dev))

        succ0, data0, over0 = self._fano_phase(gate[:, :, 0], deint[:, :, 0])
        overflow = overflow + over0
        if J == 1:
            any_success = succ0
            jbest = torch.zeros((W, C), dtype=torch.int64, device=dev)
            payload = data0[:, :, :7]
        else:
            R = C * (J - 1)
            gate_rest = (gate[:, :, 1:] & ~succ0[:, :, None]).reshape(W, R)
            succr, datar, over2 = self._fano_phase(
                gate_rest, deint[:, :, 1:].reshape(W, R, 162))
            overflow = overflow + over2
            success = torch.cat([succ0[:, :, None],
                                 succr.reshape(W, C, J - 1)], dim=2)
            data = torch.cat([data0[:, :, None],
                              datar.reshape(W, C, J - 1, _NBYTES)], dim=2)
            any_success = success.any(dim=2)
            jbest = torch.argmax(success.to(torch.int8), dim=2)  # first True
            payload = data[widx, cidx, jbest][..., :7]
        osd = torch.zeros((W, C), dtype=torch.int64, device=dev)
        if self._osd_G is not None:
            any_success, payload, jbest, osd, dropped = self._osd_rescue(
                pre, any_success, payload, jbest)
            overflow = overflow + dropped.sum(dim=1)
        sync = pre["sync2"][widx, cidx, jbest]
        return {
            "success": any_success & pre["worth"], "payload": payload,
            "freq": pre["freq"], "snr": pre["snr"], "sync": sync,
            "shift": pre["shift"], "drift": pre["drift"],
            "mode": pre["mode"], "slm_params": pre["slm_params"],
            "jiggle": jbest, "valid": pre["valid"],
            "fano_overflow": overflow,
            "fano_attempts": gate.sum(dim=(1, 2)),
            "osd": osd,
        }

    def _osd_rescue(self, pre: dict, any_success: torch.Tensor,
                    payload: torch.Tensor, jbest: torch.Tensor):
        """On-device OSD (jit_decoder.py:1046-1118): worth candidates whose
        gated Fano lanes all failed get an order-min(osd_depth, 4) decode of
        their two most-synced gated jiggle lanes. The failed lanes of the
        batch are compacted to osd_max_lanes, failing lanes first in lane
        order; failed lanes beyond the cap come back in ``dropped``.
        Acceptance (the r5 rule): quality >= osd_min_quality and (margin >=
        osd_min_margin, or the two lanes' payloads agree and margin >=
        osd_margin_agree). Only the failed lanes among the compacted ones
        are decoded; the others could not be accepted.

        Fields (W, C[, J]) -> (any_success, payload, jbest, osd, dropped),
        each (W, C[, 7])."""
        dcfg = self.config.demod
        gate, worth, sync2 = pre["gate"], pre["worth"], pre["sync2"]
        W, C, J = gate.shape
        L = W * C
        dev = gate.device
        ar = torch.arange(L, device=dev)
        gate_f = gate.reshape(L, J)
        fail = worth.reshape(L) & gate_f.any(dim=1) & ~any_success.reshape(L)
        skey = torch.where(gate_f, sync2.reshape(L, J), -torch.inf)
        jsel = torch.argmax(skey, dim=1)
        skey[ar, jsel] = -torch.inf
        jsel2 = torch.argmax(skey, dim=1)          # 2nd-best gated lane
        has2 = gate_f.sum(dim=1) >= 2
        ML = min(dcfg.osd_max_lanes, L)
        order = min(dcfg.osd_depth, 4)
        sel = torch.argsort((~fail).to(torch.int8), stable=True)[:ML]
        dropped = fail.clone()
        dropped[sel] = False
        succ = any_success.reshape(L).clone()
        pay = payload.reshape(L, payload.shape[-1]).clone()
        jb = jbest.reshape(L).clone()
        osd = torch.zeros(L, dtype=torch.int64, device=dev)
        n = min(int(fail.sum()), ML)
        if n:
            sel = sel[:n]                          # failed lanes only
            deint = pre["deint"].reshape(L, J, 162)
            lanes = torch.cat([deint[sel, jsel[sel]], deint[sel, jsel2[sel]]])
            u, q, m, _ = osd_decode_lanes(lanes.float(), self._osd_G, order)
            agree = (u[:n] == u[n:]).all(dim=1) & has2[sel]
            q, m = q[:n], m[:n]
            ok = ((q >= dcfg.osd_min_quality)
                  & ((m >= dcfg.osd_min_margin)
                     | (agree & (m >= dcfg.osd_margin_agree))))
            pl = bits_to_payload(u[:n])[:, :pay.shape[-1]]
            pay[sel] = torch.where(ok[:, None], pl, pay[sel])
            jb[sel] = torch.where(ok, jsel[sel], jb[sel])
            succ[sel] = succ[sel] | ok
            osd[sel] = ok.to(torch.int64) * order
        return (succ.reshape(W, C), pay.reshape(W, C, -1), jb.reshape(W, C),
                osd.reshape(W, C), dropped.reshape(W, C))

    # -- hybrid engine (jit_decoder.py:572-592, :1120-1212) -----------------

    @staticmethod
    def _pack_prefano(pre: dict) -> torch.Tensor:
        """Candidate metadata, gates and deinterleaved symbols in one
        (W, C, 12+164J) float32 tensor:
        0 valid 1 worth 2 freq 3 snr 4 shift 5 drift 6 mode 7:11 slm
        11:11+J sync2  11+J:11+2J gate  11+2J:11+(2+162)J symbols
        11+164J (last): refine overflow of the window (the host Fano has
        no cap)."""
        f32 = torch.float32
        W, C, J = pre["gate"].shape
        head = torch.stack([pre[k].to(f32) for k in (
            "valid", "worth", "freq", "snr", "shift", "drift", "mode")],
            dim=-1)                                             # (W, C, 7)
        ovf = pre.get("refine_overflow")
        ovf = (torch.zeros((W, C, 1), dtype=f32, device=head.device)
               if ovf is None else ovf.to(f32)[:, None, None].expand(W, C, 1))
        return torch.cat([head, pre["slm_params"].to(f32),
                          pre["sync2"].to(f32), pre["gate"].to(f32),
                          pre["deint"].reshape(W, C, J * 162).to(f32), ovf],
                         dim=-1)

    def host_fano_assemble(self, a) -> DeviceDecoderOutput:
        """Packed prefano (..., C, 12+164J) -> two-phase Fano on the host
        through fec.host with config.fano_backend, first success in jiggle
        order, then host OSD (fec.osd.accept_osd plus the unpack screen)
        for worth candidates whose gated lanes all failed when osd_depth >
        0 (jit_decoder.py:1120-1212)."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        dcfg = self.config.demod
        a = np.asarray(a)
        C, J = self.n_cand, dcfg.n_jiggles
        lead = a.shape[:-2]
        flat = a.reshape(-1, C, a.shape[-1])
        W = flat.shape[0]
        valid = flat[..., 0] > 0.5
        worth = flat[..., 1] > 0.5
        freq = flat[..., 2].astype(np.float32)
        snr = flat[..., 3].astype(np.float32)
        shift = flat[..., 4].astype(np.int32)
        drift = flat[..., 5].astype(np.float32)
        mode = flat[..., 6].astype(np.int32)
        slm = flat[..., 7:11].astype(np.float32)
        sync2 = flat[..., 11:11 + J].astype(np.float32)         # (W, C, J)
        gate = flat[..., 11 + J:11 + 2 * J] > 0.5
        deint = (flat[..., 11 + 2 * J:11 + (2 + 162) * J]
                 .reshape(W, C, J, 162).astype(np.uint8))
        refine_overflow = flat[..., 0, -1].astype(np.int32)     # (W,)

        def fano(symbols, active):
            succ, data, _, _, _ = fano_decode_batch_host(
                symbols.reshape(-1, 162), active.reshape(-1),
                backend=self.config.fano_backend, device=self.device,
                mettab=FANO_METTAB, delta=dcfg.fano_delta,
                maxcycles=dcfg.maxcycles)
            return succ.reshape(active.shape) & active, data
        # two phases, as on the device: jiggle 0, then the other jiggles of
        # candidates whose jiggle-0 lane failed
        succ0, data0 = fano(deint[:, :, 0], gate[:, :, 0])
        success = succ0[:, :, None]
        data = data0.reshape(W, C, 1, -1)
        if J > 1:
            gate_rest = gate[:, :, 1:] & ~succ0[:, :, None]
            succr, datar = fano(deint[:, :, 1:], gate_rest)
            success = np.concatenate([success, succr], axis=2)
            data = np.concatenate([data, datar.reshape(W, C, J - 1, -1)],
                                  axis=2)
        any_s = success.any(axis=-1)
        jbest = np.argmax(success, axis=-1).astype(np.int32)    # first True
        wi, ci = np.indices((W, C))
        payload = data[wi, ci, jbest, :7]

        osd = np.zeros((W, C), np.int32)
        if dcfg.osd_depth > 0:
            for w, c in zip(*np.nonzero(worth & ~any_s & gate.any(axis=-1))):
                j, pl = accept_osd(deint[w, c], gate[w, c], sync2[w, c], dcfg)
                if pl is None or unpack_message(pl) is None:
                    continue
                any_s[w, c] = True
                payload[w, c] = np.frombuffer(pl, np.uint8)
                jbest[w, c] = j
                osd[w, c] = dcfg.osd_depth
        return DeviceDecoderOutput(
            success=(any_s & worth).reshape(*lead, C),
            payload=payload.reshape(*lead, C, 7),
            freq=freq.reshape(*lead, C),
            snr=snr.reshape(*lead, C),
            sync=sync2[wi, ci, jbest].reshape(*lead, C),
            shift=shift.reshape(*lead, C),
            drift=drift.reshape(*lead, C),
            mode=mode.reshape(*lead, C),
            slm_params=slm.reshape(*lead, C, 4),
            jiggle=jbest.reshape(*lead, C),
            valid=valid.reshape(*lead, C),
            fano_overflow=refine_overflow.reshape(lead),
            fano_attempts=gate.sum(axis=(1, 2)).astype(np.int32)
            .reshape(lead),
            osd=osd.reshape(*lead, C),
        )

    # -- output packing (jit_decoder.py:178-230) ----------------------------

    @staticmethod
    def _pack(out: dict) -> torch.Tensor:
        """Field dict -> one (W, C, 23) float32 tensor:
        0 success 1 valid 2 freq 3 snr 4 sync 5 shift 6 drift 7 mode
        8 jiggle 9:13 slm_params 13:20 payload 20 fano_overflow
        21 fano_attempts 22 osd (0 = Fano, else the OSD order)."""
        f32 = torch.float32
        head = torch.stack([out[k].to(f32) for k in (
            "success", "valid", "freq", "snr", "sync", "shift", "drift",
            "mode", "jiggle")], dim=-1)                         # (W, C, 9)
        lead = head.shape[:-1]

        def percol(v):
            return v.to(f32)[:, None, None].expand(lead + (1,))
        return torch.cat([head, out["slm_params"].to(f32),
                          out["payload"].to(f32),
                          percol(out["fano_overflow"]),
                          percol(out["fano_attempts"]),
                          out["osd"].to(f32)[..., None]], dim=-1)

    @staticmethod
    def unpack_output(a) -> DeviceDecoderOutput:
        """Packed (..., C, 23) float32 (tensor or array) -> typed output."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        return DeviceDecoderOutput(
            success=a[..., 0] > 0.5,
            valid=a[..., 1] > 0.5,
            freq=a[..., 2].astype(np.float32),
            snr=a[..., 3].astype(np.float32),
            sync=a[..., 4].astype(np.float32),
            shift=a[..., 5].astype(np.int32),
            drift=a[..., 6].astype(np.float32),
            mode=a[..., 7].astype(np.int32),
            jiggle=a[..., 8].astype(np.int32),
            slm_params=a[..., 9:13].astype(np.float32),
            payload=a[..., 13:20].astype(np.uint8),
            fano_overflow=a[..., 0, 20].astype(np.int32),
            fano_attempts=a[..., 0, 21].astype(np.int32),
            osd=a[..., 22].astype(np.int32),
        )

    @staticmethod
    def messages(out: DeviceDecoderOutput, hashtable=None) -> list[str]:
        """Decoded message texts of one window's output."""
        msgs = []
        for c in np.flatnonzero(out.success):
            u = unpack_message(bytes(out.payload[c]), hashtable)
            if u is not None:
                msgs.append(u.text)
        return msgs

    @staticmethod
    def spots(out: DeviceDecoderOutput, hashtable=None) -> list[Spot]:
        """One window's output -> pipeline.decoder.Spot list (host unpack).
        An OSD candidate whose payload fails protocol unpacking is dropped
        (jit_decoder.py:1244-1275)."""
        spots = []
        for c in np.flatnonzero(out.success):
            payload = bytes(out.payload[c])
            u = unpack_message(payload, hashtable)
            if u is None and int(out.osd[c]) > 0:
                continue
            spots.append(Spot(
                message=u.text if u is not None else "",
                payload=payload,
                freq=float(out.freq[c]),
                snr=float(out.snr[c]),
                sync=float(out.sync[c]),
                shift=int(out.shift[c]),
                drift=float(out.drift[c]),
                mode=int(out.mode[c]),
                slm_params=tuple(np.asarray(out.slm_params[c], float))
                if int(out.mode[c]) else (),
                candidate=int(c),
                jiggle=int(out.jiggle[c]),
                unpacked=u,
                osd=int(out.osd[c]),
            ))
        return spots


def _offsets_f32(step: float, device) -> torch.Tensor:
    """(-2..2) * step in float32, as jnp.arange(-2, 3) * step."""
    return torch.arange(-2, 3, dtype=torch.float32, device=device) \
        * np.float32(step)


__all__ = ["DeviceDecoder", "DeviceDecoderOutput", "FANO_MODES",
           "check_slice"]
