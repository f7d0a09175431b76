"""Batched window decoder on one device: samples in, packed messages out.

Counterpart of uwspr_tpu/pipeline/jit_decoder.py::DeviceDecoder, batched
as its ``_decode_windows_batched`` (jit_decoder.py:698-730), which the
JAX decoder jits (jit_decoder.py:156-176):

  STFT power (stft_impl "pallas": the fused CUDA kernel, computing only
  the columns read) -> smoothed SNR spectrum -> peak pick -> coarse sync
  grid (the sync-grid kernel; bf16 planes when hpbm > 32) ->
  exact model selection (CUDA kernel) -> phase A/B probe refinement ->
  joint fine grid, soft symbols over all jiggles (each probe call one
  lane-probe kernel launch at probe dtype "bf16", demod/finesync.py::
  lane_probe), sync/rms gates, deinterleave -> Fano (CUDA kernel) ->
  first success in jiggle order -> on-device OSD of the worth candidates
  whose gated lanes all failed (osd_depth > 0, fec/osd_torch.py) ->
  packed (W, C, 23) float32.

The lanes the refinement runs on (``prefano``, one path): phase A/B on
the head lanes, the valid candidates of the batch strongest coarse SNR
first, at most cand_compact_lanes of them, or with cand_compact_lanes == 0
every W*C lane in order; the tail (fine grid to deinterleave) on the
worthy head lanes first, at most refine_max_lanes of them (or all head
lanes), or, with neither knob on, on every head lane. The results go back
to the W*C lanes once, and refine_overflow counts per window the valid
lanes not kept and the worthy lanes not tailed. The Fano: with
fano_compact_lanes > 0 every gated lane of the batch, never dropped,
every jiggle at once in one call (_fano_jiggles; the JAX program's two
phases, jiggle 0 and then the other jiggles of the candidates it did not
decode, give the same first success); otherwise two phases of at most
fano_max_lanes gated lanes per window each, the rest counted in
fano_overflow. The OSD
lanes: the failed lanes of the whole batch, compacted to osd_max_lanes
(the rest counted in fano_overflow). fano_mode "host" (the hybrid engine)
stops after the gates and packs the soft symbols (_pack_prefano);
``host_fano_assemble`` runs the Fano on the host through ``fec.host``
with ``config.fano_backend``, and host OSD when osd_depth > 0.

``__call__`` decodes one window with the reference's per-window program
(jit_decoder.py:594-696, :1214-1220): the batch path at W = 1 with the
three batch knobs (cand_compact_lanes, refine_max_lanes,
fano_compact_lanes) at 0, so every lane is refined, each Fano phase takes
at most fano_max_lanes gated lanes and OSD is compacted over the window's
C lanes.

PyTorch runs eagerly, so the JAX decoder's vmap over windows is a batch
dimension written out. As the JAX decoder's dispatch does, the device
engine queues a batch's work and returns without waiting for the card: no
Python value depends on a tensor's contents, every shape is fixed by the
config and the batch, and a host input goes out from pinned memory without
blocking. ``fetch`` (``unpack_output``, the hybrid engine's host Fano) is
where the host waits. On a CUDA device the packed output's copy to the
host is queued with the batch (``_copy_to_host``), so that with several
batches in flight the fetch of one waits for that batch alone, and not for
the batches queued after it. That holds in every config: the device OSD
(osd_depth > 0) decodes osd_max_lanes lanes a batch with the failed mask
as its kernel's ``active`` (``_osd_rescue``), as the JAX program does.

So on a CUDA device a batch is one program, as the JAX decoder's jit is:
``decode_windows_ri`` runs through the decoder's ``CapturedProgram``
(pipeline/captured.py), one CUDA graph per input shape (W, 2, fl),
captured at the shape's first call and replayed after it: a warm call is
the input copy, one replay and the output's clone. ``captured.eager()``
runs the launches one by one instead (for recorders and stage splits). On
the CPU the decode runs eagerly.

Tracing: ``decode_windows_ri``, ``fetch`` and ``spots`` are the host spans
``uwspr.decoder.submit``, ``.fetch`` and ``.spots`` while a profiler runs
(utils/profiler.py); a batch's number (``batches``, counted per
``decode_windows_ri`` call) tags its submit, rides on its handle
(``uwspr_request``) and tags its fetch. Inside the batch program each stage
starts with its marker kernel (ops/marks.py), in ``marks.STAGES`` order,
and ``uwspr_mark_end`` follows the packed output, so a device trace of a
replay splits by stage.

Multipass (``config.multipass.passes`` P > 1, the device engine): the
batch program decodes the batch P times inside the one captured graph,
WSJT-X's successive cancellation (pipeline/multipass.py's
``multipass_spots`` for every window of the batch at once). Pass 1 is the
single-pass program on the input. After each pass but the last, the pass's
new decodes (a decode whose payload an earlier pass reported in its window
within ``multipass.DUP_FREQ_HZ`` is a duplicate, dropped from the output) are
compacted window-major to ``subtract_max_lanes`` lanes and subtracted from
a residual copy of the batch (ops/subtract.py, one kernel launch: each
window's frames in order, each fitted against the residual of the ones
before it); a frame over the cap is not subtracted and counts in its
window's ``fano_overflow``. The next pass decodes the residual, with the
candidates of every window where nothing was subtracted marked invalid
before the lane compaction, so its Fano and OSD lanes are those of the
windows that changed. Every shape is fixed by the config and the batch and
nothing waits on the host. The packed output is (W, P*C, 23): slot p*C + c
is pass p's candidate c, each window's fano_attempts and fano_overflow are
the sums over the passes; ``unpack_output(a, n_cand)`` gives each slot's
pass (``pass_index``), and ``spots`` sets it. ``mp_counts`` (MP_TALLY) is
the device tally of the passes, read by ``mp_tally()``. With P == 1 the
program is the single-pass one, operator for operator. The hybrid engine
(fano_mode "host") refuses P > 1.

truncate_stage is not ported (the stage markers split the stages) and
raises NotImplementedError.
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
    lane_probe,
    lane_window_base,
    probe_constants,
)
from uwspr_tpu_torch.device import exact_f32, resolve_device, to_device
from uwspr_tpu_torch.fec.fano import fano_decode_batch, fano_decode_jiggles
from uwspr_tpu_torch.fec.host import check_backend, fano_decode_batch_host
from uwspr_tpu_torch.fec.osd import accept_osd
from uwspr_tpu_torch.fec.osd_torch import bits_to_payload, osd_decode_lanes
from uwspr_tpu_torch.models.slm import slm_frequency_drift_torch
from uwspr_tpu_torch.ops import marks
from uwspr_tpu_torch.ops.select import select_best
from uwspr_tpu_torch.ops.stft import stft_constants, stft_power_core
from uwspr_tpu_torch.ops.subtract import subtract_lanes
from uwspr_tpu_torch.params import state_from_numpy, state_keys, state_numpy
from uwspr_tpu_torch.pipeline.captured import CapturedProgram
from uwspr_tpu_torch.pipeline.decoder import Spot
from uwspr_tpu_torch.pipeline.multipass import (DUP_FREQ_HZ, FREQ_ITERS,
                                               LAG_SEARCH, NFILT)
from uwspr_tpu_torch.protocol.constants import FANO_METTAB, N_CODED_BITS
from uwspr_tpu_torch.protocol.messages import unpack_message
from uwspr_tpu_torch.utils.profiler import span

_NBYTES = 10        # Fano harvest bytes; the payload is the first 7
# DeviceDecoder.fano_counts, by index
FANO_TALLY = ("decodes", "speculative_lanes", "speculative_aborted",
              "speculative_looks")
# DeviceDecoder.osd_counts, by index
OSD_TALLY = ("decodes", "active_lanes", "accepted_margin",
             "accepted_agreement", "dropped")
# DeviceDecoder.mp_counts, by index: the decodes that ran the passes, the
# frames subtracted, the new frames over subtract_max_lanes, the
# duplicates dropped; then, for each pass, MP_PASS_TALLY
MP_TALLY = ("decodes", "subtracted", "over_cap", "duplicates")
MP_PASS_TALLY = ("windows", "spots")    # windows decoded, new spots


def mp_tally_names(passes: int) -> tuple[str, ...]:
    """The names of ``mp_counts`` at ``passes`` passes: MP_TALLY, then
    ``<name>_pass<p>`` for p = 1..passes and each name of MP_PASS_TALLY."""
    return MP_TALLY + tuple(f"{k}_pass{p}" for p in range(1, passes + 1)
                            for k in MP_PASS_TALLY)


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
    # the multipass pass (0-based) of each slot; None for one pass
    pass_index: np.ndarray | None = None

    def window(self, w: int) -> "DeviceDecoderOutput":
        return DeviceDecoderOutput(**{
            f.name: getattr(self, f.name)[w]
            for f in dataclasses.fields(self) if f.name != "pass_index"},
            pass_index=(None if self.pass_index is None
                        else self.pass_index[w]))


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


def _copy_to_host(x: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event]:
    """(x's copy in pinned host memory, the event that marks it done): the
    copy is queued on the current stream now, behind the work that makes x
    and ahead of any work queued later."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


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
        passes = self.config.multipass.passes
        if passes < 1:
            raise ValueError(f"multipass.passes must be >= 1, got {passes}")
        if passes > 1 and fano_mode == "host":
            raise ValueError("multipass runs in the device engine's batch "
                             "program; the hybrid engine (fano_mode "
                             "'host') takes one pass")
        self.fano_mode = fano_mode
        self.device = resolve_device(device)
        self.n_cand = max_peaks(self.config.coarse)
        if state is None:
            state = state_numpy(self.config)
        self.state = state_from_numpy(state, self.device,
                                      keys=state_keys(self.config))
        # the spread of the jiggle lags, which the probe kernel sizes by
        jig = np.asarray(state["jiggles"])
        self._jiggle_span = int(jig.max() - jig.min())
        if self.state["jiggles"].shape[0] != self.config.demod.n_jiggles:
            raise ValueError("state jiggles do not match n_jiggles")
        # on-device OSD: only when osd_depth > 0 and osd_max_lanes > 0
        # (jit_decoder.py:127-134); the hybrid engine runs the host OSD
        self._osd_G = self.state.get("osd_G") if fano_mode == "device" \
            else None
        self._per_window = None
        # FANO_TALLY over every _fano_jiggles call (see fano_tally)
        self.fano_counts = torch.zeros(len(FANO_TALLY), dtype=torch.int64,
                                       device=self.device)
        # OSD_TALLY over every _osd_rescue call (see osd_tally)
        self.osd_counts = torch.zeros(len(OSD_TALLY), dtype=torch.int64,
                                      device=self.device)
        # mp_tally_names(passes) over every multipass decode (see mp_tally)
        self.mp_names = mp_tally_names(passes)
        self.mp_counts = torch.zeros(len(self.mp_names), dtype=torch.int64,
                                     device=self.device)
        # the batch program on a card (None on the CPU, which runs eagerly)
        self.program = (CapturedProgram(self.device, self._decode)
                        if self.device.type == "cuda" else None)
        # decode_windows_ri calls so far: the next batch's number
        self.batches = 0
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
        (``_pack_prefano``; ``host_fano_assemble`` decodes it).

        Returns once the batch's work is queued on the current stream,
        without waiting for the card (the JAX decoder's dispatch): the
        packed tensor is a handle, and ``fetch`` waits for it. A numpy
        input is copied from pinned memory without blocking. So a caller
        keeps several handles in flight by calling this for each batch
        before fetching the first. The device OSD (osd_depth > 0) adds one
        kernel launch at a fixed shape and no wait (``_osd_rescue``).

        On a CUDA device the batch is the decoder's captured program at
        this input shape (see the module doc): the first call of a shape
        also captures it, and waits on the host; a later one copies the
        input into the graph's static input and replays it.

        The handle carries the batch's number as ``uwspr_request``."""
        n = self.batches
        self.batches += 1
        with span("decoder.submit", n):
            ri = torch.as_tensor(ri)
            if ri.dim() != 3 or ri.shape[1] != 2:
                raise ValueError(f"ri must be (W, 2, fl), got "
                                 f"{tuple(ri.shape)}")
            if ri.dtype != torch.float32:
                raise ValueError(f"ri must be float32, got {ri.dtype}")
            if self.program is not None:
                packed = self.program(ri)
            else:
                packed = self._decode(to_device(ri, self.device))
            if packed.is_cuda and self.fano_mode == "device":
                packed.uwspr_host = _copy_to_host(packed)
        packed.uwspr_request = n
        return packed

    def _decode(self, ri: torch.Tensor) -> torch.Tensor:
        """The batch program: (W, 2, fl) on the decoder's device -> the
        packed output (full f32 products, no autograd), each stage after
        its marker (ops/marks.py)."""
        with torch.no_grad(), exact_f32():
            if self.config.multipass.passes > 1:
                packed = self._decode_passes(ri)
                marks.mark("end", ri)
                return packed
            pre = self.prefano(ri)
            if self.fano_mode == "host":
                marks.mark("pack", ri)
                packed = self._pack_prefano(pre)
            else:
                out = self._fano_select_batch(pre)
                marks.mark("pack", ri)
                packed = self._pack(out)
            marks.mark("end", ri)
            return packed

    def decode_ri_batch(self, ri: torch.Tensor | np.ndarray
                        ) -> DeviceDecoderOutput:
        """(W, 2, fl) float32 windows -> typed output, following fano_mode
        (jit_decoder.py:1228-1233): ``decode_windows_ri``, which queues the
        batch without a host wait, then ``fetch``, which waits for it."""
        return self.fetch(self.decode_windows_ri(ri))

    def fetch(self, packed: torch.Tensor) -> DeviceDecoderOutput:
        """A packed result of decode_windows_ri (any leading dims) -> typed
        output: unpacked, or in fano_mode "host" Fano-decoded on the host.
        Waits for the card to finish the batch: for a handle of
        decode_windows_ri on a CUDA device, for the copy to the host that
        call queued, and so not for a batch queued after it."""
        with span("decoder.fetch", getattr(packed, "uwspr_request", None)):
            if self.fano_mode == "host":
                return self.host_fano_assemble(packed)
            queued = getattr(packed, "uwspr_host", None)
            if queued is not None:
                host, done = queued
                done.synchronize()
                packed = host
            # a single pass gives no pass_index, so its host path (the
            # ring's device_result a channel) is the single-pass one
            return self.unpack_output(
                packed,
                self.n_cand if self.config.multipass.passes > 1 else None)

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
        lanes). The copy has its own captured program: its W = 1 graph is
        another program than the batch path's at W = 1."""
        if self._per_window is None:
            demod = dataclasses.replace(
                self.config.demod, cand_compact_lanes=0, refine_max_lanes=0,
                fano_compact_lanes=0)
            w = copy.copy(self)
            w.config = dataclasses.replace(self.config, demod=demod)
            if self.program is not None:
                w.program = CapturedProgram(self.device, w._decode)
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
        model selection walks: ``coarse_score_grid``, the sync-grid kernel
        on a card and its plain version on the CPU. The port reads
        ``grid_impl`` only for the "auto" grid_dtype."""
        cfg = self.config.coarse
        m = cfg.fft_size // 2
        cb0 = self._cols[0]
        stft_impl = "fft" if cfg.stft_impl == "auto" else cfg.stft_impl
        marks.mark("stft", z_all)
        ps = stft_power_core(z_all, n_ffts=cfg.n_ffts, size=cfg.fft_size,
                             hop=cfg.spb // 2, impl=stft_impl,
                             col_window=self._cols, consts=self._stft_consts)
        marks.mark("coarse", z_all)
        sm = smoothed_snr_spectrum(ps, hpbm=cfg.hpbm, m=m, col0=cb0)
        valid, if0, snr = self._peaks(sm)
        # grid_dtype "auto": bf16 planes where the JAX program takes the
        # einsum (grid_impl "einsum", or "auto" at hpbm > 32), f32 where it
        # takes the conv (jit_decoder.py:350-361); an explicit value stands
        grid_dtype = cfg.grid_dtype
        if grid_dtype == "auto":
            einsum = cfg.grid_impl == "einsum" or (
                cfg.grid_impl == "auto" and cfg.hpbm > 32)
            grid_dtype = "bf16" if einsum else "f32"
        syncgrid = coarse_score_grid(
            ps, if0 - cb0, self.state["offsets"], self.state["sign"],
            f_window=(m - cfg.hpbm - 1 - 6 - cb0, m + cfg.hpbm + 1 + 6 - cb0),
            dtype=grid_dtype)
        return {"valid": valid, "if0": if0, "snr": snr, "grid": syncgrid}

    def _coarse_stage(self, z_all: torch.Tensor) -> dict:
        cfg = self.config.coarse
        cg = self.coarse_grid(z_all)
        grid = cg["grid"]
        W, C = grid.shape[:2]
        Mdim = grid.shape[-1]
        marks.mark("select", grid)
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

    def _probe(self, ri, widx, base, dsyms, lags, freqs, **k):
        """lane_probe at the config's probe dtype: a (sync, p) per drift
        set."""
        return lane_probe(ri, widx, base, dsyms, lags, freqs,
                          dtype=self.config.demod.probe_dtype,
                          consts=self._probe_consts, **k)

    def _refine_common(self, st: dict, ri: torch.Tensor,
                       widx: torch.Tensor) -> dict:
        """Phase A (coarse lag/freq joint grid) and phase B (linear drift
        +/-0.5) over the head lanes, lane l reading window widx[l] of ri
        (jit_decoder.py:412-502)."""
        dcfg = self.config.demod
        dev = st["freq"].device
        marks.mark("refine", st["freq"])
        valid = st["valid"]
        mode, slm_params = st["mode"], st["slm_params"]
        C = valid.shape[0]
        cidx = torch.arange(C, device=dev)
        f1 = st["freq"].float()
        shift1 = st["shift"]
        drift1 = st["drift"]
        dsym = self._drift_offsets(mode, drift1, slm_params)
        N = ri.shape[-1]

        # phase A: W = 640 is exactly minimal for the +/-128 lag grid at
        # block 128 (jit_decoder.py:446-450); never narrow it
        base1 = lane_window_base(shift1, N, reach=128, W=640, block=128)
        lag_grid = shift1[:, None] + torch.arange(-128, 129, 64, device=dev)
        freq_grid = f1[:, None] + _offsets_f32(0.25, dev)[None, :]
        [(s, _)] = self._probe(ri, widx, base1, [dsym], lag_grid, freq_grid,
                               width=640, span=256)              # (C, 5, 5)
        li = torch.argmax(s[:, 2, :], dim=1)          # stage 0: lag @ f0
        shift1 = lag_grid[cidx, li]
        fi2 = torch.argmax(s[cidx, :, li], dim=1)     # stage 1: freq @ lag
        f1 = freq_grid[cidx, fi2]
        sync1 = s[cidx, fi2, li]

        # phase B: window centred on the refined lag, both drifts on its
        # columns [96, 480)
        base2 = lane_window_base(shift1, N, reach=96, W=640, block=128)
        is_lin = mode != 1
        driftp = drift1 + 0.5
        driftm = drift1 - 0.5
        (sp, _), (sm_, _) = self._probe(
            ri, widx, base2, [self._drift_offsets(mode, driftp, slm_params),
                              self._drift_offsets(mode, driftm, slm_params)],
            shift1[:, None], f1[:, None], width=384, off=96, span=0)
        sp, sm_ = sp[:, 0, 0], sm_[:, 0, 0]
        updp = is_lin & (sp > sync1)
        updm = is_lin & ~updp & (sm_ > sync1)
        drift1 = torch.where(updp, driftp, torch.where(updm, driftm, drift1))
        sync1 = torch.where(updp, sp, torch.where(updm, sm_, sync1))
        return {
            "valid": valid, "snr": st["snr"], "freq": f1, "shift": shift1,
            "drift": drift1, "mode": mode, "slm_params": slm_params,
            "worth0": sync1 > dcfg.minsync1, "widx": widx, "base2": base2,
        }

    def _prefano_tail(self, st: dict, ri: torch.Tensor) -> dict:
        """Joint fine grid, soft symbols over all jiggles, gates and
        deinterleave over the tail lanes, each reading phase B's window of
        ri (jit_decoder.py:504-570)."""
        dcfg = self.config.demod
        dev = st["freq"].device
        marks.mark("prefano_tail", st["freq"])
        C = st["shift"].shape[0]
        cidx = torch.arange(C, device=dev)
        valid = st["valid"]
        f1, shift1, drift1 = st["freq"], st["shift"], st["drift"]
        mode, slm_params = st["mode"], st["slm_params"]
        dsym = self._drift_offsets(mode, drift1, slm_params)
        widx, base2 = st["widx"], st["base2"]

        worth = st["worth0"]
        lag_grid = shift1[:, None] + torch.arange(-32, 33, 16, device=dev)
        freq_grid = f1[:, None] + _offsets_f32(0.05, dev)[None, :]
        [(s, _)] = self._probe(ri, widx, base2, [dsym], lag_grid, freq_grid,
                               width=640, span=64)               # (C, 5, 5)
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
        [(sync2, p)] = self._probe(ri, widx, base2, [dsym], lag_grid,
                                   f1[:, None], width=640,
                                   span=self._jiggle_span)
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

    def prefano(self, ri: torch.Tensor,
                windows: torch.Tensor | None = None) -> dict:
        """(W, 2, fl) -> per-window candidate state, gates and deinterleaved
        symbols, each (W, C, ...), and ``refine_overflow`` (W,): coarse
        search on every window, then the refinement on the lanes the
        config picks (see the module doc), scattered back once
        (jit_decoder.py:283-300, :732-863). ``windows``, a (W,) bool mask
        (a multipass pass after the first), marks the candidates of the
        other windows invalid before the lanes are picked."""
        dcfg = self.config.demod
        z_all = torch.complex(ri[:, 0], ri[:, 1])
        coarse = self._coarse_stage(z_all)
        if windows is not None:
            coarse["valid"] = coarse["valid"] & windows[:, None]
        marks.mark("compact", z_all)
        W, C = coarse["valid"].shape
        L = W * C
        dev = z_all.device
        flat = {k: v.reshape((L,) + v.shape[2:]) for k, v in coarse.items()}

        # head lanes (phase A/B): the valid lanes of the batch strongest
        # coarse SNR first, or every lane in order (sel None)
        if dcfg.cand_compact_lanes > 0:
            key = torch.where(flat["valid"], -flat["snr"], float("inf"))
            sel = torch.argsort(key, stable=True)[
                :min(dcfg.cand_compact_lanes, L)]
            widx = torch.div(sel, C, rounding_mode="floor")
            st = {k: v[sel] for k, v in flat.items()}
        else:
            sel = None
            widx = torch.arange(W, device=dev).repeat_interleave(C)
            st = flat
        head = self._refine_common(st, ri, widx)
        n_head = head["valid"].shape[0]

        # tail lanes (fine grid to deinterleave): the worthy head lanes
        # first, or every head lane with worth0 unmasked (sel2 None; the
        # JAX program's all-lanes path also moves freq and shift of
        # invalid lanes)
        if sel is not None or dcfg.refine_max_lanes > 0:
            worthy = head["worth0"] & head["valid"]
            sel2 = torch.argsort((~worthy).to(torch.int8), stable=True)[
                :min(dcfg.refine_max_lanes or n_head, n_head)]
            sub = {k: head[k][sel2]
                   for k in ("valid", "freq", "shift", "drift", "mode",
                             "slm_params", "widx", "base2")}
            sub["worth0"] = worthy[sel2]
        else:
            sel2, sub = None, head
        tail = self._prefano_tail(sub, ri)
        # the tail lanes among the L
        gsel = sel2 if sel is None else sel[sel2]

        def put(idx, vals, base=None):
            """vals on lanes idx of a copy of base (of zeros for None), or
            vals itself when idx is None (every lane)."""
            if idx is None:
                return vals
            if base is None:
                base = torch.zeros((L,) + vals.shape[1:], dtype=vals.dtype,
                                   device=dev)
            out = base.clone()
            out[idx] = vals
            return out

        # the coarse values, the head's on its lanes, the tail's on top
        freq, shift, drift = (put(sel, head[k], flat[k])
                              for k in ("freq", "shift", "drift"))
        # refine_overflow: the valid lanes not kept, and the worthy head
        # lanes not tailed
        if sel2 is None:
            overflow = torch.zeros(W, dtype=torch.int64, device=dev)
        else:
            def mask(n, idx):
                return torch.zeros(n, dtype=torch.bool,
                                   device=dev).index_fill_(0, idx, True)
            kept = (torch.ones(L, dtype=torch.bool, device=dev)
                    if sel is None else mask(L, sel))
            tailed = mask(n_head, sel2)
            dropped = torch.zeros(L, dtype=torch.bool, device=dev)
            dropped[slice(None) if sel is None else sel] = worthy & ~tailed
            overflow = ((flat["valid"] & ~kept).reshape(W, C).sum(dim=1)
                        + dropped.reshape(W, C).sum(dim=1))

        def unflat(v):
            return v.reshape((W, C) + v.shape[1:])
        return {
            "valid": coarse["valid"], "snr": coarse["snr"],
            "mode": coarse["mode"], "slm_params": coarse["slm_params"],
            "drift": unflat(drift),
            "worth": unflat(put(gsel, tail["worth"])),
            "freq": unflat(put(gsel, tail["freq"], freq)),
            "shift": unflat(put(gsel, tail["shift"], shift)),
            **{k: unflat(put(gsel, tail[k]))
               for k in ("sync2", "gate", "deint")},
            "refine_overflow": overflow,
        }

    # -- Fano (jit_decoder.py:865-1022) -------------------------------------

    def _fano_phase(self, gate: torch.Tensor, deint: torch.Tensor):
        """One phase of the capped Fano (fano_compact_lanes == 0) over
        (W, N) gated lanes with (W, N, 162) symbols -> success (W, N), data
        (W, N, 10), overflow (W,): at most fano_max_lanes gated lanes per
        window, gated first, in one call over W*ML lanes, and the gated
        lanes beyond the cap are the overflow (jit_decoder.py:949-966,
        :984-1000)."""
        dcfg = self.config.demod
        W, N = gate.shape
        dev = gate.device
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

    def _fano_jiggles(self, gate: torch.Tensor, deint: torch.Tensor):
        """Every gated (candidate, jiggle) lane of the batch in one
        ``fano_decode_jiggles`` call: (W, C, J) gate, (W, C, J, 162) symbols
        -> success (W, C, J) masked to the gate, data (W, C, J, 10). A lane
        stopped because a lower jiggle of its candidate decoded reports no
        success, so the first success in jiggle order is the two phases'
        (jit_decoder.py:928-1022).

        Adds to ``fano_counts`` on the device, with no host read: one
        decode, the speculative lanes (gated jiggles >= 1 of candidates
        whose jiggle 0 decoded, which the two phases would not walk), how
        many of them stopped early, and the forward looks they spent."""
        dcfg = self.config.demod
        W, C, J = gate.shape
        out = fano_decode_jiggles(deint.reshape(W * C, J, 162),
                                  gate.reshape(W * C, J),
                                  self.state["mettab"],
                                  maxcycles=dcfg.maxcycles,
                                  delta=dcfg.fano_delta)
        success = out["success"] & gate.reshape(W * C, J)
        spec = gate.reshape(W * C, J)[:, 1:] & success[:, :1]
        looks = torch.clamp(out["cycles"][:, 1:] - 1,
                            max=dcfg.maxcycles * N_CODED_BITS)
        self.fano_counts += torch.stack([
            torch.ones((), dtype=torch.int64, device=gate.device),
            spec.sum(), (spec & out["aborted"][:, 1:]).sum(),
            torch.where(spec, looks, 0).sum()])
        return (success.reshape(W, C, J),
                out["data"].reshape(W, C, J, _NBYTES))

    def fano_tally(self) -> dict:
        """``fano_counts`` on the host, by FANO_TALLY name: the decodes that
        ran ``_fano_jiggles`` (each captured replay and eager run), and
        over them the speculative lanes, how many stopped early and the
        forward looks they spent. Waits for the card (one read); the
        serving path never calls it."""
        return dict(zip(FANO_TALLY, self.fano_counts.tolist()))

    def osd_tally(self) -> dict:
        """``osd_counts`` on the host, by OSD_TALLY name: the decodes that
        ran ``_osd_rescue`` (each captured replay and eager run), and over
        them the rescue lanes decoded (active, each decoded on two jiggle
        lanes), those accepted by the margin screen, those accepted by
        cross-jiggle agreement alone, and the failed lanes dropped over
        osd_max_lanes. Waits for the card (one read); the serving path
        never calls it."""
        return dict(zip(OSD_TALLY, self.osd_counts.tolist()))

    def _fano_select_batch(self, pre: dict) -> dict:
        """Fano over the gated lanes, first success in jiggle order, then
        on-device OSD when it is on (jit_decoder.py:928-1022). With
        fano_compact_lanes > 0 every jiggle in one call
        (``_fano_jiggles``); otherwise the capped two phases: jiggle 0 of
        every lane, then the other jiggles of lanes phase 1 did not
        decode."""
        gate = pre["gate"]
        W, C, J = gate.shape
        dev = gate.device
        widx = torch.arange(W, device=dev)[:, None]
        cidx = torch.arange(C, device=dev)[None, :]
        deint = pre["deint"]
        overflow = pre["refine_overflow"]

        marks.mark("fano1", gate)
        if self.config.demod.fano_compact_lanes > 0:
            success, data = self._fano_jiggles(gate, deint)
            if J > 1:
                marks.mark("fano2", gate)
        else:
            succ0, data0, over0 = self._fano_phase(gate[:, :, 0],
                                                   deint[:, :, 0])
            overflow = overflow + over0
            success, data = succ0[:, :, None], data0[:, :, None]
            if J > 1:
                R = C * (J - 1)
                marks.mark("fano2", gate)
                gate_rest = (gate[:, :, 1:]
                             & ~succ0[:, :, None]).reshape(W, R)
                succr, datar, over2 = self._fano_phase(
                    gate_rest, deint[:, :, 1:].reshape(W, R, 162))
                overflow = overflow + over2
                success = torch.cat([success, succr.reshape(W, C, J - 1)],
                                    dim=2)
                data = torch.cat([data, datar.reshape(W, C, J - 1, _NBYTES)],
                                 dim=2)
        any_success = success.any(dim=2)
        jbest = torch.argmax(success.to(torch.int8), dim=2)     # first True
        payload = data[widx, cidx, jbest][..., :7]
        osd = torch.zeros((W, C), dtype=torch.int64, device=dev)
        if self._osd_G is not None:
            marks.mark("osd", gate)
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

    def mp_tally(self) -> dict:
        """``mp_counts`` on the host, by ``mp_names``: the decodes that ran
        the passes (each captured replay and eager run), and over them the
        frames subtracted, the new frames over subtract_max_lanes, the
        duplicates dropped, and for each pass the windows it decoded and
        its new spots. Waits for the card (one read); the serving path
        never calls it."""
        return dict(zip(self.mp_names, self.mp_counts.tolist()))

    # -- multipass (pipeline/multipass.py::multipass_spots) -----------------

    def _decode_passes(self, ri: torch.Tensor) -> torch.Tensor:
        """The batch program at multipass.passes P > 1 (see the module
        doc): (W, 2, fl) -> packed (W, P*C, 23)."""
        mp = self.config.multipass
        W = ri.shape[0]
        dev = ri.device
        res = ri.clone()                       # the residual, in place
        windows = None                         # pass 1 decodes every one
        outs, tally = [], []
        attempts = torch.zeros(W, dtype=torch.int64, device=dev)
        overflow = torch.zeros(W, dtype=torch.int64, device=dev)
        dups = torch.zeros((), dtype=torch.int64, device=dev)
        sub = torch.zeros((), dtype=torch.int64, device=dev)
        over = torch.zeros((), dtype=torch.int64, device=dev)
        for p in range(mp.passes):
            out = self._fano_select_batch(self.prefano(res, windows))
            if outs:
                dup = out["success"] & self._duplicates(out, outs)
                out["success"] = out["success"] & ~dup
                dups = dups + dup.sum()
            tally += [torch.full((), W, dtype=torch.int64, device=dev)
                      if windows is None else windows.sum(),
                      out["success"].sum()]
            attempts = attempts + out["fano_attempts"]
            overflow = overflow + out["fano_overflow"]
            if p < mp.passes - 1:
                marks.mark("subtract", res)
                windows, n_sub, capped = self._subtract(res, out)
                overflow = overflow + capped
                sub = sub + n_sub
                over = over + capped.sum()
            outs.append(out)
        self.mp_counts += torch.stack([
            torch.ones((), dtype=torch.int64, device=dev), sub, over, dups,
            *tally])
        marks.mark("pack", ri)
        for out in outs:
            out["fano_attempts"], out["fano_overflow"] = attempts, overflow
        return torch.cat([self._pack(out) for out in outs], dim=1)

    def _duplicates(self, out: dict, earlier: list) -> torch.Tensor:
        """(W, C) bool: the slots of ``out`` whose payload an earlier pass
        reported in the same window with a frequency within DUP_FREQ_HZ
        (multipass._is_duplicate, the gap taken in float64)."""
        succ = torch.cat([e["success"] for e in earlier], dim=1)  # (W, K)
        pay = torch.cat([e["payload"] for e in earlier], dim=1)
        freq = torch.cat([e["freq"] for e in earlier], dim=1).double()
        same = (out["payload"][:, :, None, :] == pay[:, None, :, :]).all(-1)
        near = (out["freq"].double()[:, :, None] - freq[:, None, :]).abs() \
            < DUP_FREQ_HZ
        return (same & near & succ[:, None, :]).any(dim=2)

    def _subtract(self, res: torch.Tensor, out: dict):
        """Subtract the pass's decodes (``out["success"]``) from the
        residual ``res`` in place: the batch's decodes window-major, the
        first subtract_max_lanes of them (all W*C lanes at 0), in one
        ``subtract_lanes`` call. -> (windows where something was
        subtracted (W,) bool, frames subtracted (), frames over the cap
        (W,))."""
        mp = self.config.multipass
        W, C = out["success"].shape
        L = W * C
        dev = res.device
        new = out["success"].reshape(L)
        ML = min(mp.subtract_max_lanes or L, L)
        sel = torch.argsort((~new).to(torch.int8), stable=True)[:ML]
        act = new[sel]
        widx = torch.div(sel, C, rounding_mode="floor")
        jig = out["jiggle"].reshape(L)[sel]
        lag = out["shift"].reshape(L)[sel] + self.state["jiggles"][jig]

        def lanes(k):
            v = out[k]
            return v.reshape((L,) + v.shape[2:])[sel]
        subtract_lanes(res, widx, act, lanes("payload"), lanes("freq"), lag,
                       lanes("mode"), lanes("drift"), lanes("slm_params"),
                       cf=float(self.config.coarse.cf), nfilt=NFILT,
                       freq_iters=FREQ_ITERS, lag_search=LAG_SEARCH)
        done = torch.zeros(W, dtype=torch.int64, device=dev).index_add_(
            0, widx, act.to(torch.int64))
        capped = new.index_fill(0, sel, False).reshape(W, C).sum(dim=1)
        return done > 0, act.sum(), capped

    def _osd_rescue(self, pre: dict, any_success: torch.Tensor,
                    payload: torch.Tensor, jbest: torch.Tensor):
        """On-device OSD (jit_decoder.py:1046-1118): worth candidates whose
        gated Fano lanes all failed get an order-min(osd_depth, 4) decode of
        their two most-synced gated jiggle lanes. The failed lanes of the
        batch are compacted to osd_max_lanes, failing lanes first in lane
        order; failed lanes beyond the cap come back in ``dropped``.
        Acceptance (the r5 rule): quality >= osd_min_quality and (margin >=
        osd_min_margin, or the two lanes' payloads agree and margin >=
        osd_margin_agree), masked by the failed lanes: the others among the
        compacted ones are decoded as inactive and could not be accepted.

        The JAX program's fixed shape: every batch takes ML = min(
        osd_max_lanes, L) lanes, failing lanes first, and decodes both
        jiggle lanes of each in one ``osd_decode_lanes`` call with
        ``active`` the failed mask, so no count is read on the host and a
        batch with no failed lane launches the kernel over inactive lanes,
        which start done.

        Adds to ``osd_counts`` on the device, with no host read: one
        decode, the active lanes, those accepted by margin, those accepted
        by agreement alone, and the dropped lanes.

        Fields (W, C[, J]) -> (any_success, payload, jbest, osd, dropped),
        each (W, C[, 7])."""
        dcfg = self.config.demod
        gate, worth, sync2 = pre["gate"], pre["worth"], pre["sync2"]
        W, C, J = gate.shape
        L = W * C
        dev = gate.device
        gate_f = gate.reshape(L, J)
        fail = worth.reshape(L) & gate_f.any(dim=1) & ~any_success.reshape(L)
        skey = torch.where(gate_f, sync2.reshape(L, J), -torch.inf)
        jsel = torch.argmax(skey, dim=1)
        first = torch.arange(J, device=dev)[None, :] == jsel[:, None]
        jsel2 = torch.argmax(torch.where(first, -torch.inf, skey),
                             dim=1)                # 2nd-best gated lane
        has2 = gate_f.sum(dim=1) >= 2
        ML = min(dcfg.osd_max_lanes, L)
        order = min(dcfg.osd_depth, 4)
        sel = torch.argsort((~fail).to(torch.int8), stable=True)[:ML]
        fs = fail[sel]
        deint = pre["deint"].reshape(L, J, 162)
        lanes = torch.cat([deint[sel, jsel[sel]], deint[sel, jsel2[sel]]])
        u, q, m, _ = osd_decode_lanes(lanes, self._osd_G, order,
                                      torch.cat([fs, fs]))
        agree = (u[:ML] == u[ML:]).all(dim=1) & has2[sel]
        q, m = q[:ML], m[:ML]
        good = fs & (q >= dcfg.osd_min_quality)
        by_margin = good & (m >= dcfg.osd_min_margin)
        ok = by_margin | (good & agree & (m >= dcfg.osd_margin_agree))
        pay = payload.reshape(L, payload.shape[-1])
        pl = bits_to_payload(u[:ML])[:, :pay.shape[-1]]
        pay = pay.index_copy(0, sel, torch.where(ok[:, None], pl, pay[sel]))
        jb = jbest.reshape(L)
        jb = jb.index_copy(0, sel, torch.where(ok, jsel[sel], jb[sel]))
        succ = any_success.reshape(L)
        succ = succ.index_copy(0, sel, succ[sel] | ok)
        osd = torch.zeros(L, dtype=torch.int64, device=dev).index_copy(
            0, sel, ok.to(torch.int64) * order)
        dropped = fail.index_fill(0, sel, False)
        self.osd_counts += torch.stack([
            torch.ones((), dtype=torch.int64, device=dev), fs.sum(),
            by_margin.sum(), (ok & ~by_margin).sum(), dropped.sum()])
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
        ovf = pre["refine_overflow"].to(f32)[:, None, None].expand(W, C, 1)
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
    def unpack_output(a, n_cand: int | None = None) -> DeviceDecoderOutput:
        """Packed (..., S, 23) float32 (tensor or array) -> typed output.
        ``n_cand`` C, given for a multipass output, sets ``pass_index`` to
        each slot's pass, slot // C."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        pass_index = None
        if n_cand is not None:
            pass_index = np.broadcast_to(
                np.arange(a.shape[-2]) // n_cand, a.shape[:-1]).copy()
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
            pass_index=pass_index,
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
        (jit_decoder.py:1244-1275). A multipass output's spots carry their
        pass (``pass_index``) and their candidate within it."""
        with span("decoder.spots"):
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
            if out.pass_index is not None and spots:
                # slot p * C + c: pass p's candidate c
                C = out.success.shape[-1] // (int(out.pass_index[-1]) + 1)
                for s in spots:
                    s.pass_index = int(out.pass_index[s.candidate])
                    s.candidate %= C
            return spots


def _offsets_f32(step: float, device) -> torch.Tensor:
    """(-2..2) * step in float32, as jnp.arange(-2, 3) * step."""
    return torch.arange(-2, 3, dtype=torch.float32, device=device) \
        * np.float32(step)


__all__ = ["DeviceDecoder", "DeviceDecoderOutput", "FANO_MODES",
           "MP_PASS_TALLY", "MP_TALLY", "check_slice", "mp_tally_names"]
