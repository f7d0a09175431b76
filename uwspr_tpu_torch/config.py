"""Typed configuration for the whole decode pipeline.

Every tuning constant of the reference — including the ones hard-coded deep
inside ``demodulate()`` (lib/sync_and_demodulate_impl.cc:328-335) and the
Fano bias (lib/Fano.cc:40) — lifted into one dataclass with the reference's
exact defaults, per SURVEY.md §5 ("Config/flag system").

The port's own copy of uwspr_tpu/config.py (imports pointed inside
uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class CoarseConfig:
    """FDR (coarse search) parameters — grc/uwspr_FDR.xml defaults, with
    halfbandwidth=10 as used by the example flowgraphs."""

    fs: int = 375                 # baseband sample rate
    fl: int = 45000               # window length, samples (120 s)
    spb: int = 256                # samples per symbol
    maxdrift: int = 0             # linear drift search half-range (symbols)
    maxfreqs: int = 200           # max candidates kept per window
    halfbandwidth: int = 10       # Hz, half passband searched
    cf: int = 1500                # carrier frequency (Hz) for SLM Doppler
    threshold: float = 10.0       # nonlinear/linear sync ratio gate
    search_nonlinear: bool = True  # include the 125 SLM trajectories
    stft_impl: str = "auto"       # device-engine STFT: "auto" (the
                                  # sentinel default: behaves as "fft"
                                  # unless with_serving_defaults
                                  # upgrades it to the measured serving
                                  # choice "matmul_bf16" — an EXPLICIT
                                  # "fft" is never upgraded), "fft"
                                  # (XLA FFT, f32-exact vs the oracle),
                                  # "matmul_bf16" (DFT as bf16 MXU
                                  # matmuls, ops/stft.py — the serving
                                  # default), or "pallas" (fused
                                  # frames-in-VMEM kernel,
                                  # ops/stft_pallas.py — same bf16
                                  # numerics; experimental). Host
                                  # CoarseSearch always uses "fft".
    grid_dtype: str = "auto"      # device-engine coarse sync-grid
                                  # operands: "auto" (f32 for the
                                  # narrowband conv — bf16 measured
                                  # neutral there in r4; bf16 for the
                                  # wideband einsum, where it halves
                                  # the dominant im2col bytes), "f32",
                                  # or "bf16" (f32 accumulation either
                                  # way; one-hot kernels exact in
                                  # bf16; deep-SNR decode rates
                                  # identical, SWEEP artifacts). An
                                  # explicit value is always honored.
                                  # Host CoarseSearch stays f32.
    select_impl: str = "auto"     # device-engine model selection:
                                  # "xla" (_select_best_grouped — the
                                  # event-skip while_loop), "pallas"
                                  # (ops/select_pallas.py — the whole
                                  # sequential walk inside one Mosaic
                                  # program, VMEM-resident; r5), or
                                  # "auto" (pallas on TPU when the
                                  # model bank is linear-first AND the
                                  # per-window grid fits scoped VMEM —
                                  # narrowband C<=~60 lanes; wideband
                                  # C=200 stays xla). Bit-identical
                                  # (oracle-tested); host CoarseSearch
                                  # always uses the XLA path.
    grid_impl: str = "auto"       # device-engine sync-grid contraction:
                                  # "conv" (conv_general_dilated over
                                  # the A/B planes), "einsum" (im2col
                                  # MXU GEMM), or "auto" — conv for
                                  # narrowband, einsum for wideband
                                  # (hpbm > 32), where the dilated
                                  # one-hot conv lowers to <10% MXU on
                                  # v5e while the GEMM runs the same
                                  # FLOPs near MXU speed (r5 measured).
                                  # Host CoarseSearch always uses the
                                  # f32 einsum oracle path.

    @property
    def fft_size(self) -> int:          # "size" = 2*spb
        return 2 * self.spb

    @property
    def n_ffts(self) -> int:            # "n" = floor(fl/spb*2) - 3
        return int(self.fl / self.spb * 2) - 3

    @property
    def df(self) -> float:              # bin width
        return self.fs / self.fft_size

    @property
    def hpbm(self) -> int:              # passband half-width in bins
        import math
        return math.ceil(self.halfbandwidth / self.df)


@dataclass(frozen=True)
class DemodConfig:
    """Fine sync / soft-symbol parameters (sync_and_demodulate defaults)."""

    # Fano cycle budget per bit. 10000 is the reference default; lanes near
    # the decode threshold can burn the whole 810k-cycle budget, and in the
    # lockstep device decoder the slowest lane gates the batch. Measured
    # decode-rate cost of maxcycles=2000: none at -27/-28 dB, -4% at
    # -29 dB — recommended for latency-sensitive serving.
    maxcycles: int = 10000
    minsync1: float = 0.10        # gate after coarse lag/freq refinement
    minsync2: float = 0.12        # gate before each Fano attempt
    iifac: int = 8                # jiggle step in samples
    symfac: int = 50              # soft-symbol scaling
    fano_delta: int = 60          # Fano threshold step
    fano_bias: float = 0.45       # metric bias
    n_jiggles: int = 17           # idt = 0..128/iifac inclusive
    fano_max_lanes: int = 1024    # device decoder: gated lanes compacted to
                                  # this many before the lockstep Fano (the
                                  # full 200x17 grid rarely passes gates;
                                  # overflow lanes report failure)
    fano_compact_lanes: int = 0   # batched device decoder: compact gated
                                  # Fano lanes ACROSS the window batch
                                  # into chunks of this many lanes per
                                  # phase (0 = per-window fano_max_lanes
                                  # compaction only). The lockstep
                                  # decoder pays the branch-metric
                                  # matmul and while-loop state for
                                  # every STATIC lane; at the serving
                                  # point ~1 of W*C jiggle-0 lanes and
                                  # ~0 of W*C*(J-1) retry lanes are
                                  # gated, so a cross-window gather
                                  # (like refine_max_lanes) shrinks the
                                  # batch ~100x with identical results.
                                  # r5: gated lanes beyond the cap are
                                  # NO LONGER dropped — a bounded
                                  # while_loop decodes further chunks
                                  # until every gated lane ran
                                  # (jit_decoder._compact_fano), so
                                  # this cap is a throughput knob, not
                                  # a deep-SNR correctness cliff.
                                  # NOTE: when > 0, the per-window
                                  # fano_max_lanes cap is NOT applied
                                  # in the batched decoder.
    cand_compact_lanes: int = 0   # batched device decoder: compact VALID
                                  # candidate lanes across the window batch
                                  # to this many total lanes before the
                                  # phase-A/B refine (0 = off). The refine
                                  # passes are ~linear in static lanes
                                  # (~23 us/lane on v5e), and the wideband
                                  # default carries maxfreqs=200 slots per
                                  # window of which only the accepted few
                                  # are real — this prices refine by the
                                  # ACCEPTED count instead. Valid lanes
                                  # beyond the cap are dropped weakest-
                                  # coarse-SNR-first, observably via
                                  # refine_overflow. Composes with
                                  # refine_max_lanes (post-worth tail
                                  # sub-compaction) and fano_compact_lanes.
    osd_depth: int = 0            # ordered-statistics decoding fallback for
                                  # candidates whose gated lanes all failed
                                  # Fano (fec/osd.py): 0 = off (reference
                                  # behavior), 2..6 = flip-search order.
                                  # Recommended host/hybrid depth: 5
                                  # (r5 calibrated, ~2.5 s/failed lane:
                                  # -29: 92->100%, -30: 44->68%, -31:
                                  # 4->16%, ZERO false valids at every
                                  # SNR under the r5 margin floors —
                                  # SWEEP_OSD_r05.json, OSD_CALIB_o5).
                                  # Acceptance is gated by cross-jiggle
                                  # payload agreement OR the list-decoding
                                  # margin (osd_min_margin), calibrated so
                                  # wrong-message emission is rare;
                                  # spots stay tagged (Spot.osd).
    osd_max_lanes: int = 32       # device/mesh engines: Fano-failed worth
                                  # lanes compacted to this many on-device
                                  # order-<=4 OSD lanes per batch
                                  # (fec/osd_jax.py); 0 disables device OSD
                                  # even when osd_depth > 0. Overflow lanes
                                  # degrade gracefully (no rescue) and
                                  # count into fano_overflow. Host/hybrid
                                  # engines have no lane cap (and honor
                                  # osd_depth > 2).
    osd_min_quality: float = 0.6  # OSD coarse screen: the reliability
                                  # correlation of the winning codeword.
                                  # Calibrated in tests/test_osd.py: noise
                                  # lanes score ~0.65-0.72, marginal true
                                  # rescues ~0.69+, confident ones >0.9 —
                                  # so 0.6 only rejects degenerate lanes;
                                  # the discriminating screens are
                                  # osd_min_margin / cross-jiggle
                                  # agreement below, plus protocol
                                  # unpacking at host egress.
    osd_min_margin: float = 0.02  # OSD list-decoding margin screen:
                                  # accept an OSD codeword only if its
                                  # margin — (2nd-best - best) candidate
                                  # score / total reliability — is >=
                                  # this, OR two independently
                                  # demodulated jiggle lanes decode to
                                  # the same payload (cross-jiggle
                                  # agreement) AND margin >=
                                  # osd_margin_agree. Calibrated on
                                  # -29..-32 dB failed lanes (scripts/
                                  # osd_calibrate.py, OSD_CALIB*.json):
                                  # order-3 wrong decodes never agreed
                                  # (0/31) and had margin <= 0.0175.
                                  # Applies to all engines.
    osd_margin_agree: float = 0.011  # margin floor on the agreement
                                  # path: the flip search can fit the
                                  # SAME wrong codeword to two
                                  # correlated noisy lanes, but only
                                  # where the candidate landscape is
                                  # flat. Across OSD_CALIB*.json
                                  # (orders 3-4, -29..-32 dB) the 5
                                  # wrong cross-jiggle agreements had
                                  # margins 0.0013-0.0105, so the
                                  # floor sits ABOVE the worst
                                  # measured wrong agreement (the r4
                                  # value 0.008 did not — a wrong
                                  # agreement at 0.0105 would have
                                  # passed). 0.011 keeps 13 of the 19
                                  # agreement-path correct rescues
                                  # (vs 14 at 0.008): one measured
                                  # rescue traded for dominating the
                                  # whole wrong-agreement sample.
    refine_max_lanes: int = 0     # batched device decoder: compact the
                                  # post-worth refine stages (joint fine
                                  # grid + soft symbols) to this many worth
                                  # lanes across the window batch; 0 = run
                                  # all W*C lanes. The reference gates these
                                  # stages on sync1 > minsync1 per candidate
                                  # (impl.cc:443); dropped overflow lanes
                                  # surface in fano_overflow.
    fano_impl: str = "auto"       # on-device Fano implementation:
                                  # "pallas" — the VMEM-resident Mosaic
                                  # kernel (fec/fano_pallas.py): the whole
                                  # sequential search runs inside one
                                  # kernel at ~0.3 us/step per 128-lane
                                  # block, so even a full-budget deep-SNR
                                  # timeout batch is bounded at well under
                                  # a second (measured 0.42 s for 128
                                  # all-timeout lanes at maxcycles=10000
                                  # on v5e). "while" — the XLA
                                  # lax.while_loop formulation (portable;
                                  # ~ms per unrolled iteration of HBM
                                  # round trips, so full-budget lanes
                                  # degrade to minutes — only safe with
                                  # small maxcycles). "auto" = pallas on
                                  # TPU, while elsewhere. Bit-exact either
                                  # way (tests/test_fano_pallas.py).
    probe_dtype: str = "f32"      # device-decoder probe einsums: "f32", or
                                  # "bf16" (4 real bf16 matmuls, f32
                                  # accumulation — the MXU-native
                                  # precision; ~0.4% relative correlation
                                  # error). At the compacted W=128
                                  # operating point bf16 measured 33.8M ->
                                  # 37.0M samples/s on v5e and is the
                                  # bench/serving default (bench.py); f32
                                  # remains the config default for
                                  # bit-parity with the host oracles.

    @property
    def minrms(self) -> float:    # plausibility gate: 52 * symfac/64
        return 52.0 * (self.symfac / 64.0)


@dataclass(frozen=True)
class StreamConfig:
    """Sliding-window stream parameters (sliding_window_stream_to_pdu)."""

    fs: int = 375
    fl: int = 45000               # window, samples
    shift: int = 9                # hop, seconds
    capacity_windows: int = 2     # ring capacity C, in windows


@dataclass(frozen=True)
class FrontendConfig:
    """12 kS/s audio -> 375 S/s baseband downconversion chain."""

    audio_rate: int = 12000
    center_freq: float = 1500.0
    half_bandwidth: float = 10.0  # band-pass half-width around center
    transition_width: float = 10.0
    decimation: int = 32


@dataclass(frozen=True)
class PipelineConfig:
    coarse: CoarseConfig = dataclasses.field(default_factory=CoarseConfig)
    demod: DemodConfig = dataclasses.field(default_factory=DemodConfig)
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    fano_backend: str = "native"   # "native" (C++ host) | "jax" (batched TPU)


DEFAULT_CONFIG = PipelineConfig()


def with_serving_defaults(config: PipelineConfig,
                          batch_windows: int) -> PipelineConfig:
    """The measured TPU serving point, applied to tuning fields the user
    left at their dataclass defaults (explicitly-set values are kept).

    The serving engines (StreamDecoder, BatchedStreamDecoder, the CLI)
    call this so a default-config `uwspr serve` runs the same
    configuration bench.py measures: bf16 probe einsums + bf16 window
    construction (spot parity with f32 verified; deep-SNR rates
    unchanged, SWEEP_OSD_DEVICE_r03), and cross-window refine/Fano lane
    compaction sized 2x the batch width — >=2x headroom over the
    ~one-worth-lane-per-window steady state. The Fano cap is chunked,
    never-drop (r5, jit_decoder._compact_fano): deep-SNR retry
    populations beyond it decode in further while_loop chunks instead
    of being shed, so untouched defaults keep hybrid-parity decode
    rates at every SNR; residual refine/cand-compaction drops stay
    observable via fano_overflow.

    Wideband configs (static candidate-lane count > 32) get their own
    compaction sizing (r5): 16x the batch width bounded at 512 lanes —
    the TPU-validated wideband shape with >=60% headroom over the
    measured 10-signal dense scene (BENCH_MATRIX row_wideband). Worth
    lanes beyond the refine/cand caps shed weakest-coarse-SNR-first,
    observably via the overflow counters; the Fano cap never drops.

    The narrowband candidate cap is 2x the batch width — the TPU-proven
    bench operating point (BENCH_r03/r04: 128/128 decoded at W=128,
    cap 256). The coarse acceptance passes ~1 valid lane/window at the
    serving scene and ~2.1/window on a dense 3-signal narrowband scene
    (the +/-5 Hz passband physically fits only a few frames), so 2x
    covers the steady state with headroom; the densest scenes shed
    their weakest-coarse-SNR lanes observably via fano_overflow.
    (4x the batch width was tried as the dense-scene default in r3 and
    REVERTED: at W=128 the 512-lane narrowband probe programs crash the
    v5e worker — repeatable kernel fault/OOM during the phase-A probe
    build, /tmp ladder logs r4 — so the default stays at the validated
    shape; dense deployments can raise cand_compact_lanes explicitly
    after validating their batch width.)
    """
    d, c = config.demod, config.coarse
    upd = {}
    upd_coarse = {}
    if d.probe_dtype == "f32":
        upd["probe_dtype"] = "bf16"
    if c.stft_impl == "auto":
        # DFT-as-bf16-matmul STFT: -14.3% serving compute (fetch-last
        # interleaved A/B on v5e, 0.174 vs 0.203 ms/win), deep-SNR
        # decode rates identical point-for-point; only the device
        # engines read this (host CoarseSearch stays FFT/oracle-exact).
        # Only the "auto" sentinel upgrades — a user who explicitly set
        # "fft" asked for the f32-exact FFT and keeps it.
        upd_coarse["stft_impl"] = "matmul_bf16"
    n_static = min(c.maxfreqs, (2 * c.hpbm - 1) // 2)  # coarse.max_peaks
    if batch_windows > 1 and n_static <= 32:
        if d.refine_max_lanes == 0:
            upd["refine_max_lanes"] = 2 * batch_windows
        if d.fano_compact_lanes == 0:
            upd["fano_compact_lanes"] = 2 * batch_windows
        if d.cand_compact_lanes == 0:
            upd["cand_compact_lanes"] = 2 * batch_windows
    elif batch_windows > 1:
        # Wideband serving defaults (r5): the full-passband config
        # carries maxfreqs=200 static candidate slots per window
        # (grc/uwspr_FDR.xml:31-36) of which only the accepted few are
        # real, and refine is ~linear in static lanes — compaction is
        # what makes wideband serve at all. Sized 16x the batch width
        # (bounded 512, the TPU-validated wideband lane shape,
        # BENCH_MATRIX row_wideband): >=60% headroom over the measured
        # 10-signal scene's ~10 worth lanes/window. The Fano cap is
        # never-drop (chunked); refine/cand caps shed weakest-coarse-SNR
        # lanes first, observably via fano_overflow/refine_overflow.
        cap = min(16 * batch_windows, 512)
        if d.refine_max_lanes == 0:
            upd["refine_max_lanes"] = cap
        if d.fano_compact_lanes == 0:
            upd["fano_compact_lanes"] = cap
        if d.cand_compact_lanes == 0:
            upd["cand_compact_lanes"] = cap
    if not upd and not upd_coarse:
        return config
    return dataclasses.replace(
        config,
        coarse=dataclasses.replace(c, **upd_coarse) if upd_coarse else c,
        demod=dataclasses.replace(d, **upd) if upd else d)


__all__ = [
    "CoarseConfig", "DemodConfig", "StreamConfig", "FrontendConfig",
    "PipelineConfig", "DEFAULT_CONFIG", "with_serving_defaults",
]
