"""GRC flowgraph importer: run the reference's .grc files directly.

The reference's user-facing surface is a set of GNU Radio Companion
flowgraphs (examples/*.grc — AudioSourceDecode.grc is the flagship live
receiver, grc/uwspr_*.xml define the block parameter schemas). This module
parses a GRC 3.7 flowgraph, lifts the uwspr block parameters into a
:class:`~uwspr_tpu_torch.config.PipelineConfig`, identifies the signal
source and sink chains, and maps the whole graph onto this framework's
equivalents:

  ===========================================  ==============================
  GRC chain                                    uwspr_tpu equivalent
  ===========================================  ==============================
  audio/wav source -> band-pass -> xlating     frontend.downconvert (fused
  filter -> rational_resampler (decim 32)      mix + polyphase decimator)
  uwspr_sliding_window_stream_to_pdu ->        pipeline.stream.StreamDecoder
  uwspr_FDR -> uwspr_sync_and_demodulate ->    (coarse + finesync + Fano +
  uwspr_WSPR_unpacker -> message_debug         unpack, spots printed)
  C2_File_Source -> interp x32 -> xlating      frontend.upconvert ->
  +1500 Hz -> wavfile/audio sink               io.wavfile (sender path)
  ===========================================  ==============================

GUI sinks (qtgui_*), throttles and debug scopes have no decode-path effect
and are ignored. Parameter expressions (e.g. ``Frame_Length``,
``Center_Frequency+Half_Bandwidth``) are evaluated with a restricted
arithmetic evaluator over the flowgraph's ``variable`` blocks — never with
Python ``eval`` (flowgraph files are untrusted input).

Coverage boundary (deliberate design stance, SURVEY.md §7.0 "do not
rebuild GNU Radio"): this importer maps the RECEIVER and SENDER chain
shapes above — the topologies the reference ships — not arbitrary GR
graphs. A flowgraph containing neither a uwspr decode chain nor a
C2-source replay chain raises ``ValueError`` with the block inventory
(:func:`classify`); it is never silently partially executed. Custom GR
blocks outside the mapped chains are not emulated — compose this
framework's Python API instead.

Reference files: examples/AudioSourceDecode.grc,
examples/WaveFilePlusNoiseDecode.grc, examples/c2ToWaveFile.grc,
examples/c2ToAudioSink.grc; parameter schemas grc/uwspr_*.xml.

The port's own copy of uwspr_tpu/grc.py, on the port's config classes,
held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import ast
import operator
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from uwspr_tpu_torch.config import (
    CoarseConfig,
    FrontendConfig,
    PipelineConfig,
    StreamConfig,
)

# GRC housekeeping params that never affect the signal path.
_META_PARAMS = frozenset({
    "alias", "affinity", "minoutbuf", "maxoutbuf", "_coordinate",
    "_rotation", "comment", "_enabled",
})

# Blocks with no effect on decode semantics (GUI scopes, throttling,
# monitoring taps). Connections through them are still traversed.
_PASSIVE_KEYS = frozenset({
    "blocks_throttle", "blocks_multiply_const_vxx", "blocks_add_xx",
    "blocks_float_to_complex", "blocks_complex_to_float",
})
_IGNORED_KEYS = frozenset({
    "options", "variable", "variable_band_pass_filter_taps",
    "variable_low_pass_filter_taps", "blocks_message_debug",
    "blocks_rms_xx", "blocks_nlog10_ff", "qtgui_freq_sink_x",
    "qtgui_number_sink", "qtgui_waterfall_sink_x", "qtgui_time_sink_x",
})


@dataclass
class Block:
    key: str                       # GRC block type, e.g. "uwspr_FDR"
    id: str                        # instance id
    params: dict                   # resolved param values


@dataclass
class Flowgraph:
    path: str
    variables: dict                # name -> numeric value
    blocks: dict = field(default_factory=dict)       # id -> Block
    connections: list = field(default_factory=list)  # (src_id, dst_id)

    def by_key(self, key: str) -> list[Block]:
        return [b for b in self.blocks.values() if b.key == key]

    def one(self, key: str) -> Block | None:
        bs = self.by_key(key)
        return bs[0] if bs else None

    def upstream(self, block_id: str) -> list[Block]:
        return [self.blocks[s] for s, d in self.connections
                if d == block_id and s in self.blocks]

    def downstream(self, block_id: str) -> list[Block]:
        return [self.blocks[d] for s, d in self.connections
                if s == block_id and d in self.blocks]


# -- restricted arithmetic evaluation ---------------------------------------

_BIN_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub,
    ast.Mult: operator.mul, ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv, ast.Mod: operator.mod,
    ast.Pow: operator.pow,
}


def _eval_expr(expr: str, names: dict):
    """Evaluate an arithmetic expression over ``names``; raise on anything
    else (function calls, attributes, subscripts...)."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)):
                return node.value
            raise ValueError(f"non-numeric constant {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id in names:
                return names[node.id]
            raise ValueError(f"unknown name {node.id!r}")
        if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
            return _BIN_OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
            return +ev(node.operand)
        raise ValueError(f"unsupported expression node {node!r}")

    return ev(ast.parse(expr, mode="eval"))


def _resolve(value, names: dict):
    """Param string -> number if it parses as restricted arithmetic,
    True/False for GRC booleans, else the raw string."""
    if value is None:
        return None
    v = value.strip()
    if v in ("True", "False"):
        return v == "True"
    try:
        return _eval_expr(v, names)
    except (ValueError, SyntaxError):
        return value


# -- parsing -----------------------------------------------------------------

def parse_grc(path: str | os.PathLike) -> Flowgraph:
    """Parse a GRC 3.7 XML flowgraph, resolving variable references."""
    root = ET.parse(path).getroot()
    raw = []
    for b in root.iter("block"):
        key = b.find("key").text
        params = {}
        enabled = True
        for p in b.findall("param"):
            k = p.find("key").text
            if k == "_enabled":
                # GRC omits disabled blocks from the generated flowgraph;
                # a disabled alternative source must not be classified
                enabled = (p.find("value").text or "True") not in (
                    "0", "False", "false")
            if k not in _META_PARAMS:
                params[k] = p.find("value").text
        if enabled:
            raw.append((key, params))

    # variable blocks may reference each other; iterate to fixpoint
    names: dict = {}
    pending = {p["id"]: p.get("value", "") for k, p in raw
               if k == "variable"}
    for _ in range(len(pending) + 1):
        progressed = False
        for name, expr in list(pending.items()):
            try:
                names[name] = _eval_expr(expr or "", names)
                del pending[name]
                progressed = True
            except (ValueError, SyntaxError):
                continue
        if not progressed:
            break

    fg = Flowgraph(path=str(path), variables=dict(names))
    for key, params in raw:
        if key == "variable":
            continue
        bid = params.get("id", key)
        fg.blocks[bid] = Block(
            key=key, id=bid,
            params={k: _resolve(v, names) for k, v in params.items()
                    if k != "id"})
    for c in root.iter("connection"):
        fg.connections.append((c.find("source_block_id").text,
                               c.find("sink_block_id").text))
    return fg


# -- mapping to PipelineConfig ------------------------------------------------

def pipeline_config(fg: Flowgraph) -> PipelineConfig:
    """uwspr block parameters -> PipelineConfig (reference schema:
    grc/uwspr_FDR.xml:8-56, grc/uwspr_sliding_window_stream_to_pdu.xml:16-35,
    grc/uwspr_sync_and_demodulate.xml:21-52)."""
    base = PipelineConfig()
    coarse, stream, frontend = base.coarse, base.stream, base.frontend

    fdr = fg.one("uwspr_FDR")
    if fdr:
        p = fdr.params
        coarse = CoarseConfig(
            fs=int(p.get("fs", coarse.fs)),
            fl=int(p.get("fl", coarse.fl)),
            spb=int(p.get("spb", coarse.spb)),
            maxdrift=int(p.get("maxdrift", coarse.maxdrift)),
            maxfreqs=int(p.get("maxfreqs", coarse.maxfreqs)),
            halfbandwidth=int(p.get("halfbandwidth", coarse.halfbandwidth)),
            cf=int(p.get("cf", coarse.cf)),
            threshold=float(p.get("threshold", coarse.threshold)),
        )
    sw = fg.one("uwspr_sliding_window_stream_to_pdu")
    if sw:
        p = sw.params
        stream = StreamConfig(
            fs=int(p.get("fs", stream.fs)),
            fl=int(p.get("fl", stream.fl)),
            shift=int(p.get("shift", stream.shift)),
            capacity_windows=int(p.get("C", stream.capacity_windows)),
        )
    # front-end band: the band-pass taps variable carries the audio-rate
    # filter spec (AudioSourceDecode.grc variable_band_pass_filter_taps)
    cfv = fg.variables.get("Center_Frequency")
    hbv = fg.variables.get("Half_Bandwidth")
    audio_rate = fg.variables.get("samp_rate", frontend.audio_rate)
    rr = fg.one("rational_resampler_xxx")
    decim = int(rr.params.get("decim", 32)) if rr else frontend.decimation
    frontend = FrontendConfig(
        audio_rate=int(audio_rate),
        center_freq=float(cfv if cfv is not None else frontend.center_freq),
        half_bandwidth=float(hbv if hbv is not None
                             else frontend.half_bandwidth),
        transition_width=frontend.transition_width,
        decimation=decim,
    )
    return PipelineConfig(coarse=coarse, demod=base.demod, stream=stream,
                          frontend=frontend, fano_backend=base.fano_backend)


# -- source / sink identification ---------------------------------------------

@dataclass
class SourceSpec:
    kind: str            # "audio" | "wav" | "wav_mix" | "c2"
    files: list          # resolved file paths (empty for live audio)
    gains: list          # per-file amplitude scale
    repeat: bool = False
    drift_rate: float = 0.0


@dataclass
class SinkSpec:
    kind: str            # "wav" | "audio"
    file: str | None = None
    rate: int = 12000


def _find_file(path: str, files_dir: str | None) -> str:
    """GRC files carry the author's absolute paths; fall back to basename
    lookup in files_dir (default: alongside the flowgraph)."""
    if os.path.exists(path):
        return path
    if files_dir:
        cand = os.path.join(files_dir, os.path.basename(path))
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"flowgraph references {path!r}; not found (try --files-dir)")


def _gain_through_passives(fg: Flowgraph, src: Block) -> float:
    """Accumulate multiply_const gains along the passive chain downstream
    of a source (stops at the first non-passive block — the filter/decode
    chain is common to all sources, so per-source gain is what matters)."""
    gain, cur, seen = 1.0, src.id, set()
    while cur not in seen:
        seen.add(cur)
        nxt = [d for d in fg.downstream(cur) if d.key in _PASSIVE_KEYS]
        if not nxt:
            break
        b = nxt[0]
        if b.key == "blocks_multiply_const_vxx":
            try:
                gain *= float(b.params.get("const", 1.0))
            except (TypeError, ValueError):
                pass
        cur = b.id
    return gain


def classify(fg: Flowgraph, files_dir: str | None = None
             ) -> tuple[str, SourceSpec | None, SinkSpec | None]:
    """-> (flowgraph kind, source, sink). kind: "receiver" when the uwspr
    decode chain is present, "sender" for C2 -> audio/wav replay."""
    if fg.one("uwspr_sliding_window_stream_to_pdu") or fg.one("uwspr_FDR"):
        wavs = fg.by_key("blocks_wavfile_source")
        if wavs:
            files, gains = [], []
            for w in wavs:
                files.append(_find_file(str(w.params.get("file", "")),
                                        files_dir))
                gains.append(_gain_through_passives(fg, w))
            kind = "wav_mix" if len(files) > 1 else "wav"
            rep = any(bool(w.params.get("repeat")) for w in wavs)
            return "receiver", SourceSpec(kind, files, gains, repeat=rep), None
        c2 = fg.one("C2_File_Source")
        if c2:
            return "receiver", SourceSpec(
                "c2", [_find_file(str(c2.params.get("file", "")), files_dir)],
                [1.0], repeat=bool(c2.params.get("repeat")),
                drift_rate=float(c2.params.get("drift_rate", 0.0) or 0.0),
            ), None
        return "receiver", SourceSpec("audio", [], []), None

    c2 = fg.one("C2_File_Source")
    if c2:
        src = SourceSpec(
            "c2", [_find_file(str(c2.params.get("file", "")), files_dir)],
            [1.0], repeat=bool(c2.params.get("repeat")))
        ws = fg.one("blocks_wavfile_sink")
        rate = int(fg.variables.get("samp_rate", 12000))
        if ws:
            return "sender", src, SinkSpec("wav",
                                           file=str(ws.params.get("file")),
                                           rate=rate)
        if fg.one("audio_sink"):
            return "sender", src, SinkSpec("audio", rate=rate)
    raise ValueError(f"unrecognized flowgraph topology: {fg.path} "
                     f"(blocks: {sorted(b.key for b in fg.blocks.values())})")


def describe(fg: Flowgraph, files_dir: str | None = None) -> str:
    """Human-readable mapping summary (``uwspr grc --show``)."""
    kind, src, sink = classify(fg, files_dir)
    cfg = pipeline_config(fg)
    lines = [f"flowgraph: {fg.path}", f"kind: {kind}"]
    if src:
        lines.append(f"source: {src.kind}"
                     + (f" {src.files}" if src.files else " (live stdin)")
                     + (f" gains {src.gains}" if src.kind == "wav_mix" else "")
                     + (" repeat" if src.repeat else ""))
    if sink:
        lines.append(f"sink: {sink.kind}"
                     + (f" -> {sink.file}" if sink.file else ""))
    c = cfg.coarse
    lines.append(
        f"coarse: fs={c.fs} fl={c.fl} spb={c.spb} maxdrift={c.maxdrift} "
        f"maxfreqs={c.maxfreqs} halfbandwidth={c.halfbandwidth} cf={c.cf} "
        f"threshold={c.threshold}")
    s = cfg.stream
    lines.append(f"window: fl={s.fl} shift={s.shift}s C={s.capacity_windows}")
    f = cfg.frontend
    lines.append(f"frontend: {f.audio_rate} S/s audio, band "
                 f"{f.center_freq}+/-{f.half_bandwidth} Hz, decim "
                 f"x{f.decimation}")
    ignored = sorted({b.key for b in fg.blocks.values()
                      if b.key in _IGNORED_KEYS and b.key != "variable"})
    if ignored:
        lines.append(f"ignored (no decode-path effect): {', '.join(ignored)}")
    return "\n".join(lines)


__all__ = ["parse_grc", "pipeline_config", "classify", "describe",
           "Flowgraph", "Block", "SourceSpec", "SinkSpec"]
