"""The port holds its own copy of every JAX-free layer it uses, and nothing
of the JAX package.

Three kinds of test:

- parity: each copy (config, protocol tables and constants, message
  packing, modulation, the channel, c2 files, the numpy SLM model, the
  Fano reference decoder, the native Fano and windower sources, OSD
  acceptance, stage timers) against its original in ``uwspr_tpu``, on
  inputs made with numpy
  from a seed. Tolerance: exact everywhere (the copies are the same code).
- sources: the port's copies of python modules (io/wavfile.py, grc.py,
  utils/spotlog.py, the numpy half of frontend/downconvert.py, io/audio.py
  but for the repaired arecord read) against their originals' ASTs, up to
  docstrings and the package their imports name.
- separation: a static walk of the AST of every port source file (and of
  chip_smoke.py and the port's scripts torch_async_readings.py,
  torch_osd_decodes.py, torch_osd_kernel.py, torch_probe_tiling.py,
  torch_select_fano_tuning.py and torch_trace_stages.py) for imports of
  ``uwspr_tpu`` or ``jax`` and paths into ``uwspr_tpu/``.

``jax_config`` turns a port config into the JAX package's config of the
same fields; the other ``test_torch_*`` files build their configs with the
port's classes and hand the JAX side ``jax_config(cfg)``.
"""

import ast
import dataclasses
import pathlib
import re

import numpy as np
import pytest

import uwspr_tpu.config as jconfig
import uwspr_tpu.fec.fano_ref as jfano_ref
import uwspr_tpu.fec.osd as josd
import uwspr_tpu.io.c2file as jc2
import uwspr_tpu.io.channel as jchannel
import uwspr_tpu.models.slm as jslm
import uwspr_tpu.protocol._tables as jtables
import uwspr_tpu.protocol.constants as jconstants
import uwspr_tpu.protocol.fec_encode as jfec_encode
import uwspr_tpu.protocol.messages as jmessages
import uwspr_tpu.protocol.modulate as jmodulate
import uwspr_tpu.utils.timers as jtimers
import uwspr_tpu_torch.config as tconfig
import uwspr_tpu_torch.fec.fano_ref as tfano_ref
import uwspr_tpu_torch.fec.osd as tosd
import uwspr_tpu_torch.io.c2file as tc2
import uwspr_tpu_torch.io.channel as tchannel
import uwspr_tpu_torch.models.slm as tslm
import uwspr_tpu_torch.protocol._tables as ttables
import uwspr_tpu_torch.protocol.constants as tconstants
import uwspr_tpu_torch.protocol.fec_encode as tfec_encode
import uwspr_tpu_torch.protocol.messages as tmessages
import uwspr_tpu_torch.protocol.modulate as tmodulate
import uwspr_tpu_torch.utils.timers as ttimers
from uwspr_tpu.fec.native import fano_decode_batch_native
from uwspr_tpu_torch.fec.host import NATIVE_SOURCE, fano_decode_batch_host

ROOT = pathlib.Path(__file__).resolve().parents[1]


def jax_config(cfg: tconfig.PipelineConfig) -> jconfig.PipelineConfig:
    """The JAX package's PipelineConfig with every field of ``cfg``."""
    d = dataclasses.asdict(cfg)
    return jconfig.PipelineConfig(
        coarse=jconfig.CoarseConfig(**d["coarse"]),
        demod=jconfig.DemodConfig(**d["demod"]),
        stream=jconfig.StreamConfig(**d["stream"]),
        frontend=jconfig.FrontendConfig(**d["frontend"]),
        fano_backend=d["fano_backend"])


def jax_coarse(cfg: tconfig.CoarseConfig) -> jconfig.CoarseConfig:
    return jconfig.CoarseConfig(**dataclasses.asdict(cfg))


def jax_demod(cfg: tconfig.DemodConfig) -> jconfig.DemodConfig:
    return jconfig.DemodConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------- constants

def _public_values(mod):
    out = {}
    for name in getattr(mod, "__all__", None) or dir(mod):
        if name.startswith("__") or (name.startswith("_")
                                     and mod not in (jtables, ttables)):
            continue
        v = getattr(mod, name)
        if isinstance(v, (np.ndarray, int, float, str, tuple)):
            out[name] = v
    return out


@pytest.mark.parametrize("pair", [(jtables, ttables),
                                  (jconstants, tconstants),
                                  (jslm, tslm)],
                         ids=["_tables", "constants", "slm"])
def test_constants_and_tables_equal(pair):
    j, t = (_public_values(m) for m in pair)
    assert set(j) <= set(t), sorted(set(j) - set(t))
    assert j, "no constants compared"
    for name, v in j.items():
        if isinstance(v, np.ndarray):
            assert t[name].dtype == v.dtype, name
            np.testing.assert_array_equal(t[name], v, err_msg=name)
        else:
            assert t[name] == v, name


def test_deinterleave_and_encoder_equal():
    rng = np.random.default_rng(0)
    sym = rng.integers(0, 256, size=(5, 162)).astype(np.uint8)
    np.testing.assert_array_equal(tconstants.deinterleave(sym),
                                  jconstants.deinterleave(sym))
    for _ in range(4):
        bits = rng.integers(0, 2, 50).astype(np.uint8)
        np.testing.assert_array_equal(tfec_encode.channel_symbols(bits),
                                      jfec_encode.channel_symbols(bits))
        np.testing.assert_array_equal(tfec_encode.encode_frame_bits(bits),
                                      jfec_encode.encode_frame_bits(bits))


def test_slm_numpy_model_equal():
    t = tslm.symbol_times_coarse()
    np.testing.assert_array_equal(t, jslm.symbol_times_coarse())
    np.testing.assert_array_equal(tslm.drift_table(1500.0, t),
                                  jslm.drift_table(1500.0, t))


# ---------------------------------------------------------------- configs

CONFIGS = {
    "default": lambda m: m.PipelineConfig(),
    "serving_128": lambda m: m.with_serving_defaults(m.PipelineConfig(), 128),
    "serving_2": lambda m: m.with_serving_defaults(m.PipelineConfig(), 2),
    "pallas_stft": lambda m: m.with_serving_defaults(m.PipelineConfig(
        coarse=m.CoarseConfig(stft_impl="pallas")), 128),
    "wideband": lambda m: m.with_serving_defaults(m.PipelineConfig(
        coarse=m.CoarseConfig(halfbandwidth=187)), 8),
    "explicit_fft": lambda m: m.with_serving_defaults(m.PipelineConfig(
        coarse=m.CoarseConfig(stft_impl="fft"),
        demod=m.DemodConfig(maxcycles=2000, probe_dtype="f32")), 4),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configs_equal(name):
    j, t = CONFIGS[name](jconfig), CONFIGS[name](tconfig)
    # the port's own section (the device multipass) has no JAX field: its
    # default at W = 1, 2 x the batch width at a serving point
    td = dataclasses.asdict(t)
    serving_w = {"serving_128": 128, "serving_2": 2, "pallas_stft": 128,
                 "wideband": 8, "explicit_fft": 4}.get(name, 0)
    assert td.pop("multipass") == dataclasses.asdict(
        tconfig.MultipassConfig(subtract_max_lanes=2 * serving_w))
    assert td == dataclasses.asdict(j)
    assert dataclasses.asdict(jax_config(t)) == dataclasses.asdict(j)
    for prop in ("fft_size", "n_ffts", "df", "hpbm"):
        assert getattr(t.coarse, prop) == getattr(j.coarse, prop), prop
    assert t.demod.minrms == j.demod.minrms


# ---------------------------------------------------------------- signals

MESSAGES = [("VE3EMB", "FN25", 30), ("K1ABC", "FN42", 37),
            ("PJ4/K1ABC", None, 30), ("K1ABC/7", None, 23),
            ("K1ABC", "FN42AX", 27), ("G4ABC", "IO91", 0)]


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: " ".join(map(str, m)))
def test_pack_unpack_equal(msg):
    pj = jmessages.pack_message(*msg)
    pt = tmessages.pack_message(*msg)
    np.testing.assert_array_equal(pt, pj)
    hj, ht = jmessages.HashTable(), tmessages.HashTable()
    # a type-1 frame first, so that a hashed call can be resolved
    for m, h in ((jmessages, hj), (tmessages, ht)):
        m.unpack_message(bytes(m.pack_message("K1ABC", "FN42", 37)[:7]), h)
    uj = jmessages.unpack_message(bytes(pj[:7]), hj)
    ut = tmessages.unpack_message(bytes(pt[:7]), ht)
    assert dataclasses.asdict(ut) == dataclasses.asdict(uj)
    assert ht.slots == hj.slots


def test_synthesize_frame_and_awgn_equal():
    rng = np.random.default_rng(11)
    for call, grid, dbm in MESSAGES[:4]:
        f = float(rng.uniform(-5, 5))
        start = int(rng.integers(0, 2000))
        zj = jmodulate.synthesize_frame(call, grid, dbm, freq_offset=f,
                                        start_sample=start)
        zt = tmodulate.synthesize_frame(call, grid, dbm, freq_offset=f,
                                        start_sample=start)
        np.testing.assert_array_equal(zt, zj)
        seed = int(rng.integers(0, 2**31))
        nj = jchannel.awgn(zj, -18.0, rng=np.random.default_rng(seed))
        nt = tchannel.awgn(zt, -18.0, rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(nt, nj)
    assert tchannel.noise_sigma(-21.5) == jchannel.noise_sigma(-21.5)
    z = jmodulate.synthesize_frame("K1ABC", "FN42", 37)
    np.testing.assert_array_equal(
        tchannel.apply_slm_doppler(z, 1.0, -2.0, 0.0, 250.0, 1500.0),
        jchannel.apply_slm_doppler(z, 1.0, -2.0, 0.0, 250.0, 1500.0))
    np.testing.assert_array_equal(tchannel.apply_linear_drift(z, 1.5),
                                  jchannel.apply_linear_drift(z, 1.5))


def test_c2_files_equal(tmp_path):
    rng = np.random.default_rng(2)
    z = (rng.normal(size=45000) + 1j * rng.normal(size=45000)).astype(
        np.complex64)
    jc2.write_c2(tmp_path / "j.c2", z, name="jax", dial_freq_hz=14.0956e6)
    tc2.write_c2(tmp_path / "t.c2", z, name="jax", dial_freq_hz=14.0956e6)
    assert (tmp_path / "j.c2").read_bytes() == (tmp_path / "t.c2").read_bytes()
    a, b = jc2.read_c2(tmp_path / "j.c2"), tc2.read_c2(tmp_path / "j.c2")
    np.testing.assert_array_equal(b.samples, a.samples)
    assert (b.name, b.wspr_type, b.dial_freq_hz) == (a.name, a.wspr_type,
                                                     a.dial_freq_hz)


# ---------------------------------------------------------------- decoders

def _soft_lanes(rng, n, sigma):
    out = []
    for _ in range(n):
        bits = rng.integers(0, 2, 50).astype(np.uint8)
        coded = jfec_encode.encode_frame_bits(bits)
        soft = 128 + (2 * coded.astype(int) - 1) * 60
        out.append(np.clip(soft + rng.normal(0, sigma, 162), 0, 255))
    return np.asarray(out, np.uint8)


def test_fano_ref_and_native_copy_match_native():
    """The port's fano_ref and its copy of fano_native.cc (built by
    fec/host.py) against the JAX package's native decoder: bit-exact on
    every field, clean, noisy and timing-out lanes."""
    rng = np.random.default_rng(4)
    lanes = np.concatenate([_soft_lanes(rng, 4, 20.0),
                            _soft_lanes(rng, 4, 70.0),
                            rng.integers(0, 256, (2, 162)).astype(np.uint8)])
    met = jconstants.FANO_METTAB
    want = fano_decode_batch_native(lanes, met, maxcycles=300)
    native = fano_decode_batch_host(lanes, backend="native", device="cpu",
                                    maxcycles=300)
    for a, b in zip(native, want):
        np.testing.assert_array_equal(a, b)
    assert want[0].any() and not want[0].all()
    for i, lane in enumerate(lanes):
        r = tfano_ref.fano_decode(lane, met, maxcycles=300)
        rj = jfano_ref.fano_decode(lane, met, maxcycles=300)
        assert (r.success, r.metric, r.cycles, r.maxnp) == (
            rj.success, rj.metric, rj.cycles, rj.maxnp)
        np.testing.assert_array_equal(r.data, rj.data)
        got = (r.success, np.asarray(r.data, np.uint8), r.metric, r.cycles,
               r.maxnp)
        for a, b in zip(got, (x[i] for x in want)):
            np.testing.assert_array_equal(a, b)


def _code(p):       # a C++ source without comments and blank lines
    text = re.sub(r"//[^\n]*", "", p.read_text())
    return [ln.strip() for ln in text.splitlines() if ln.strip()]


def test_native_source_is_the_ports_own():
    own = NATIVE_SOURCE.resolve()
    assert own.is_relative_to(ROOT / "uwspr_tpu_torch")
    orig = ROOT / "uwspr_tpu" / "fec" / "native" / "fano_native.cc"
    assert _code(own) == _code(orig)


def test_stream_native_source_is_the_ports_own():
    """The native windower is built from the port's own copy of
    stream_native.cc, into the port's build directory."""
    from uwspr_tpu_torch.pipeline import native
    from uwspr_tpu_torch.utils.cuda_build import BUILD_DIR
    own = native.SOURCE.resolve()
    assert own.is_relative_to(ROOT / "uwspr_tpu_torch")
    orig = ROOT / "uwspr_tpu" / "pipeline" / "native" / "stream_native.cc"
    assert _code(own) == _code(orig)
    lib = pathlib.Path(native.load_windower()._name)
    assert lib.parent == BUILD_DIR and lib.parent != own.parent


def test_accept_osd_equal():
    rng = np.random.default_rng(9)
    dcfg_t = tconfig.DemodConfig(osd_depth=2)
    dcfg_j = jax_demod(dcfg_t)
    for sigma in (45.0, 80.0):
        lanes = _soft_lanes(rng, 3, sigma)
        gate = np.array([True, False, True])
        sync2 = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        assert (tosd.accept_osd(lanes, gate, sync2, dcfg_t)
                == josd.accept_osd(lanes, gate, sync2, dcfg_j))
        rt = tosd.osd_decode(lanes[0], order=2)
        rj = josd.osd_decode(lanes[0], order=2)
        np.testing.assert_array_equal(rt.info_bits, rj.info_bits)
        assert (rt.quality, rt.margin, rt.flips) == (rj.quality, rj.margin,
                                                     rj.flips)


def test_stage_timers_equal():
    a, b = jtimers.StageTimers(), ttimers.StageTimers()
    for t in (a, b):
        for name in ("fano", "coarse", "fano"):
            with t.stage(name):
                pass
    assert ({k: v["count"] for k, v in a.summary().items()}
            == {k: v["count"] for k, v in b.summary().items()})
    assert list(b.summary()) == ["coarse", "fano"]


# ---------------------------------------------------------------- sources

def _normalized(path: pathlib.Path) -> ast.Module:
    """``path``'s AST without docstrings, its ``uwspr_tpu`` imports read as
    ``uwspr_tpu_torch`` ones: two copies that differ only there dump
    equal."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module.split(".")[0] == "uwspr_tpu"):
            node.module = "uwspr_tpu_torch" + node.module[len("uwspr_tpu"):]
    return tree


def _definitions(path: pathlib.Path) -> dict[str, str]:
    """Top-level statements of ``path`` by name (a class's methods as
    ``Class.method``, its other statements as ``Class``), each dumped."""
    out = {}
    for i, node in enumerate(_normalized(path).body):
        if isinstance(node, ast.ClassDef):
            rest = []
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    out[f"{node.name}.{item.name}"] = ast.dump(item)
                else:
                    rest.append(ast.dump(item))
            out[node.name] = (str(rest), [ast.dump(b) for b in node.bases])
        elif isinstance(node, ast.FunctionDef):
            out[node.name] = ast.dump(node)
        else:
            out[f"<statement {ast.dump(node)[:60]}>#{i}"] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", ["io/wavfile.py", "grc.py",
                                 "utils/spotlog.py"])
def test_module_copies_equal(rel):
    """Whole-module copies: the same code as the original, up to
    docstrings and the package their imports name."""
    own = ROOT / "uwspr_tpu_torch" / rel
    orig = ROOT / "uwspr_tpu" / rel
    assert ast.dump(_normalized(own)) == ast.dump(_normalized(orig))


def test_downconvert_numpy_half_equal():
    """design_lowpass, StreamingDownconverter and upconvert are the
    original's; Downconverter and downconvert are the port's own (torch,
    on a named device)."""
    own = _definitions(ROOT / "uwspr_tpu_torch/frontend/downconvert.py")
    orig = _definitions(ROOT / "uwspr_tpu/frontend/downconvert.py")
    names = ["design_lowpass", "upconvert", "StreamingDownconverter",
             "StreamingDownconverter.__init__",
             "StreamingDownconverter.push"]
    for name in names:
        assert own[name] == orig[name], name
    assert {"Downconverter.__call__", "downconvert"} <= set(own)


# the one definition in which the port's io/audio.py differs: a short read
# with an odd byte count is truncated to whole samples, and fewer than 2
# bytes end the stream with EOFError (the original raises ValueError)
AUDIO_REPAIRED = {"_ArecordBackend.read"}


def test_audio_copy_equal_except_the_arecord_read():
    own = _definitions(ROOT / "uwspr_tpu_torch/io/audio.py")
    orig = _definitions(ROOT / "uwspr_tpu/io/audio.py")
    assert set(own) == set(orig)
    differ = {k for k in own if own[k] != orig[k]}
    assert differ == AUDIO_REPAIRED


# ---------------------------------------------------------------- separation

PORT_FILES = sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "uwspr_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py", "scripts/torch_async_readings.py",
       "scripts/torch_osd_decodes.py",
       "scripts/torch_osd_kernel.py",
       "scripts/torch_probe_tiling.py",
       "scripts/torch_select_fano_tuning.py",
       "scripts/torch_trace_stages.py"])
# a "file:line" reference to the TPU kernel a port kernel replaces is text,
# not a path the program reads
_CITATION = re.compile(r"^uwspr_tpu/[\w/]+\.py:\d+$")


def _jax_package_uses(tree: ast.AST) -> list[str]:
    docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                  if isinstance(n, (ast.Module, ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.ClassDef))
                  and n.body and isinstance(n.body[0], ast.Expr)
                  and isinstance(n.body[0].value, ast.Constant)}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [f"import {a.name}" for a in node.names
                      if a.name.split(".")[0] in ("uwspr_tpu", "jax")]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level == 0 and mod.split(".")[0] in ("uwspr_tpu",
                                                         "jax"):
                found.append(f"from {mod} import ...")
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docstrings):
            s = node.value
            if (s == "uwspr_tpu" or s.startswith("uwspr_tpu.")
                    or (s.startswith("uwspr_tpu/")
                        and not _CITATION.match(s))):
                found.append(f"string {s!r} at line {node.lineno}")
    return found


def test_guard_walks_the_user_facing_surfaces():
    for rel in ("cli.py", "grc.py", "frontend/downconvert.py",
                "io/wavfile.py", "io/audio.py", "utils/spotlog.py",
                "utils/profiler.py", "utils/roofline.py",
                "pipeline/sweep.py", "parallel/__init__.py",
                "parallel/distributed.py", "parallel/mesh.py",
                *(f"harness/{m}.py" for m in (
                    "__init__", "common", "scenes", "bench", "matrix",
                    "sweeps", "osd_sweeps", "multipass", "ring_ingest",
                    "osd_calibrate", "scaling", "replay"))):
        assert f"uwspr_tpu_torch/{rel}" in PORT_FILES, rel
    assert len(_jax_package_uses(ast.parse(
        "import jax\nimport jax.numpy as jnp\nfrom jax import lax\n"
        "import jaxtyping\n"))) == 3


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_never_uses_jax_package(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    assert _jax_package_uses(tree) == []


def test_guard_catches_jax_package_uses():
    bad = ("import uwspr_tpu\nfrom uwspr_tpu.config import X\n"
           "import importlib\nimportlib.import_module('uwspr_tpu.io')\n"
           "p = ROOT / 'uwspr_tpu' / 'fec'\nq = 'uwspr_tpu/fec/x.cc'\n")
    assert len(_jax_package_uses(ast.parse(bad))) == 5
    good = ("from uwspr_tpu_torch import config\n"
            "r = 'uwspr_tpu/ops/probe_pallas.py:123'\n")
    assert _jax_package_uses(ast.parse(good)) == []
