"""``uwspr_tpu_torch/harness/scaling.py`` (the port's multi-chip evidence)
against the JAX package's records and mesh, on the CPU.

- ``expected_inventory`` on SCALING_r05.json's five rows gives each row's
  collective rounds and ppermute bytes a device a step (pure); ``price``
  equals a hand computation at both rates.
- One gloo world of four CPU ranks (tests/torch_mesh_world.py, mode
  "scaling"), spawned once for the module while this process compiles the
  JAX references: the CollectiveLog of one ``ShardedDecoder.decode`` and
  one ``ShardedStreamDecoder.step`` on (4,1), (1,4) and (2,2) meshes at
  the harness's toy config equals ``expected_inventory`` on every rank,
  the step adding one all_gather; the spots equal the JAX mesh's on the
  same meshes of conftest's virtual CPU devices (its Fano the Pallas
  kernel in interpret mode, which compiles in a fraction of the while
  loop's time); the (1,4) exchange is the collective-permutes that
  scripts/scaling_analytic.py finds in the compiled JAX program's HLO.
  A (4,1) pod-shaped and a (1,4) multichip-shaped dry run give JAX's
  spots, and every selection and Fano call of them replays bit-exact (the
  plain Fano against the native decoder).
- The scenes are bitwise the ones the reference's scripts build
  (weak_scaling.py's channel and time scenes, pod_dryrun.py's,
  dryrun_multichip's), captured by replacing the script's decoder with a
  recorder; the scripts' configs equal the harness's.
- The records, built from ranks and controls made from the formula: every
  check passes, the known differences from SCALING_r05.json are listed,
  and a rank whose inventory strays fails its row.
- ``slow``: the harness itself on the CPU, 8 ranks under the launcher,
  against SCALING_r05.json.
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_mesh_world as world_mod
from test_torch_copies import jax_config
from uwspr_tpu.parallel import mesh as jmesh
from uwspr_tpu_torch.config import PipelineConfig
from uwspr_tpu_torch.harness import common, scaling
from uwspr_tpu_torch.harness.replay import combined

ROOT = common.ROOT
RECORD = json.loads((ROOT / scaling.REFERENCE).read_text())
REF_ROWS = RECORD["headline"]["rows"]


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Started before the module's first test, so that the world runs
    while this process compiles the JAX references."""
    w = world_mod.World(tmp_path_factory.mktemp("scaling"), "scaling")
    yield w
    w.kill()


def jax_cfg(cfg: PipelineConfig):
    """The JAX twin of a port config, its Fano the Pallas kernel in
    interpret mode (the same search as the while loop)."""
    j = jax_config(cfg)
    return dataclasses.replace(j, demod=dataclasses.replace(
        j.demod, fano_impl="pallas"))


def jax_stream(cfg, n_ch, n_t, channels, wps=1):
    mesh = jmesh.make_mesh(n_ch, n_t, devices=jax.devices()[:n_ch * n_t])
    return jmesh.ShardedStreamDecoder(jax_cfg(cfg), mesh,
                                      n_channels=channels,
                                      wins_per_shard=wps)


def spot_list(spots):
    return sorted([c, w, s.message] for c, w, s in spots)


def load_script(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- the formula

@pytest.mark.parametrize("ref", REF_ROWS, ids=lambda r: "{}x{}-w{}-c{}"
                         .format(r["mesh"]["channel"], r["mesh"]["time"],
                                 r["wins_per_shard"],
                                 r["channels_per_shard"]))
def test_expected_inventory_is_the_record(ref):
    row = (ref["mesh"]["channel"], ref["mesh"]["time"],
           ref["wins_per_shard"], ref["channels_per_shard"])
    assert row in scaling.ROWS
    inv = scaling.expected_inventory(*row, scaling.multichip_config())
    assert inv["collective_rounds"] == ref["collective_rounds"]
    assert (inv["ppermute_bytes_per_device_per_step"]
            == ref["ppermute_bytes_per_device_per_step"])
    permutes = [o["bytes"] for o in ref["collectives"]
                if o["op"] == "collective-permute"]
    assert [o["bytes"] for o in inv["collectives"]
            if o["op"] == "batch_isend_irecv"] == permutes
    assert [o["op"] for o in inv["collectives"]].count("all_reduce") == 1


@pytest.mark.parametrize("rate", sorted(scaling.RATES))
def test_price_by_hand(rate):
    """(2,4) at 4 windows a shard, the stream step: 4 rounds of 108,000 B,
    an 8 B all_reduce over 8 ranks (3 tree steps) and a ring all_gather of
    4 x 8 x 23 x 4 = 2,944 B blocks (7 steps, 7 blocks on the link)."""
    inv = scaling.expected_inventory(2, 4, 4, 1, scaling.multichip_config(),
                                     step=True)
    assert inv["allgather_bytes_per_device_per_step"] == 2944
    bw, lat = scaling.RATES[rate]
    wire = 4 * 108000 + 8 + 7 * 2944
    t_coll = wire / bw + (4 + 3 + 7) * lat
    got = scaling.price(inv, 2e-3, scaling.RATES[rate])
    assert got["wire_bytes"] == wire and got["latency_steps"] == 14
    assert math.isclose(got["t_collectives_s"], t_coll, rel_tol=1e-12)
    assert math.isclose(got["efficiency_bound"], 2e-3 / (2e-3 + t_coll),
                        rel_tol=1e-12)


def test_latency_curve_by_hand():
    """The (1,8) row at one window a shard, its decode: 13 rounds of
    27,000 B and a tree all_reduce of 8 B over 8 ranks (3 steps), so 16
    latency steps and 351,008 B; the bound at each latency is price's, and
    the latency at which it falls to 0.8 leaves t_compute / 4 for the
    collectives."""
    inv = scaling.expected_inventory(1, 8, 1, 1, PipelineConfig())
    t = 1e-3
    curve = scaling.latency_curve(inv, t, scaling.NVLINK_BYTES_S)
    wire_s = 351008 / scaling.NVLINK_BYTES_S
    assert curve["latency_steps"] == 16
    assert math.isclose(curve["wire_s"], wire_s, rel_tol=1e-12)
    for lat in scaling.LATENCY_STEPS_S:
        assert math.isclose(
            curve["efficiency_bound_at_latency_step_s"][f"{lat:g}"],
            t / (t + wire_s + 16 * lat), rel_tol=1e-12)
    lat80 = curve["latency_step_s_for_bound_0.8"]
    assert math.isclose(lat80, (t / 4 - wire_s) / 16, rel_tol=1e-12)
    assert math.isclose(scaling.price(inv, t, (scaling.NVLINK_BYTES_S,
                                               lat80))["efficiency_bound"],
                        0.8, rel_tol=1e-12)
    assert scaling.latency_curve(scaling.expected_inventory(
        1, 1, 1, 1, PipelineConfig()), t, scaling.NVLINK_BYTES_S)[
        "latency_step_s_for_bound_0.8"] is None


@pytest.mark.parametrize("row", scaling.ROWS,
                         ids=["x".join(map(str, r)) for r in scaling.ROWS])
def test_served_step_gathers_max_peaks_blocks(row):
    """The decode's inventory does not depend on the coarse or demod
    config; the step's all_gather at PipelineConfig() is the rank's
    (cps, wps, 13, 23) float32 block, 1,196 B a channel-window."""
    n_ch, n_t, wps, cps = row
    toy = scaling.multichip_config()
    assert (scaling.expected_inventory(*row, PipelineConfig())
            == scaling.expected_inventory(*row, toy))
    served = scaling.expected_inventory(*row, PipelineConfig(), step=True)
    assert served["allgather_bytes_per_device_per_step"] == cps * wps * 1196


# ------------------------------------------------------- the four-rank world

@pytest.fixture(scope="module")
def jax_rows():
    """Per row of SCALING_ROWS: the JAX mesh's count and spots on the row's
    scene, and its stream decoder."""
    out = {}
    for row in world_mod.SCALING_ROWS:
        n_ch, n_t, wps, cps = row
        js = jax_stream(scaling.multichip_config(), n_ch, n_t, n_ch * cps,
                        wps)
        x, tail = scaling.row_scene(row)
        res, n = js.dec.decode(x, tail)
        out[row] = (int(n), spot_list(js._emit(res, n_t * wps)), js)
    return out


@pytest.mark.parametrize("i", range(len(world_mod.SCALING_ROWS)),
                         ids=["x".join(map(str, r))
                              for r in world_mod.SCALING_ROWS])
def test_collective_log_is_the_formula(world, i):
    row = world_mod.SCALING_ROWS[i]
    want_d = scaling.expected_inventory(*row, scaling.multichip_config())
    want_s = scaling.expected_inventory(*row, scaling.multichip_config(),
                                        step=True)
    for res in world.ranks():
        got = res["rows"][i]
        assert got["decode"] == want_d
        assert got["step"] == want_s
        assert got["step"]["collectives"][-1]["op"] == "all_gather"
        assert got["step"]["collectives"][:-1] == got["decode"]["collectives"]


@pytest.mark.parametrize("i", range(len(world_mod.SCALING_ROWS)),
                         ids=["x".join(map(str, r))
                              for r in world_mod.SCALING_ROWS])
def test_row_spots_are_jax(world, jax_rows, i):
    row = world_mod.SCALING_ROWS[i]
    n, spots, _ = jax_rows[row]
    assert n >= 1
    for res in world.ranks():
        assert res["rows"][i]["count"] == n
        assert sorted(res["rows"][i]["spots"]) == spots


def test_exchange_is_the_compiled_jax_programs(world, jax_rows):
    """The (1,4) row at one window a shard: the 13 rounds the port's ranks
    hand dist.batch_isend_irecv are the collective-permutes of the
    compiled JAX program, byte for byte; its one all_reduce is the psum,
    int64 against s32."""
    analytic = load_script("scripts/scaling_analytic.py",
                           "_reference_scaling_analytic")
    row = (1, 4, 1, 1)
    i = world_mod.SCALING_ROWS.index(row)
    dec = jax_rows[row][2].dec
    x, tail = scaling.row_scene(row)
    gx, gt = dec._sharded_inputs(x, tail)
    ops = analytic.collect(dec._build(1, dec.hop).lower(gx, gt).compile()
                           .as_text())
    got = world.ranks()[0]["rows"][i]["decode"]["collectives"]
    assert sorted(scaling.HLO_OP[o["op"]] for o in got) == sorted(
        o["op"] for o in ops)
    assert ([o["bytes"] for o in got if o["op"] == "batch_isend_irecv"]
            == [o["bytes"] for o in ops if o["op"] == "collective-permute"]
            == [27000] * 13)
    assert [(o["bytes"], o["dtype"]) for o in got
            if o["op"] == "all_reduce"] == [(8, "int64")]
    assert [o["result_type"] for o in ops if o["op"] == "all-reduce"] == [
        "s32[]"]


def test_collective_log_records_a_barrier_and_restores(world):
    for res in world.ranks():
        assert [(o["op"], o["axis"], o["group_size"], o["bytes"])
                for o in res["barrier"]["collectives"]] == [
            ("barrier", "world", 4, 0)]
        assert res["restored"]


def test_pod_dry_run_is_jax(world):
    n_sh, n_t, cps = world_mod.SCALING_POD
    x, tail, frames = scaling.pod_scene(n_sh, cps)
    js = jax_stream(scaling.pod_config(), n_sh, n_t, n_sh * cps)
    res, n = js.dec.decode(x, tail)
    spots = spot_list(js._emit(res, 1))
    assert int(n) == frames == 4
    runs = [r["pod"] for r in world.ranks()]
    assert all(r["spots"] == int(n) for r in runs)
    assert sorted(m for r in runs for m in r["messages"]) == spots


def test_multichip_dry_run_is_jax(world):
    n_ch, n_t = world_mod.SCALING_MULTICHIP
    js = jax_stream(scaling.multichip_config(), n_ch, n_t, n_ch)
    spots = spot_list(js.push(scaling.multichip_scene(
        n_ch, js.step_len + js.halo)))
    assert [s[2] for s in spots] == [scaling.EXPECTED]
    for res in world.ranks():
        assert sorted(res["multichip"]["spots"]) == spots
        assert res["multichip"]["windows"] == n_t


@pytest.mark.parametrize("run", ["pod", "multichip"])
def test_dry_run_calls_replay_bit_exact(world, run):
    """On the CPU the wrappers run their plain versions (no launch); every
    recorded selection call equals select_best_plain and every Fano call
    the native decoder."""
    for res in world.ranks():
        r = res[run]
        assert r["replay"]["ok"], r["replay"]
        assert r["replay"]["select_calls"] >= 1
        assert r["replay"]["fano_calls"] >= 1
        assert not any(r["launches"].values())
        assert r["plain"]["select_best"] >= 1


@pytest.mark.parametrize("i", range(len(world_mod.SCALING_ROWS)),
                         ids=["x".join(map(str, r))
                              for r in world_mod.SCALING_ROWS])
def test_row_calls_replay_bit_exact(world, i):
    """Each row's decode and step are recorded runs too: on the CPU no
    launch, and every selection and Fano call replays against its
    oracle."""
    for res in world.ranks():
        for k in ("decode", "step"):
            r = res["rows"][i]["kernels"][k]
            assert r["replay"]["ok"], r["replay"]
            assert r["replay"]["select_calls"] >= 1
            assert r["replay"]["fano_calls"] >= 1
            assert not any(r["launches"].values())
            assert r["plain"]["select_best"] >= 1


# ---------------------------------------------------------------- scenes

class _Captured(Exception):
    pass


def _recorder(seen, *, step_len=None):
    """A decoder class for the reference scripts that records what it is
    handed (config, decode inputs or pushed samples) and decodes
    nothing."""
    class Recorder:
        hop, fl = 3375, 45000
        halo = fl - hop

        def __init__(self, config, mesh, **kw):
            seen["config"] = config
            if step_len is not None:
                self.step_len = step_len(mesh)

        def decode(self, stream, tail):
            seen["x"], seen["tail"] = np.array(stream), np.array(tail)
            raise _Captured

        def push(self, x):
            seen["x"] = np.array(x)
            raise _Captured
    return Recorder


@pytest.fixture
def quiet_cache():
    """The scripts point JAX's compile cache at the default directory when
    they run: restored afterwards."""
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("axis,n,wps", [("channel", 4, 1), ("time", 4, 2)])
def test_weak_scaling_scenes_bitwise(monkeypatch, quiet_cache, axis, n, wps):
    ws = load_script("scripts/weak_scaling.py", "_reference_weak_scaling")
    seen = {}
    monkeypatch.setattr(jmesh, "ShardedDecoder", _recorder(seen))
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **k: None)
    with pytest.raises(_Captured):
        ws.run_one(axis, n, 1, wins_per_shard=wps)
    x, tail = (scaling.channel_scene(n, wps) if axis == "channel"
               else scaling.time_scene(1, n, wps))
    np.testing.assert_array_equal(x, seen["x"])
    np.testing.assert_array_equal(tail, seen["tail"])


def test_pod_scene_and_config_bitwise(monkeypatch, quiet_cache):
    flag = "--xla_force_host_platform_device_count=8"
    if flag not in os.environ.get("XLA_FLAGS", ""):   # else it re-execs
        monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", "")
                           + " " + flag)
    pod = load_script("scripts/pod_dryrun.py", "_reference_pod_dryrun")
    seen = {}
    monkeypatch.setattr(pod, "ShardedDecoder", _recorder(seen))
    monkeypatch.setattr(pod, "make_mesh", lambda *a, **k: None)
    with pytest.raises(_Captured):
        pod.main()
    assert (pod.N_SHARDS, 1, pod.CH_PER_SHARD) == scaling.POD
    x, tail, frames = scaling.pod_scene(pod.N_SHARDS, pod.CH_PER_SHARD)
    np.testing.assert_array_equal(x, seen["x"])
    np.testing.assert_array_equal(tail, seen["tail"])
    assert frames == 8
    assert seen["config"] == jax_config(scaling.pod_config())


def test_multichip_scene_and_config_bitwise(monkeypatch, quiet_cache):
    graft = load_script("__graft_entry__.py", "_reference_graft_entry")
    seen = {}
    monkeypatch.setattr(jmesh, "ShardedStreamDecoder", _recorder(
        seen, step_len=lambda mesh: mesh[1] * 3375))
    monkeypatch.setattr(jmesh, "make_mesh", lambda n_ch, n_t, **k: (n_ch,
                                                                     n_t))
    with pytest.raises(_Captured):
        graft.dryrun_multichip(8)
    np.testing.assert_array_equal(
        scaling.multichip_scene(2, 4 * 3375 + 41625), seen["x"])
    assert seen["config"] == jax_config(scaling.multichip_config())


# --------------------------------------------------------------- records

FRAMED = [[0, 0, scaling.EXPECTED]]
COUNTS = {"select_best": 1, "fano_decode": 2, "probe_powers": 0,
          "stft_power": 0}
NONE = dict.fromkeys(COUNTS, 0)
REPLAY = {"select_calls": 1, "select_lanes": 4, "fano_calls": 2,
          "fano_active_lanes": 3, "fano_timeouts": 0, "probe_calls": 0,
          "probe_candidates": 0, "fano_max_abs_err": 0.0,
          "probe_max_abs_err": 0.0, "failures": [], "ok": True}


def recorded():
    """A recorded run's kernels: launched, no plain call, replayed."""
    return {"launches": dict(COUNTS), "plain": dict(NONE),
            "replay": dict(REPLAY)}


def formula_ranks():
    """The 8-rank world's results as the formula and the reference say
    they are."""
    toy = scaling.multichip_config()
    ranks = []
    for r in range(scaling.WORLD):
        kernels = {**recorded(), "step_seconds": 0.1}
        ranks.append({
            "rank": r,
            "rows": [{"row": list(row),
                      "decode": scaling.expected_inventory(*row, toy),
                      "step": scaling.expected_inventory(*row, toy,
                                                         step=True),
                      "count": 1, "spots": FRAMED,
                      "kernels": {"decode": recorded(), "step": recorded()}}
                     for row in scaling.ROWS],
            "pod": {"spots": 8, "frames_embedded": 8,
                    "messages": [[4 * r, 0, scaling.EXPECTED]], **kernels},
            "multichip": {"spots": FRAMED, "windows": 8, "count": 1,
                          **kernels}})
    return ranks


def formula_controls():
    """Controls at 2 ms a step plus 0.2 ms a window (events), 5% more on
    the host clock, with kernels launched and no plain call."""
    out = []
    for scene, channels, wps in scaling.CONTROLS:
        w = channels * wps
        ev = 2e-3 + 0.2e-3 * w
        out.append({"scene": scene, "channels": channels,
                    "wins_per_shard": wps, "windows": w,
                    "frames_embedded": channels if scene == "channel" else 1,
                    "spots": channels if scene == "channel" else 1,
                    "step_s": 1.05 * ev, "step_event_s": ev,
                    "kernels": recorded()})
    return {"rows": out, **combined([c["kernels"] for c in out])}


def test_records_from_the_formula(tmp_path):
    head = common.record_head("scaling", scaling.REFERENCE,
                              torch.device("cpu"))
    ranks, ctl = formula_ranks(), formula_controls()
    rec = scaling.scaling_record(ranks, ctl, head)
    assert common.finish(rec, tmp_path, "scaling") == 0
    fastest = 1.0 * (2e-3 + 0.2e-3 * 512) / 512
    assert rec["headline"] == {"t_compute_per_window_s": fastest,
                               "control": ["channel", 512, 1],
                               "clock": "cuda_events"}
    for row, out in zip(scaling.ROWS, rec["rows"]):
        n_ch, n_t, wps, cps = row
        b = out["bound"]["decode"]["inter_node_ndr400"]
        assert b["t_compute_s"] == fastest * wps * cps
        assert out["bound"]["step"]["intra_node_nvlink4"][
            "efficiency_bound"] < out["bound"]["decode"][
            "intra_node_nvlink4"]["efficiency_bound"]
        diffs = " ".join(out["vs_reference"]["inventory"]["differences"])
        assert "int64 (8 B)" in diffs and "s32[] (4 B" in diffs
        assert "adds one all_gather" in diffs
        assert out["step_served"]["allgather_bytes_per_device_per_step"] == (
            wps * cps * 1196)
        assert out["bound"]["step"]["inter_node_ndr400"]["wire_bytes"] == (
            out["decode"]["ppermute_bytes_per_device_per_step"] + 8
            + (n_ch * n_t - 1) * wps * cps * 1196)
        assert out["exact"]["replayed_bit_exact"]
        assert out["kernels"]["step"]["launches"]["fano_decode"] == 2 * 8
        curve = out["nvlink_latency_curve"]["decode"]
        assert curve["efficiency_bound_at_latency_step_s"]["1e-05"] == (
            out["bound"]["decode"]["intra_node_nvlink4"]["efficiency_bound"])
    for r in rec["pod_4096ch"]["rows"]:
        assert r["channels_per_chip"] == r["reference"]["channels_per_chip"]
        t = 2e-3 + 0.2e-3 * r["channels_per_chip"]
        assert r["bound_inter_node_ndr400"]["t_compute_s"] == t
        assert r["realtime_headroom"] > 1
    pod = scaling.pod_record(ranks, head)
    multi = scaling.multichip_record(ranks, head)
    assert common.finish(pod, tmp_path, "dryrun_pod") == 0
    assert common.finish(multi, tmp_path, "multichip") == 0
    assert multi["vs_reference"]["decode"]["reference"] == {
        "windows": 8, "spots": 1, "messages": [scaling.EXPECTED]}
    assert rec["exact"]["controls_replayed_bit_exact"]
    assert rec["controls"]["replay"]["select_calls"] == len(
        scaling.CONTROLS)


def test_a_stray_rank_fails_its_row(tmp_path):
    head = common.record_head("scaling", scaling.REFERENCE,
                              torch.device("cpu"))
    ranks = formula_ranks()
    ranks[5]["rows"][2]["decode"]["collectives"].pop(0)
    ranks[3]["pod"]["plain"] = COUNTS
    ranks[6]["rows"][4]["kernels"]["step"]["replay"]["ok"] = False
    rec = scaling.scaling_record(ranks, None, head)
    assert rec["rows"][2]["exact"]["decode_is_the_formula"] is False
    assert rec["rows"][4]["exact"]["replayed_bit_exact"] is False
    assert rec["headline"].startswith("not measured")
    assert common.finish(rec, tmp_path, "scaling") == 1
    assert scaling.pod_record(ranks, head)["exact"]["no_plain_call"] is False


# ------------------------------------------------------------------ slow

@pytest.mark.slow
def test_harness_on_the_cpu_is_the_record(tmp_path):
    """python -m uwspr_tpu_torch.harness.scaling --device cpu: 8 ranks
    under the launcher, every row's inventory the record's."""
    proc = subprocess.run(
        [sys.executable, "-m", "uwspr_tpu_torch.harness.scaling",
         "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / "scaling.json").read_text())
    assert rec["pass"] and rec["card"] == "cpu"
    assert not (tmp_path / "dryrun_pod.json").exists()
    for out, ref in zip(rec["rows"], REF_ROWS):
        assert out["decode"]["collective_rounds"] == ref["collective_rounds"]
        assert out["vs_reference"]["inventory"]["pass"]
