"""The port's result harnesses on the device and hybrid engines against
the reference's scripts, on the CPU at toy budgets.

The same trials go through the harness and through the JAX script's own
logic, with the config classes of both modules replaced by ones that cut
the search (3 jiggles, a Fano budget of 4 cycles a bit, where the Fano
decodes some trials and fails others): the outcomes are equal trial by
trial. On the JAX side the on-device Fano is the Pallas kernel in
interpret mode (fano_impl="pallas", the reference records' own path on the
TPU, bit-exact with the lax.while_loop Fano), which compiles in a quarter
of the while loop's time on the CPU. The device OSD sweep is in
tests/test_torch_harness_osd.py.

- ``harness.sweeps``: the device and hybrid curves at -28 and -29 dB past
  -20 dB (the skip-ahead), 4 trials, against ``snr_sweep`` as
  scripts/sweep_r05_artifact.py calls it (seed 1, the curve's config).
- ``harness.bench``: bench.py's main on 2 windows at -27 dB decodes the
  same count.
- (slow, full size) the JAX package's hybrid engine on the CPU decodes the
  very trials the port decoded on the card at -29, -30 and -31 dB
  (torch_results/sweeps.json), where the reference's TPU record reads 18
  of 50 at -30 dB and the port 20.
"""

import re

import numpy as np
import pytest
import torch

from uwspr_tpu import config as jconfig
from uwspr_tpu.pipeline import sweep as jsweep
from uwspr_tpu_torch import config as tconfig
from uwspr_tpu_torch.harness import bench, sweeps

from test_torch_harness import scripts, toy

TOY_DEMOD = {"n_jiggles": 3, "maxcycles": 4}
JAX_TOY_DEMOD = {**TOY_DEMOD, "fano_impl": "pallas"}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return scripts(tmp_path_factory)


def steps(counts):
    return [b - a for a, b in zip([0] + counts, counts)]


def test_sweep_curves_decode_as_the_script(ref, monkeypatch):
    r = ref["sweep"]
    monkeypatch.setattr(r, "TRIALS", 4)
    monkeypatch.setattr(r, "PipelineConfig",
                        toy(jconfig.PipelineConfig, demod=JAX_TOY_DEMOD))
    monkeypatch.setattr(sweeps, "PipelineConfig",
                        toy(tconfig.PipelineConfig, demod=TOY_DEMOD))
    snrs = [-20, -28, -29]
    nb = r.with_serving_defaults(r.PipelineConfig(), r.TRIALS)
    mine = sweeps.curve_configs(4)
    for name in ("device_serving", "hybrid_serving"):
        engine, cfg = mine[name]
        counts = {}
        jsweep.snr_sweep(snrs, trials=4, engine=engine, seed=1, config=nb,
                         progress=lambda s, t, ok: counts.setdefault(
                             s, []).append(ok))
        out, _ = sweeps.run_curve(engine, cfg, [-28, -29], 4, device="cpu",
                                  all_snrs=snrs)
        assert out == {f"{s}": steps(counts[s]) for s in (-28, -29)}, name
        assert 0 < sum(out["-28"]) < 4, out


def test_bench_decodes_as_bench_py(ref, monkeypatch, capsys):
    b = ref["bench"]
    for env, v in (("BENCH_WINDOWS", "2"), ("BENCH_REPS", "1"),
                   ("BENCH_SNR", "-27")):
        monkeypatch.setenv(env, v)
    monkeypatch.setattr(b, "N_WINDOWS", 2)
    monkeypatch.setattr(b, "SNR_DB", -27.0)
    monkeypatch.setattr(jconfig, "PipelineConfig",
                        toy(jconfig.PipelineConfig, demod=JAX_TOY_DEMOD))
    b.main()
    err = capsys.readouterr().err
    want = re.search(r"(\d+)/2 windows decoded correctly", err).group(1)
    monkeypatch.setattr(bench, "PipelineConfig",
                        toy(tconfig.PipelineConfig, demod=TOY_DEMOD))
    res = bench.run(torch.device("cpu"))
    assert res["decoded"] == f"{want}/2"
    assert (res["line"]["value"] > 0) == (want == "2")


@pytest.mark.slow
@pytest.mark.parametrize("snr", [-29, -30, -31])
def test_jax_on_the_cpu_decodes_the_cards_knee_trials(snr):
    """The knee of the sweep at full size: the JAX package's hybrid engine
    on the CPU, on the sweep's 50 trials at ``snr`` (seed 1, the points
    before it skipped), decodes exactly the trials the port decoded on the
    card (torch_results/sweeps.json, the hybrid curve)."""
    from uwspr_tpu_torch.harness import common, scenes
    record = common.load_record("torch_results/sweeps.json")
    card = record["curves"]["hybrid_serving"]["outcomes"][f"{snr}"]
    rng = np.random.default_rng(sweeps.SEED)
    for s in sweeps.SNRS[:sweeps.SNRS.index(snr)]:
        scenes.skip_sweep_trials(rng, sweeps.TRIALS)
    counts = []
    jsweep.snr_sweep([snr], trials=sweeps.TRIALS, engine="hybrid", seed=rng,
                     config=jconfig.with_serving_defaults(
                         jconfig.PipelineConfig(), sweeps.TRIALS),
                     progress=lambda s, t, ok: counts.append(ok))
    assert steps(counts) == card
