"""The port's device OSD sweep (``harness.osd_sweeps --engine device``)
against scripts/sweep_osd_device_artifact.py, on the CPU at a toy budget.

4 trials at -28 dB go through the harness and through the script's main,
with the config classes of both modules replaced by ones that cut the
search (3 jiggles, a Fano budget of 2 cycles a bit, where the Fano misses
most trials and order-2 device OSD rescues them): the Fano, OSD and
false-valid rates are equal. The JAX side's on-device Fano is the Pallas
kernel in interpret mode, as in tests/test_torch_harness_device.py. Its
own file, beside that one: the script compiles two JAX programs.
"""

import json

import pytest

from uwspr_tpu import config as jconfig
from uwspr_tpu_torch import config as tconfig
from uwspr_tpu_torch.harness import osd_sweeps

from test_torch_harness import scripts, toy

TOY_DEMOD = {"n_jiggles": 3, "maxcycles": 2}
JAX_TOY_DEMOD = {**TOY_DEMOD, "fano_impl": "pallas"}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return scripts(tmp_path_factory)


def test_osd_device_sweep_as_the_script(ref, monkeypatch, tmp_path):
    d = ref["osd_device"]
    monkeypatch.setattr(d, "PipelineConfig",
                        toy(jconfig.PipelineConfig, demod=JAX_TOY_DEMOD))
    for name, v in (("TRIALS", 4), ("SNRS", [-28.0]), ("DEPTH", 2),
                    ("OUT", str(tmp_path / "osd.json"))):
        monkeypatch.setattr(d, name, v)
    d.main()
    want = json.loads((tmp_path / "osd.json").read_text())["results"][0]
    monkeypatch.setattr(osd_sweeps, "PipelineConfig",
                        toy(tconfig.PipelineConfig, demod=TOY_DEMOD))
    base, deep = osd_sweeps.decoders("device", 2, 4, device="cpu")
    r = osd_sweeps.row(-28.0, osd_sweeps.run_point("device", base, deep,
                                                   -28.0, 4), 0.0)
    keys = ("fano_rate", "osd_rate", "false_valid_rate")
    assert {k: r[k] for k in keys} == {k: want[k] for k in keys}
    assert r["fano_rate"] < r["osd_rate"], r
