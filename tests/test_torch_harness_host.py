"""The port's host-engine result harnesses (``harness.multipass``,
``harness.osd_calibrate`` and ``harness.osd_sweeps --engine host``)
against the reference's scripts' own loops, on the CPU at toy budgets.

The same trials go through the harness and through the JAX script, with
the config classes of both modules replaced by ones that shrink the search
(24 coarse candidates, 5 jiggles, a Fano budget of 300 cycles a bit): 2
multipass trials, the OSD calibration rows of 2 trials at -30 dB and a
noise window, 2 trials of the host OSD sweep at -30 dB give the same
outcomes.

- (slow, full size) scripts/multipass_artifact.py on the CPU decodes the
  weak frame in the very trials the port decoded on the card.
"""

import json

import pytest

from uwspr_tpu import config as jconfig
from uwspr_tpu.pipeline import decoder as jdecoder
from uwspr_tpu_torch import config as tconfig
from uwspr_tpu_torch.harness import (common, multipass, osd_calibrate,
                                     osd_sweeps, scenes)

from test_torch_harness import scripts, toy

# the host engine at a toy size, for both packages: fewer candidates and
# jiggles, a small Fano budget
TOY_COARSE = {"maxfreqs": 24}
TOY_DEMOD = {"n_jiggles": 5, "maxcycles": 300}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return scripts(tmp_path_factory)


def test_multipass_decodes_as_the_script(ref, monkeypatch, tmp_path):
    m = ref["multipass"]
    monkeypatch.setattr(m, "WindowDecoder", lambda: jdecoder.WindowDecoder(
        toy(jconfig.PipelineConfig, TOY_COARSE, TOY_DEMOD)()))
    monkeypatch.setattr(m, "TRIALS", 2)
    monkeypatch.setattr(m, "WEAK_REL_DB", [-12.0])
    monkeypatch.setattr(m, "__file__", str(tmp_path / "scripts" / "x.py"))
    m.main()
    want = json.loads((tmp_path / "MULTIPASS_r02.json").read_text())
    monkeypatch.setattr(multipass, "PipelineConfig",
                        toy(tconfig.PipelineConfig, TOY_COARSE, TOY_DEMOD))
    row = multipass.run_row(multipass.make_decoder("cpu"), -12.0, range(2))
    keys = ("strong_rate", "weak_rate_single_pass", "weak_rate_multipass")
    assert {k: row[k] for k in keys} == {
        k: want["results"][0][k] for k in keys}
    assert row["strong"] == [1, 1]


def test_osd_calibration_rows_as_the_script(ref, monkeypatch, tmp_path):
    c = ref["calibrate"]
    monkeypatch.setattr(c, "PipelineConfig",
                        toy(jconfig.PipelineConfig, TOY_COARSE, TOY_DEMOD))
    monkeypatch.setattr(c, "TRIALS", 2)
    monkeypatch.setattr(c, "SNRS", [-30.0])
    monkeypatch.setattr(c, "__file__", str(tmp_path / "scripts" / "x.py"))
    c.main()
    want = json.loads((tmp_path / "OSD_CALIB.json").read_text())["rows"]
    wd = osd_calibrate.WindowDecoder(
        toy(tconfig.PipelineConfig, TOY_COARSE, TOY_DEMOD)(), device="cpu")
    rows = [r for snr in (-30.0, None) for t in range(2)
            for r in osd_calibrate.rows_for(wd, snr, t, 3, 31000)]
    assert rows and osd_calibrate.compare(rows, want)["pass"]


def test_host_osd_sweep_as_the_script(ref, monkeypatch, tmp_path):
    h = ref["osd_host"]
    monkeypatch.setattr(h, "PipelineConfig",
                        toy(jconfig.PipelineConfig, TOY_COARSE, TOY_DEMOD))
    for name, v in (("TRIALS", 2), ("SNRS", [-30.0]), ("DEPTH", 2),
                    ("OUT", str(tmp_path / "osd.json"))):
        monkeypatch.setattr(h, name, v)
    h.main()
    want = json.loads((tmp_path / "osd.json").read_text())["results"][0]
    monkeypatch.setattr(osd_sweeps, "PipelineConfig",
                        toy(tconfig.PipelineConfig, TOY_COARSE, TOY_DEMOD))
    base, deep = osd_sweeps.decoders("host", 2, 2, device="cpu")
    r = osd_sweeps.row(-30.0, osd_sweeps.run_point("host", base, deep,
                                                   -30.0, 2), 0.0)
    keys = ("fano_rate", "osd_rate", "false_valid_rate")
    assert {k: r[k] for k in keys} == {k: want[k] for k in keys}



@pytest.mark.slow
def test_jax_on_the_cpu_unmasks_the_cards_multipass_trials(ref, monkeypatch,
                                                           tmp_path):
    """At full size: scripts/multipass_artifact.py's own loop on the CPU
    (the JAX package's host engine), at -12 dB, 25 trials, decodes the weak
    frame in the very trials the port did on the card
    (torch_results/multipass.json), where the script's round-2 record
    (MULTIPASS_r02.json) reads 23 of 25."""
    m = ref["multipass"]
    seen = []
    spots = m.multipass_spots
    monkeypatch.setattr(m, "multipass_spots", lambda *a, **k: (
        lambda s: (seen.append(s), s)[1])(spots(*a, **k)))
    monkeypatch.setattr(m, "WEAK_REL_DB", [-12.0])
    monkeypatch.setattr(m, "__file__", str(tmp_path / "scripts" / "x.py"))
    m.main()
    weak = [int(any(s.message == scenes.WEAK_MSG for s in t)) for t in seen]
    card = common.load_record("torch_results/multipass.json")["results"]
    assert weak == next(r for r in card if r["weak_rel_db"] == -12.0)["multi"]
