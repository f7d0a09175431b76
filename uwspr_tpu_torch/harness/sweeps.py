"""The port's decode-rate curves (scripts/sweep_r05_artifact.py).

    python -m uwspr_tpu_torch.harness.sweeps [--device cuda|cpu]
                                             [--snr S [S ...]] [--trials N]

Three curves through pipeline/sweep.py's ``snr_sweep``, at untouched
``with_serving_defaults`` for a batch of ``trials`` windows, seed 1, 50
trials a point from -15 to -31 dB:

  hybrid_serving   the device pre-Fano pipeline + the native host Fano
  device_serving   the device engine (the Fano kernel)
  wideband_device  halfbandwidth 187, maxfreqs 200, the device engine

Each trial's outcome is kept: ``snr_sweep``'s progress callback passes the
cumulative count, so an outcome is the step between two counts. The curves
share their trial windows, bitwise the reference's. ``--snr`` runs a
subset of the points and merges them into torch_results/sweeps.json: the
sweep draws every point's trials from one generator, so the points before
a chosen one are drawn and thrown away, not decoded
(``scenes.skip_sweep_trials``).

Checks: each curve within tolerance of SWEEP_r05.json (common.vs_reference)
and the device engine equal to the hybrid engine trial by trial.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np
import torch

from uwspr_tpu_torch.config import (CoarseConfig, PipelineConfig,
                                    with_serving_defaults)
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.harness import common, scenes
from uwspr_tpu_torch.pipeline.sweep import snr_sweep

REFERENCE = "SWEEP_r05.json"
SNRS = list(range(-15, -32, -1))
TRIALS = 50
SEED = 1


def curve_configs(trials: int) -> dict:
    """name -> (engine, config) of the reference's three curves."""
    nb = with_serving_defaults(PipelineConfig(), trials)
    wb = with_serving_defaults(PipelineConfig(coarse=CoarseConfig(
        halfbandwidth=187, maxfreqs=200)), trials)
    return {"hybrid_serving": ("hybrid", nb),
            "device_serving": ("device", nb),
            "wideband_device": ("device", wb)}


def run_curve(engine: str, config: PipelineConfig, snrs, trials: int, *,
              device: torch.device, seed: int = SEED, all_snrs=SNRS
              ) -> tuple[dict, dict]:
    """({point: [1 or 0 per trial]}, {point: seconds}) of ``snrs``, a
    subset of ``all_snrs`` (the sweep's points in order): every point
    through ``snr_sweep`` on one generator seeded with ``seed``, the points
    not chosen skipped."""
    if not set(snrs) <= set(all_snrs):
        raise ValueError(f"points {sorted(set(snrs) - set(all_snrs))} are "
                         f"not among the sweep's {all_snrs}")
    rng = np.random.default_rng(seed)
    outcomes, seconds = {}, {}
    for snr in all_snrs:
        if snr not in snrs:
            scenes.skip_sweep_trials(rng, trials)
            continue
        counts = []
        t0 = time.perf_counter()
        # snr_sweep takes the generator itself as its seed
        # (np.random.default_rng returns a Generator unaltered)
        snr_sweep([snr], trials=trials, engine=engine, seed=rng,
                  config=config, device=device,
                  progress=lambda s, t, ok: counts.append(ok))
        outcomes[common.point(snr)] = [b - a for a, b in
                                       zip([0] + counts, counts)]
        seconds[common.point(snr)] = time.perf_counter() - t0
    return outcomes, seconds


def checks(record: dict) -> None:
    """(Re)compute the record's vs_reference blocks and exact checks from
    its curves."""
    ref = common.load_record(REFERENCE)["curves"]
    trials = record["trials"]
    curves = record["curves"]
    record["vs_reference"] = {
        name: common.vs_reference(c["decode_rate"],
                                  ref[name]["decode_rate"], name, trials)
        for name, c in curves.items()}
    if "device_serving" in curves and "hybrid_serving" in curves:
        dev, hyb = (curves[k]["outcomes"] for k in ("device_serving",
                                                    "hybrid_serving"))
        record["exact"] = {"device_equals_hybrid_trial_by_trial":
                           dev.keys() == hyb.keys()
                           and all(dev[p] == hyb[p] for p in dev)}


def main(argv=None) -> int:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--snr", type=int, nargs="+", choices=SNRS,
                   help="run these points only (default: all)")
    p.add_argument("--trials", type=int, default=TRIALS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    snrs = args.snr or SNRS
    path = pathlib.Path(args.out) / "sweeps.json"
    record = (json.loads(path.read_text()) if args.snr and path.exists()
              else {**common.record_head("sweeps", REFERENCE, device),
                    "trials": args.trials, "seed": SEED, "curves": {}})
    if record["trials"] != args.trials:
        raise SystemExit(f"{path} holds {record['trials']} trials a point, "
                         f"not {args.trials}")
    for name, (engine, cfg) in curve_configs(args.trials).items():
        common.log(f"--- {name} ({engine}) ---")
        out, secs = run_curve(engine, cfg, snrs, args.trials,
                              device=device)
        c = record["curves"].setdefault(name, {
            "engine": engine, "halfbandwidth": cfg.coarse.halfbandwidth,
            "stft_impl": cfg.coarse.stft_impl,
            "demod": {f: getattr(cfg.demod, f) for f in (
                "probe_dtype", "cand_compact_lanes", "refine_max_lanes",
                "fano_compact_lanes", "fano_impl")},
            "decode_rate": {}, "outcomes": {}, "seconds": {}})
        for pt, o in out.items():
            c["outcomes"][pt] = o
            c["decode_rate"][pt] = sum(o) / args.trials
            c["seconds"][pt] = secs[pt]
        order = sorted(c["decode_rate"], key=lambda q: -int(q))
        for f in ("decode_rate", "outcomes", "seconds"):
            c[f] = {q: c[f][q] for q in order}
        common.log(json.dumps(c["decode_rate"]))
    record["card"] = common.card_identity(device)
    checks(record)
    return common.finish(record, args.out, "sweeps")


if __name__ == "__main__":
    sys.exit(main())
