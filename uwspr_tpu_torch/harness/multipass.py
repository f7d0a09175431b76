"""The port's multipass unmasking rates (scripts/multipass_artifact.py).

    python -m uwspr_tpu_torch.harness.multipass [--device cuda|cpu]
        [--rel-db R [R ...]] [--trials N]

A weak frame ("K1ABC FN42 37") 1.5 Hz above a strong one ("VE3EMB FN25
30", -13 dB), the weak one 6, 9 or 12 dB below it, 25 trials (seeds
1000 + t): the host engine (WindowDecoder(PipelineConfig())) with
``multipass_spots(passes=2)``. Per row: the strong frame's rate, the weak
frame's rate in the first pass (what one decode yields) and after the
cancellation pass.

Writes torch_results/multipass.json. Checks: both weak rates within
tolerance of MULTIPASS_r02.json; the strong frame decodes in every trial.
"""

from __future__ import annotations

import json
import sys
import time

from uwspr_tpu_torch.config import PipelineConfig
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.harness import common, scenes
from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
from uwspr_tpu_torch.pipeline.multipass import multipass_spots

REFERENCE = "MULTIPASS_r02.json"
TRIALS = 25
WEAK_REL_DB = [-6.0, -9.0, -12.0]


def trial(dec: WindowDecoder, rel_db: float, t: int) -> tuple[int, int, int]:
    """(strong decoded, weak decoded in pass 0, weak decoded at all)."""
    z = scenes.multipass_trial(rel_db, t)
    spots = multipass_spots(z, lambda w: dec(w).spots, dec.config, passes=2)
    by = {s.message: s for s in spots}
    weak = scenes.WEAK_MSG in by
    return (int(scenes.STRONG_MSG in by),
            int(weak and by[scenes.WEAK_MSG].pass_index == 0), int(weak))


def run_row(dec: WindowDecoder, rel_db: float, trials) -> dict:
    t0 = time.perf_counter()
    out = [trial(dec, rel_db, t) for t in trials]
    n = len(out)
    strong, single, multi = ([o[i] for o in out] for i in range(3))
    return {"weak_rel_db": rel_db, "weak_snr_db": scenes.STRONG_SNR + rel_db,
            "strong_rate": sum(strong) / n,
            "weak_rate_single_pass": sum(single) / n,
            "weak_rate_multipass": sum(multi) / n,
            "seconds": time.perf_counter() - t0,
            "trial_indices": list(trials),
            "strong": strong, "single": single, "multi": multi}


def make_decoder(device) -> WindowDecoder:
    """The reference's host decoder, WindowDecoder()."""
    return WindowDecoder(PipelineConfig(), device=device)


def checks(record: dict) -> None:
    ref = {common.point(r["weak_rel_db"]): r
           for r in common.load_record(REFERENCE)["results"]}
    rows = {common.point(r["weak_rel_db"]): r for r in record["results"]}
    record["vs_reference"] = {
        key: common.vs_reference({p: r[key] for p, r in rows.items()},
                                 {p: r[key] for p, r in ref.items()}, key,
                                 record["trials"])
        for key in ("weak_rate_single_pass", "weak_rate_multipass")}
    record["exact"] = {f"strong_always_decodes_{p}": r["strong_rate"] == 1.0
                       for p, r in rows.items()}


def main(argv=None) -> int:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--rel-db", type=float, nargs="+", choices=WEAK_REL_DB,
                   help="run these rows only (default: all)")
    p.add_argument("--trials", type=int, default=TRIALS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    dec = make_decoder(device)
    record = {**common.record_head("multipass", REFERENCE, device),
              "trials": args.trials,
              "seeds": f"1000..{1000 + args.trials - 1}",
              "engine": "host", "passes": 2, "results": []}
    for rel in args.rel_db or WEAK_REL_DB:
        r = run_row(dec, rel, range(args.trials))
        common.log(json.dumps({k: v for k, v in r.items() if k not in (
            "trial_indices", "strong", "single", "multi")}))
        record["results"].append(r)
    checks(record)
    return common.finish(record, args.out, "multipass")


if __name__ == "__main__":
    sys.exit(main())
