"""The port's deep-SNR OSD sweeps (scripts/sweep_osd_artifact.py and
scripts/sweep_osd_device_artifact.py).

    python -m uwspr_tpu_torch.harness.osd_sweeps --engine host|device
        [--device cuda|cpu] [--snr S [S ...]] [--depth N] [--trials N]

Per SNR point (-28 to -32 dB, 25 trials, seeds 31000 + t): the Fano-only
decode rate, the rate with the OSD fallback, and the false-valid rate
(trials where an OSD-tagged wrong message survives every screen).

  host    WindowDecoder(PipelineConfig()) against osd_depth 5 (the host
          numpy OSD, fec/osd.py), one trial at a time; the record
          SWEEP_OSD_r05.json
  device  DeviceDecoder at the record's configuration, PipelineConfig(
          demod=DemodConfig(osd_depth=4, probe_dtype="bf16",
          refine_max_lanes=50, fano_compact_lanes=50)) (not
          with_serving_defaults), against the same without OSD; each
          point's trials as one batch; the record SWEEP_OSD_DEVICE_r05.json

Writes torch_results/osd_sweep_<engine>.json; ``--snr`` runs a subset and
merges it in. The host engine's order-5 OSD is single-threaded numpy and
takes minutes a point: run it one ``--snr`` at a time. Checks: fano_rate
and osd_rate within tolerance of the record, false_valid_rate 0 at every
point.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

from uwspr_tpu_torch.config import DemodConfig, PipelineConfig
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.harness import common, scenes
from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder

SNRS = [-28.0, -29.0, -30.0, -31.0, -32.0]
TRIALS = 25
MSG = scenes.EXPECTED
REFERENCES = {"host": "SWEEP_OSD_r05.json",
              "device": "SWEEP_OSD_DEVICE_r05.json"}
DEPTHS = {"host": 5, "device": 4}


def decoders(engine: str, depth: int, trials: int, *, device):
    """(base, deep): the reference's decoders without and with OSD at
    ``depth``."""
    extra = {}
    cls = WindowDecoder
    if engine == "device":
        extra = dict(probe_dtype="bf16", refine_max_lanes=2 * trials,
                     fano_compact_lanes=2 * trials)
        cls = DeviceDecoder
    return (cls(PipelineConfig(demod=DemodConfig(**extra)), device=device),
            cls(PipelineConfig(demod=DemodConfig(osd_depth=depth, **extra)),
                device=device))


def _outcome(fano_msgs, spots) -> tuple[int, int, int]:
    return (int(MSG in fano_msgs), int(MSG in {s.message for s in spots}),
            int(any(s.osd and s.message != MSG for s in spots)))


def run_point(engine: str, base, deep, snr: float, trials: int) -> list:
    """[(fano decoded, OSD run decoded, OSD false valid)] per trial."""
    if engine == "host":
        out = []
        for t in range(trials):
            z = scenes.osd_trial(snr, t)
            out.append(_outcome({s.message for s in base(z).spots},
                                deep(z).spots))
        return out
    ri = torch.from_numpy(scenes.osd_batch(snr, trials))
    ob = base.unpack_output(base.decode_windows_ri(ri))
    od = deep.unpack_output(deep.decode_windows_ri(ri))
    return [_outcome(base.messages(ob.window(w)), deep.spots(od.window(w)))
            for w in range(trials)]


def row(snr: float, outcomes: list, seconds: float) -> dict:
    n = len(outcomes)
    fano, osd, false = ([o[i] for o in outcomes] for i in range(3))
    return {"snr_db": snr, "fano_rate": sum(fano) / n,
            "osd_rate": sum(osd) / n, "false_valid_rate": sum(false) / n,
            "seconds": seconds, "fano": fano, "osd": osd, "false": false}


def checks(record: dict) -> None:
    ref = {common.point(r["snr_db"]): r
           for r in common.load_record(record["reference"])["results"]}
    rows = {common.point(r["snr_db"]): r for r in record["results"]}
    record["vs_reference"] = {
        key: common.vs_reference({p: r[key] for p, r in rows.items()},
                                 {p: r[key] for p, r in ref.items()}, key,
                                 record["trials"])
        for key in ("fano_rate", "osd_rate")}
    record["exact"] = {f"false_valid_zero_{p}": r["false_valid_rate"] == 0
                       for p, r in rows.items()}


def main(argv=None) -> int:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--engine", choices=("host", "device"), required=True)
    p.add_argument("--snr", type=float, nargs="+", choices=SNRS,
                   help="run these points only (default: all)")
    p.add_argument("--depth", type=int,
                   help="OSD order (default: the record's, 5 host, 4 device)")
    p.add_argument("--trials", type=int, default=TRIALS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    depth = args.depth or DEPTHS[args.engine]
    name = f"osd_sweep_{args.engine}"
    path = pathlib.Path(args.out) / f"{name}.json"
    record = (json.loads(path.read_text()) if args.snr and path.exists()
              else {**common.record_head("osd_sweeps",
                                         REFERENCES[args.engine], device),
                    "engine": args.engine, "osd_depth": depth,
                    "trials": args.trials,
                    "seeds": f"31000..{31000 + args.trials - 1}",
                    "results": []})
    if (record["osd_depth"], record["trials"]) != (depth, args.trials):
        raise SystemExit(f"{path} holds depth {record['osd_depth']} and "
                         f"{record['trials']} trials")
    card = common.card_identity(device)
    base, deep = decoders(args.engine, depth, args.trials, device=device)
    for snr in args.snr or SNRS:
        t0 = time.perf_counter()
        out = run_point(args.engine, base, deep, snr, args.trials)
        r = row(snr, out, time.perf_counter() - t0)
        r["card"] = card
        common.log(json.dumps({k: v for k, v in r.items()
                               if k not in ("fano", "osd", "false")}))
        record["results"] = sorted(
            [x for x in record["results"] if x["snr_db"] != snr] + [r],
            key=lambda x: -x["snr_db"])
    checks(record)
    return common.finish(record, args.out, name)


if __name__ == "__main__":
    sys.exit(main())
