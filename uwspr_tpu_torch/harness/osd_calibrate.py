"""The port's OSD calibration study (scripts/osd_calibrate.py).

    python -m uwspr_tpu_torch.harness.osd_calibrate [--device cuda|cpu]
        [--order N] [--trials N] [--seed-base N]

For each SNR point (-29 to -32 dB, then noise-only windows), the host
pipeline runs on the card up to the Fano stage (``failed_lanes``, which
replicates the port's WindowDecoder), then the instrumented OSD
(fec/osd.py) decodes every Fano-failed worth lane and records per decode:

  correct   the decoded payload is the transmitted one
  unpack    the payload survives protocol unpacking
  quality   reliability-weighted correlation of the winner
  margin    (2nd-best candidate score - best) / total reliability
  flips     basis-bit flips of the winner
  sync2     the lane's fine-sync score
  agree2    an OSD decode of the 2nd-best gated jiggle lane gives the same
            payload, where such a lane exists

Writes torch_results/osd_calibrate.json with the rows and their summary.
At order 3, 25 trials and seed base 31000 the rows are held to
OSD_CALIB.json: the same (snr, trial, cand) set; each row's correct,
unpack, flips and agree2 equal; quality, margin and sync2 within 1e-3.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from uwspr_tpu_torch.config import DemodConfig, PipelineConfig
from uwspr_tpu_torch.device import exact_f32, resolve_device
from uwspr_tpu_torch.fec.host import fano_decode_batch_host
from uwspr_tpu_torch.fec.osd import osd_decode
from uwspr_tpu_torch.harness import common, scenes
from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
from uwspr_tpu_torch.protocol.constants import FANO_METTAB, deinterleave
from uwspr_tpu_torch.protocol.fec_encode import bits_to_bytes
from uwspr_tpu_torch.protocol.messages import pack_message, unpack_message

REFERENCE = "OSD_CALIB.json"
ORDER, TRIALS, SEED_BASE = 3, 25, 31000
SNRS = [-29.0, -30.0, -31.0, -32.0, None]
TRUE_PAYLOAD = bytes(np.asarray(pack_message(*scenes.MESSAGE))[:7])
EXACT_FIELDS = ("correct", "unpack", "flips", "agree2")
CLOSE_FIELDS = ("quality", "margin", "sync2")
CLOSE_TOL = 1e-3


def failed_lanes(wd: WindowDecoder, z: np.ndarray):
    """WindowDecoder's decode up to the Fano stage (pipeline/decoder.py:
    114-150); yields (c, j, j2, soft_best, soft_second, sync2[c, j]) per
    worth candidate whose every gated lane failed, j and j2 its two
    best-synced gated jiggle lanes (j2 -1 and soft_second None without a
    second)."""
    cfg = wd.config
    with torch.no_grad(), exact_f32():
        cands = wd.coarse(z)
        if cands.n == 0:
            return
        ref = wd.fine.refine(z, cands)
        if not ref.worth_a_try.any():
            return
        symbols, sync2, rms = wd.fine.soft_symbols(z, cands, ref)
    C, J, _ = symbols.shape
    gate = (ref.worth_a_try[:, None]
            & (sync2 > cfg.demod.minsync2)
            & (rms > cfg.demod.minrms))
    flat_syms = deinterleave(symbols.reshape(C * J, 162))
    active = gate.reshape(C * J)
    if not active.any():
        return
    success, *_ = fano_decode_batch_host(
        flat_syms, active, backend=cfg.fano_backend, device=wd.device,
        mettab=FANO_METTAB, delta=cfg.demod.fano_delta,
        maxcycles=cfg.demod.maxcycles)
    success = success.reshape(C, J) & gate
    for c in range(C):
        if not ref.worth_a_try[c] or success[c].any() or not gate[c].any():
            continue
        order = np.argsort(np.where(gate[c], sync2[c], -np.inf))[::-1]
        j = int(order[0])
        j2 = int(order[1]) if len(order) > 1 and gate[c, order[1]] else -1
        yield (c, j, j2, flat_syms[c * J + j],
               flat_syms[c * J + j2] if j2 >= 0 else None,
               float(sync2[c, j]))


def rows_for(wd: WindowDecoder, snr, t: int, order: int,
             seed_base: int) -> list:
    rows = []
    for c, j, j2, soft, soft2, s2 in failed_lanes(
            wd, scenes.osd_trial(snr, t, seed_base)):
        r = osd_decode(soft, order=order)
        pl = bytes(bits_to_bytes(r.info_bits)[:7])
        agree2 = None
        if soft2 is not None:
            r2 = osd_decode(soft2, order=order)
            agree2 = bytes(bits_to_bytes(r2.info_bits)[:7]) == pl
        rows.append({"snr": snr, "trial": t, "cand": c,
                     "correct": pl == TRUE_PAYLOAD,
                     "unpack": unpack_message(pl) is not None,
                     "quality": round(r.quality, 4),
                     "margin": round(r.margin, 5), "flips": r.flips,
                     "sync2": round(s2, 4), "agree2": agree2})
    return rows


def compare(rows: list, ref_rows: list) -> dict:
    """The rows against the reference's: the (snr, trial, cand) sets equal,
    EXACT_FIELDS equal and CLOSE_FIELDS within CLOSE_TOL on each row."""
    def key(r):
        return (r["snr"], r["trial"], r["cand"])
    mine = {key(r): r for r in rows}
    ref = {key(r): r for r in ref_rows}
    differ = []
    for k in sorted(set(mine) & set(ref), key=str):
        a, b = mine[k], ref[k]
        bad = [f for f in EXACT_FIELDS if a[f] != b[f]] + [
            f for f in CLOSE_FIELDS if abs(a[f] - b[f]) > CLOSE_TOL]
        if bad:
            differ.append({"row": list(k), "fields": bad,
                           "port": {f: a[f] for f in bad},
                           "reference": {f: b[f] for f in bad}})
    only_port = sorted((list(k) for k in set(mine) - set(ref)), key=str)
    only_ref = sorted((list(k) for k in set(ref) - set(mine)), key=str)
    return {"rows": len(rows), "reference_rows": len(ref_rows),
            "only_port": only_port, "only_reference": only_ref,
            "differ": differ, "close_tol": CLOSE_TOL,
            "pass": not (only_port or only_ref or differ)}


def summary(rows: list) -> dict:
    """osd_calibrate.py's closing table: quality and margin percentiles
    (5, 50, 95) and the agree2 share of correct, wrong-but-unpacking and
    wrong decodes."""
    out = {}
    for label, sel in (
            ("correct", [x for x in rows if x["correct"]]),
            ("wrong+unpack", [x for x in rows
                              if not x["correct"] and x["unpack"]]),
            ("wrong", [x for x in rows if not x["correct"]])):
        if not sel:
            out[label] = None
            continue
        a = [x["agree2"] for x in sel if x["agree2"] is not None]
        out[label] = {
            "n": len(sel),
            "quality_p5_p50_p95": np.percentile(
                [x["quality"] for x in sel], [5, 50, 95]).tolist(),
            "margin_p5_p50_p95": np.percentile(
                [x["margin"] for x in sel], [5, 50, 95]).tolist(),
            "agree2": float(np.mean(a)) if a else None, "agree2_of": len(a)}
    return out


def main(argv=None) -> int:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--order", type=int, default=ORDER)
    p.add_argument("--trials", type=int, default=TRIALS)
    p.add_argument("--seed-base", type=int, default=SEED_BASE)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    wd = WindowDecoder(PipelineConfig(demod=DemodConfig()), device=device)
    rows = []
    for snr in SNRS:
        t0 = time.perf_counter()
        for t in range(args.trials):
            rows += rows_for(wd, snr, t, args.order, args.seed_base)
        common.log(f"snr={snr}: {sum(1 for x in rows if x['snr'] == snr)} "
                   f"failed lanes, {time.perf_counter() - t0:.1f} s")
    record = {**common.record_head("osd_calibrate", REFERENCE, device),
              "order": args.order, "trials": args.trials,
              "seed_base": args.seed_base, "summary": summary(rows),
              "rows": rows}
    common.log(json.dumps(record["summary"]))
    if (args.order, args.trials, args.seed_base) == (ORDER, TRIALS,
                                                     SEED_BASE):
        record["vs_reference"] = {"rows": compare(
            rows, common.load_record(REFERENCE)["rows"])}
    return common.finish(record, args.out, "osd_calibrate")


if __name__ == "__main__":
    sys.exit(main())
