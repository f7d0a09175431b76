"""Reference ``device_plain_osd``: one checked batch of the device engine
with its OSD on (``osd_depth`` > 0) held against the plain reference run
on the batch's input, and the numbers ``compare`` holds to their limits.

``device_plain``'s reference up to the Fano (the plain prefano and the
plain Fano at the configuration's budget), on every window of the batch,
since the rescue compacts its lanes over the whole batch; then the rescue
with the plain OSD (``reference/osd.py``): the worth candidates whose gated
lanes all failed the Fano, the first ``osd_max_lanes`` of them in lane
order (window-major), the rest counted in the window's ``fano_overflow``;
each decoded on its two most-synced gated jiggle lanes at order
min(osd_depth, 4); accepted when quality >= osd_min_quality and (margin >=
osd_min_margin, or the two lanes' payloads agree, the candidate has two
gated lanes and margin >= osd_margin_agree), as the port's calibrated rule
states. An accepted candidate decodes with the first lane's payload, at
its jiggle, tagged with the order. The thresholds are read from the
configuration file, in float32 as the program compares them.

The numbers are ``compare.numbers``'s, with ``spots_differ`` also counting
a slot decoded on both sides whose OSD tag differs."""

from __future__ import annotations

import copy

import numpy as np

from wsprbench import compare
from wsprbench.checks import device_plain as base
from wsprbench.reference import osd as plain_osd


def reference(pipeline: dict, ri: np.ndarray, device, prec: str = "stated",
              procs: int | None = None) -> tuple[dict, dict]:
    """(W, 2, fl) float32 -> (the prefano fields of every window, the
    decoded fields of every window after the rescue), both numpy."""
    fano_only = copy.deepcopy(pipeline)
    fano_only["demod"]["osd_depth"] = 0
    every = np.arange(ri.shape[0])
    pre, fano = base.reference(fano_only, ri, every, device, prec, procs)
    return pre, rescue(pre, fano, pipeline["demod"])


def rescue(pre: dict, fano: dict, demod: dict) -> dict:
    """Prefano fields and the Fano's outputs (``decode.outputs``) of every
    window -> success, payload, jiggle, sync (W, C[, 7]), osd (W, C: 0 or
    the order), dropped (W,): the failed candidates beyond the cap, and
    the decoded candidates' quality, margin and agreement (W, C; NaN and
    False where none was decoded)."""
    gate, worth, sync2 = pre["gate"], pre["worth"], pre["sync2"]
    W, C, J = gate.shape
    L = W * C
    gate_f = gate.reshape(L, J)
    fail = worth.reshape(L) & gate_f.any(axis=1) \
        & ~fano["success"].reshape(L)
    skey = np.where(gate_f, sync2.reshape(L, J), -np.inf)
    lanes = np.arange(L)
    j1 = np.argmax(skey, axis=1)                      # first maximum
    skey[lanes, j1] = -np.inf
    j2 = np.argmax(skey, axis=1)                      # the next gated one
    has2 = gate_f.sum(axis=1) >= 2
    failed = np.flatnonzero(fail)
    cap = min(int(demod["osd_max_lanes"]), L)
    taken, over = failed[:cap], failed[cap:]
    order = min(int(demod["osd_depth"]), 4)

    success = fano["success"].reshape(L).copy()
    payload = fano["payload"].reshape(L, 7).copy()
    jiggle = fano["jiggle"].reshape(L).copy()
    osd = np.zeros(L, np.int64)
    quality = np.full(L, np.nan, np.float32)
    margin = np.full(L, np.nan, np.float32)
    agreed = np.zeros(L, bool)
    deint = pre["deint"].reshape(L, J, 162)
    if len(taken):
        a = plain_osd.decode_lanes(deint[taken, j1[taken]], order)
        b = plain_osd.decode_lanes(deint[taken, j2[taken]], order)
        agree = (a["bits"] == b["bits"]).all(axis=1) & has2[taken]
        q, m = a["quality"], a["margin"]
        f32 = np.float32
        ok = (q >= f32(demod["osd_min_quality"])) & (
            (m >= f32(demod["osd_min_margin"]))
            | (agree & (m >= f32(demod["osd_margin_agree"]))))
        quality[taken], margin[taken], agreed[taken] = q, m, agree
        acc = taken[ok]
        success[acc] = True
        payload[acc] = plain_osd.payload(a["bits"][ok])
        jiggle[acc] = j1[acc]
        osd[acc] = order
    dropped = np.zeros(L, np.int64)
    dropped[over] = 1
    jig = jiggle.reshape(W, C)
    wi, ci = np.indices((W, C))
    return {"success": success.reshape(W, C) & worth,
            "payload": payload.reshape(W, C, 7),
            "jiggle": jig, "sync": sync2[wi, ci, jig],
            "osd": osd.reshape(W, C),
            "dropped": dropped.reshape(W, C).sum(axis=1),
            "quality": quality.reshape(W, C),
            "margin": margin.reshape(W, C), "agree": agreed.reshape(W, C)}


def numbers(prog: dict, pre: dict, ref: dict, sample: np.ndarray) -> dict:
    """``compare.numbers`` with the rescue's dropped lanes in the
    reference's overflow, plus the OSD tags of slots decoded on both
    sides in ``spots_differ``."""
    pre = dict(pre, overflow=pre["overflow"] + ref["dropped"])
    n = compare.numbers(prog, pre, {k: ref[k][sample] for k in (
        "success", "payload", "jiggle", "sync")}, sample)
    both = prog["success"][sample] & ref["success"][sample]
    n["spots_differ"] += int((both & (prog["osd"][sample]
                                      != ref["osd"][sample])).sum())
    return n


def as_program(pre: dict, ref: dict) -> dict:
    """A reference run laid out as the program's typed output, for the
    control that stands in the program's place."""
    out = {k: pre[k] for k in ("valid", "freq", "snr", "shift", "drift",
                               "mode", "slm_params")}
    out["fano_overflow"] = pre["overflow"] + ref["dropped"]
    out["fano_attempts"] = pre["gate"].sum(axis=(1, 2))
    for k in ("success", "payload", "jiggle", "sync", "osd"):
        out[k] = ref[k]
    return out


def run(r, out, ri: np.ndarray, sample: np.ndarray) -> None:
    """Check one batch of run ``r``: its typed output ``out`` against the
    reference on its input ``ri``; sets ``r.check`` and ``r.checked``."""
    prog = base.program_fields(out)
    prog["osd"] = np.asarray(out.osd)
    pipeline = r.config["pipeline"]
    pre, ref = reference(pipeline, ri, r.device)
    r.check = numbers(prog, pre, ref, sample)
    r.checked = {"prog": prog, "ri": ri, "sample": sample, "pre": pre,
                 "ref": ref, "pipeline": pipeline}


def control(r, procs: int | None = None) -> dict:
    """The numbers of the control: the reference one precision step below
    the configuration's, its rescue included, put in the program's place
    on run ``r``'s checked batch."""
    c = r.checked
    pre, ref = reference(c["pipeline"], c["ri"], r.device, prec="below",
                         procs=procs)
    return numbers(as_program(pre, ref), c["pre"], c["ref"], c["sample"])
