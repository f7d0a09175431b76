"""The comparison that decides ``correct``: what one checked request of the
timed path produced, against the plain reference on the same input.

The numbers, each held to a limit of its own (``limits/<cell>.json``):

- ``spots_differ``: candidate slots of the sampled windows where the
  decoded flag differs, or both decoded and the 7-byte payloads differ
  (the Fano, its two phases and the first-success select);
- ``counts_differ``: windows of the request whose ``fano_attempts`` (gated
  lanes) or ``fano_overflow`` (lanes the caps shed) differ;
- ``fields_differ``: candidate slots of the request where ``valid`` or,
  valid on both sides, the coarse search's and the refinement's discrete
  outcome differs: frequency, lag (shift), drift model (mode, drift, SLM
  parameters); in the sampled windows also the jiggle of a slot decoded
  on both sides;
- ``sync_gap``: the widest |sync| gap over the sampled windows' slots that
  agree in all of the above (the refinement's sync at the chosen jiggle);
- ``snr_gap_db``: the widest |SNR| gap in dB over slots valid on both
  sides (the STFT power and the smoothed spectrum).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

NAMES = ("spots_differ", "counts_differ", "fields_differ", "sync_gap",
         "snr_gap_db")


def numbers(prog: dict, pre: dict, ref: dict, sample: np.ndarray) -> dict:
    """prog: the program's typed output of the request (numpy, leading axis
    window); pre: the reference's prefano fields (numpy); ref: its
    ``outputs`` for the windows ``sample`` (indices into the request)."""
    valid_p, valid_r = prog["valid"], pre["valid"]
    both = valid_p & valid_r
    disc = ((prog["freq"] != pre["freq"]) | (prog["shift"] != pre["shift"])
            | (prog["mode"] != pre["mode"]) | (prog["drift"] != pre["drift"])
            | (prog["slm_params"] != pre["slm_params"]).any(axis=-1))
    slot_bad = (valid_p != valid_r) | (both & disc)
    counts = int(((prog["fano_attempts"] != pre["gate"].sum(axis=(1, 2)))
                  | (prog["fano_overflow"] != pre["overflow"])).sum())

    ps = {k: prog[k][sample] for k in ("success", "payload", "jiggle",
                                       "sync")}
    sp, sr = ps["success"], ref["success"]
    spots = int(((sp != sr) | (sp & sr & (ps["payload"] != ref["payload"])
                               .any(axis=-1))).sum())
    jig_bad = sp & sr & (ps["jiggle"] != ref["jiggle"])
    slot_bad_s = slot_bad[sample] | jig_bad
    fields = int(slot_bad.sum() + jig_bad.sum())
    agree = both[sample] & ~slot_bad_s & (sp == sr)
    sync_gap = float(np.abs(ps["sync"] - ref["sync"])[agree].max()) \
        if agree.any() else 0.0
    snr_gap = float(np.abs(prog["snr"] - pre["snr"])[both].max()) \
        if both.any() else 0.0
    return {"spots_differ": spots, "counts_differ": counts,
            "fields_differ": fields, "sync_gap": sync_gap,
            "snr_gap_db": snr_gap}


def limits(root: pathlib.Path, cell: str) -> dict:
    return json.loads((root / "wsprbench" / "limits" / f"{cell}.json")
                      .read_text())


def judge(nums: dict, lim: dict) -> tuple[bool, dict]:
    """-> (every number within its limit, {name: {value, limit}})."""
    shown = {k: {"value": nums[k], "limit": lim[k]} for k in NAMES}
    return all(nums[k] <= lim[k] for k in NAMES), shown
