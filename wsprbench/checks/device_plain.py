"""Reference ``device_plain``: one checked request of the device engine
(``DeviceDecoder`` or the ring beneath ``RingServe``, ``osd_depth`` 0) held
against the plain reference (or its lower-precision control) run on the
request's input, and the numbers ``compare`` holds to their limits. Runs
once the window has closed and the program is freed.

A configuration names its reference (``"reference"``); the drivers call the
named module's ``run`` and the readings its ``control``, so a reference of
other semantics is a new file in ``wsprbench/checks/``."""

from __future__ import annotations

import numpy as np
import torch

from wsprbench import compare
from wsprbench.reference import protocol as P
from wsprbench.reference.decode import PlainDecoder, outputs, to_numpy
from wsprbench.reference.fano import decode_gated


def reference(pipeline: dict, ri: np.ndarray, sample: np.ndarray, device,
              prec: str = "stated", procs: int | None = None):
    """(W, 2, fl) float32 -> (prefano fields of every window, the Fano
    outputs of the sampled windows), both numpy."""
    dec = PlainDecoder(pipeline, ri.shape[0], device, prec)
    pre = to_numpy(dec.prefano(torch.as_tensor(ri, device=device)))
    del dec
    d = pipeline["demod"]
    lanes = decode_gated(pre["gate"][sample], pre["deint"][sample],
                         P.METTAB, d["fano_delta"], d["maxcycles"], procs)
    return pre, outputs({k: v[sample] for k, v in pre.items()}, lanes)


def as_program(pre: dict, ref: dict, sample: np.ndarray) -> dict:
    """A reference run laid out as the program's typed output, for the
    control that stands in the program's place."""
    W, C = pre["valid"].shape
    out = {k: pre[k] for k in ("valid", "freq", "snr", "shift", "drift",
                               "mode", "slm_params")}
    out["fano_overflow"] = pre["overflow"]
    out["fano_attempts"] = pre["gate"].sum(axis=(1, 2))
    out["success"] = np.zeros((W, C), bool)
    out["payload"] = np.zeros((W, C, 7), np.uint8)
    out["jiggle"] = np.zeros((W, C), np.int64)
    out["sync"] = np.zeros((W, C), np.float32)
    for k in ("success", "payload", "jiggle", "sync"):
        out[k][sample] = ref[k]
    return out


def program_fields(out) -> dict:
    """A DeviceDecoderOutput (leading axis window) as a dict of arrays."""
    keys = ("success", "payload", "freq", "snr", "sync", "shift", "drift",
            "mode", "slm_params", "jiggle", "valid", "fano_overflow",
            "fano_attempts")
    return {k: np.asarray(getattr(out, k)) for k in keys}


def run(r, out, ri: np.ndarray, sample: np.ndarray) -> None:
    """Check one request of run ``r``: its typed output ``out`` against the
    reference on its input ``ri``; sets ``r.check`` (the numbers) and
    ``r.checked`` (what they came from)."""
    prog = program_fields(out)
    pipeline = r.config["pipeline"]
    pre, ref = reference(pipeline, ri, sample, r.device)
    r.check = compare.numbers(prog, pre, ref, sample)
    r.checked = {"prog": prog, "ri": ri, "sample": sample, "pre": pre,
                 "ref": ref, "pipeline": pipeline}


def control(r, procs: int | None = None) -> dict:
    """The numbers of the control: the reference one precision step below
    the configuration's, put in the program's place on run ``r``'s checked
    request."""
    c = r.checked
    pre, ref = reference(c["pipeline"], c["ri"], c["sample"], r.device,
                         prec="below", procs=procs)
    return compare.numbers(as_program(pre, ref, c["sample"]), c["pre"],
                           c["ref"], c["sample"])
