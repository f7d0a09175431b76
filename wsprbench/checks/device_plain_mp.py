"""Reference ``device_plain_mp``: one checked batch of the device engine
with its multipass on (``multipass.passes`` P > 1, the OSD on) held
against the plain reference's passes on the batch's input, and the
numbers ``compare`` holds to their limits.

Pass 1 is ``device_plain_osd``'s reference on every window of the batch
(the plain prefano, the plain Fano at the configuration's budget, the
rescue with the plain OSD). After each pass but the last, as the
configuration's guarantees state: the pass's decodes, less those whose
payload an earlier pass reported in the same window within
``DUP_FREQ_HZ`` (duplicates, not reported), are taken window-major, the
first ``subtract_max_lanes`` of them subtracted from a complex64 copy of
their windows with the plain subtraction (``reference/subtract.py``; a
window's frames in order, each from the residual of the ones before it;
its lag the decode's shift plus its jiggle's offset 0, -8, +8, -16, ...
in samples), the rest counted in their windows' overflow; the next pass
runs the same reference on the residual, with the candidates of the
windows where nothing was subtracted marked invalid before its lanes are
picked, so that it decodes only the windows that changed.

The numbers are ``device_plain_osd.numbers`` over all P * C slots of every
window (slot p * C + c is pass p's candidate c): ``spots_differ`` also
counts a slot decoded on both sides whose OSD tag or pass differs;
``counts_differ`` holds each window's fano_attempts and fano_overflow,
summed over the passes, with the rescue's dropped lanes and the frames
over the subtraction cap in the overflow."""

from __future__ import annotations

import copy

import numpy as np
import torch

from wsprbench.checks import device_plain as base
from wsprbench.checks import device_plain_osd as osd_check
from wsprbench.reference import protocol as P
from wsprbench.reference import subtract as plain_sub
from wsprbench.reference.decode import PlainDecoder, outputs, to_numpy
from wsprbench.reference.fano import decode_gated

# the fields of the prefano that lie per slot, joined over the passes
_SLOT_FIELDS = ("valid", "snr", "freq", "shift", "drift", "mode",
                "slm_params", "worth", "sync2", "gate", "deint")
_REF_FIELDS = ("success", "payload", "jiggle", "sync", "osd")
# a later decode of an earlier payload in its window within this many Hz is
# a duplicate, as the configuration's guarantees state
DUP_FREQ_HZ = 5.0


class _WindowsDecoder(PlainDecoder):
    """The plain decoder with the candidates of the windows outside
    ``windows`` marked invalid after the coarse search."""

    def __init__(self, *a, windows=None, **k):
        super().__init__(*a, **k)
        self.windows = windows

    def coarse(self, ri):
        co = super().coarse(ri)
        if self.windows is not None:
            keep = torch.as_tensor(self.windows, device=co["valid"].device)
            co["valid"] = co["valid"] & keep[:, None]
        return co


def one_pass(pipeline: dict, ri: np.ndarray, device, prec: str, procs,
             windows) -> tuple[dict, dict]:
    """``device_plain_osd.reference`` on (W, 2, fl) windows with the
    candidates of the windows outside ``windows`` (None: all) invalid."""
    fano_only = copy.deepcopy(pipeline)
    fano_only["demod"]["osd_depth"] = 0
    d = pipeline["demod"]
    dec = _WindowsDecoder(fano_only, ri.shape[0], device, prec,
                          windows=windows)
    pre = to_numpy(dec.prefano(torch.as_tensor(ri, device=device)))
    del dec
    lanes = decode_gated(pre["gate"], pre["deint"], P.METTAB,
                         d["fano_delta"], d["maxcycles"], procs)
    return pre, osd_check.rescue(pre, outputs(pre, lanes), d)


def jiggle_offsets(n: int, iifac: int) -> np.ndarray:
    """The retry lags 0, -iifac, +iifac, -2 iifac, ... in samples."""
    k = (np.arange(n) + 1) // 2
    return np.where(np.arange(n) % 2 == 1, -k, k) * iifac


def duplicates(pre: dict, ref: dict, earlier: list, tol: float):
    """(W, C) bool: decodes whose payload an earlier pass reported in the
    window with a frequency within tol Hz (the gap in float64)."""
    W, C = ref["success"].shape
    dup = np.zeros((W, C), bool)
    for e_pre, e_ref in earlier:
        same = (ref["payload"][:, :, None, :]
                == e_ref["payload"][:, None, :, :]).all(axis=-1)
        near = np.abs(pre["freq"].astype(np.float64)[:, :, None]
                      - e_pre["freq"].astype(np.float64)[:, None, :]) < tol
        dup |= (same & near & e_ref["success"][:, None, :]).any(axis=2)
    return dup & ref["success"]


def subtract_pass(z: np.ndarray, pre: dict, ref: dict, pipeline: dict,
                  phase: str):
    """Subtract the pass's decodes from the complex64 windows z in place:
    -> (windows where something was subtracted (W,), frames over the cap
    (W,))."""
    mp, d = pipeline["multipass"], pipeline["demod"]
    W, C = ref["success"].shape
    lanes = np.flatnonzero(ref["success"].reshape(-1))     # window-major
    cap = int(mp["subtract_max_lanes"]) or W * C
    taken, over = lanes[:cap], lanes[cap:]
    jig = jiggle_offsets(d["n_jiggles"], d.get("iifac", 8))
    cf = float(pipeline["coarse"]["cf"])
    for lane in taken:
        w, c = divmod(int(lane), C)
        z[w] = plain_sub.subtract(
            z[w], ref["payload"][w, c].tobytes(), float(pre["freq"][w, c]),
            int(pre["shift"][w, c]) + int(jig[ref["jiggle"][w, c]]),
            int(pre["mode"][w, c]), float(pre["drift"][w, c]),
            pre["slm_params"][w, c], cf, phase=phase)
    done = np.zeros(W, np.int64)
    np.add.at(done, taken // C, 1)
    capped = np.zeros(W, np.int64)
    np.add.at(capped, over // C, 1)
    return done > 0, capped


def reference(pipeline: dict, ri: np.ndarray, device, prec: str = "stated",
              procs: int | None = None, phase: str = "f64"
              ) -> tuple[dict, dict]:
    """(W, 2, fl) float32 -> (the prefano fields and the decoded fields of
    every pass, joined slot p * C + c, each numpy; the overflow and dropped
    lanes summed over the passes)."""
    P_ = int(pipeline["multipass"]["passes"])
    tol = DUP_FREQ_HZ
    z = (ri[:, 0] + 1j * ri[:, 1]).astype(np.complex64)
    windows = None
    passes = []
    overflow = np.zeros(ri.shape[0], np.int64)
    for p in range(P_):
        cur = np.stack([z.real, z.imag], axis=1).astype(np.float32)
        pre, ref = one_pass(pipeline, cur, device, prec, procs, windows)
        if passes:
            ref["success"] = ref["success"] & ~duplicates(pre, ref, passes,
                                                          tol)
        overflow += pre["overflow"]
        if p < P_ - 1:
            windows, capped = subtract_pass(z, pre, ref, pipeline, phase)
            overflow += capped
        passes.append((pre, ref))
    pres = [p for p, _ in passes]
    refs = [r for _, r in passes]
    pre = {k: np.concatenate([p[k] for p in pres], axis=1)
           for k in _SLOT_FIELDS}
    pre["overflow"] = overflow
    ref = {k: np.concatenate([r[k] for r in refs], axis=1)
           for k in _REF_FIELDS}
    ref["dropped"] = sum(r["dropped"] for r in refs)
    C = pres[0]["valid"].shape[1]
    ref["pass_index"] = np.broadcast_to(
        np.arange(P_ * C) // C, ref["success"].shape).copy()
    return pre, ref


def numbers(prog: dict, pre: dict, ref: dict, sample: np.ndarray) -> dict:
    """``device_plain_osd.numbers``, plus the pass of a slot decoded on
    both sides in ``spots_differ``."""
    n = osd_check.numbers(prog, pre, ref, sample)
    both = prog["success"][sample] & ref["success"][sample]
    n["spots_differ"] += int((both & (prog["pass_index"][sample]
                                      != ref["pass_index"][sample])).sum())
    return n


def as_program(pre: dict, ref: dict) -> dict:
    """``device_plain_osd.as_program`` with each slot's pass."""
    out = osd_check.as_program(pre, ref)
    out["pass_index"] = ref["pass_index"]
    return out


def run(r, out, ri: np.ndarray, sample: np.ndarray) -> None:
    """Check one batch of run ``r``: its typed output ``out`` against the
    reference's passes on its input ``ri``; sets ``r.check`` and
    ``r.checked``."""
    prog = base.program_fields(out)
    prog["osd"] = np.asarray(out.osd)
    C = prog["success"].shape[1] // int(
        r.config["pipeline"]["multipass"]["passes"])
    prog["pass_index"] = (np.asarray(out.pass_index)
                          if getattr(out, "pass_index", None) is not None
                          else np.zeros_like(prog["jiggle"]))
    pipeline = r.config["pipeline"]
    pre, ref = reference(pipeline, ri, r.device)
    if prog["success"].shape != ref["success"].shape:
        raise ValueError(f"the program's output has {prog['success'].shape} "
                         f"slots, the reference {ref['success'].shape} "
                         f"({C} candidates a pass)")
    r.check = numbers(prog, pre, ref, sample)
    r.checked = {"prog": prog, "ri": ri, "sample": sample, "pre": pre,
                 "ref": ref, "pipeline": pipeline}


def control(r, procs: int | None = None) -> dict:
    """The numbers of the control: the reference one precision step below
    the configuration's (the prefano's points, and the subtraction's
    replica phase summed in float32), its passes included, put in the
    program's place on run ``r``'s checked batch."""
    c = r.checked
    pre, ref = reference(c["pipeline"], c["ri"], r.device, prec="below",
                         procs=procs, phase="f32")
    return numbers(as_program(pre, ref), c["pre"], c["ref"], c["sample"])


