#!/usr/bin/env python3
"""Time the selection and Fano kernels of uwspr_tpu_torch on one CUDA card.

    python3 scripts/torch_select_fano_tuning.py [--tree PATH] [--out DIR]

Times the public wrappers ``ops.select.select_best`` and
``fec.fano.fano_decode_batch`` of the package found under ``--tree``
(default: this checkout), so that two checkouts, or two versions of a
kernel, are compared on one card by running the script once per tree, in
turns (A, B, B, A) within one call.

Inputs, all made from seeds: bench.py's scene (seed 0, 128 windows of
"VE3EMB FN25 30" at -18 dB). Selection: the device engine's
(1664, 5, 26, 126) grid of that scene and the host engine's
(200, 5, 26, 126) grid of its first window, and both shapes all NaN (no
group can accept, so the extremes pass is timed alone). Fano at
maxcycles 10,000: the device engine's phase-1 call (every candidate's
jiggle-0 lane, active the gate), its phase-2 call (the other jiggles, none
active on this scene: the launch and the prologue alone), a block of 128
lanes of uniform noise that all run the full budget, and a mixed chunk of
192 clean lanes and 64 such timeouts. The
inputs, the spin-kernel timing and the card line are chip_smoke.py's.
Prints the card's name and power limit, one line per shape and a JSON
line of all times; with ``--out`` the JSON is also appended to
DIR/select_fano.json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (imports no package at import time)


def turns(fns: dict, n: int) -> dict:
    """{name: [ms of each turn]} over turns A B .. B A, after a warm-up."""
    _, t, _ = chip_smoke.time_turns(list(fns.items()), {k: n for k in fns})
    return t


def inputs() -> dict:
    """Selection grids and Fano chunks as CUDA tensors, by name."""
    import torch

    from uwspr_tpu_torch.config import PipelineConfig, with_serving_defaults
    from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    from uwspr_tpu_torch.protocol.constants import FANO_METTAB
    n = chip_smoke.N_WINDOWS
    ri = chip_smoke.make_windows(n)
    ri_c = torch.from_numpy(ri).cuda()
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), n),
                        device="cuda")
    with torch.no_grad():
        grid = dec.coarse_grid(torch.complex(ri_c[:, 0], ri_c[:, 1]))["grid"]
        pre = dec.prefano(ri_c)
    thr = float(dec.config.coarse.threshold)
    hgrid, h_nl = chip_smoke.host_grid(
        WindowDecoder(PipelineConfig(), device="cuda"), ri)
    sel = {"device (1664 lanes)": (
               grid.reshape((-1,) + grid.shape[2:]).contiguous(),
               dec.state["is_nl"], thr),
           "host (200 lanes)": (hgrid, h_nl, thr)}
    for name, (g, nl, t) in list(sel.items()):
        sel[f"{name}, all NaN (extremes alone)"] = (
            torch.full_like(g, float("nan")), nl, t)
    gate, deint = pre["gate"], pre["deint"]
    n1 = gate.shape[0] * gate.shape[1]
    rng = np.random.default_rng(23)
    timeouts = chip_smoke.fano_lanes(rng, 128, None)
    mixed = np.concatenate([chip_smoke.fano_lanes(rng, 192, 10.0),
                            chip_smoke.fano_lanes(rng, 64, None)])
    # phase 2 of this scene has no lane active: every jiggle-0 lane the
    # gate passes decodes, so the call is the launch and the prologue
    fano = {
        f"phase-1 call ({n1} lanes)": (
            deint[:, :, 0].reshape(-1, 162).contiguous(),
            gate[:, :, 0].reshape(-1).contiguous()),
        f"phase-2 call ({n1 * (gate.shape[2] - 1)} lanes, none active)": (
            deint[:, :, 1:].reshape(-1, 162).contiguous(),
            torch.zeros(n1 * (gate.shape[2] - 1), dtype=torch.bool,
                        device=gate.device)),
        "all-timeout block (128 lanes)": (torch.from_numpy(timeouts).cuda(),
                                          None),
        "mixed chunk (192 clean + 64 timeouts)": (
            torch.from_numpy(mixed).cuda(), None),
    }
    return {"select": sel, "fano": fano,
            "mettab": torch.from_numpy(FANO_METTAB).cuda(),
            "maxcycles": dec.config.demod.maxcycles}


def fano_reps(name: str) -> int:
    return 3 if "timeout" in name else 50


def run(inp: dict) -> dict:
    import torch

    from uwspr_tpu_torch.fec import fano
    from uwspr_tpu_torch.ops import select
    res = {}
    for name, (g, nl, thr) in inp["select"].items():
        t = turns({"kernel": lambda: select.select_best(g, nl,
                                                        threshold=thr)}, 50)
        res[f"select_best {name}"] = t["kernel"]
    met, mc = inp["mettab"], inp["maxcycles"]
    for name, (sym, act) in inp["fano"].items():
        t = turns({"kernel": lambda: fano.fano_decode_batch(
            sym, met, act, maxcycles=mc)}, fano_reps(name))
        out = fano.fano_decode_batch(sym, met, act, maxcycles=mc)
        cyc = out["cycles"].to(torch.int64)
        if act is not None:
            cyc = cyc[act] if bool(act.any()) else cyc
        res[f"fano_decode {name}"] = t["kernel"]
        res[f"fano_decode {name} cycles sum, max"] = [int(cyc.sum()),
                                                      int(cyc.max())]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose uwspr_tpu_torch is timed")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card, _ = chip_smoke.phase_device()    # exits when there is no card
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import uwspr_tpu_torch
    pkg = pathlib.Path(uwspr_tpu_torch.__file__).resolve().parent
    if pkg.parent != tree:
        raise SystemExit(f"imported {pkg}, not the one under {tree}")
    inp = inputs()
    res = run(inp)
    for k, v in res.items():
        print(f"[{tree.name}] {k}: {v}", flush=True)
    line = {"tree": str(tree), "card": card, "results": res}
    print(json.dumps(line), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "select_fano.json", "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
