#!/usr/bin/env python3
"""Time the OSD kernel of uwspr_tpu_torch on one CUDA card.

    python3 scripts/torch_osd_kernel.py [--tree PATH] [--out DIR]

Times the public wrapper ``fec.osd_torch.osd_decode_lanes`` of the package
found under ``--tree`` (default: this checkout) on CUDA tensors, so that
two versions of ``csrc/osd.cu`` are compared on one card by running the
script once per tree, in turns (A, B, B, A) within one call.

Inputs, all made from seeds: the rescue lanes of chip_smoke.py's phase 12
(32 windows of "VE3EMB FN25 30" at -30 dB, seed 5, through the tree's
DeviceDecoder at osd_depth 4 under with_serving_defaults(., 32): the
2 x osd_max_lanes lanes and the failed mask it hands the kernel), timed
at order 4; and 64 lanes of codewords with 0 to 15 flipped symbols
(tests/test_torch_osd.py's recipe, seed 1), all active, timed at orders 1
to 4. Each result is held bit for bit to the plain version on the CPU.
The spin-kernel timing and the card line are chip_smoke.py's. Prints the
card's name and power limit, one line per case and a JSON line of all
times; with ``--out`` the JSON is also appended to DIR/osd_kernel.json.
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


def codeword_lanes(n: int = 64, seed: int = 1) -> np.ndarray:
    """n u8 lanes: a random codeword at reliabilities 5 to 100 with 0 to
    15 symbols flipped (tests/test_torch_osd.py::quantized_soft)."""
    from uwspr_tpu_torch.protocol.fec_encode import encode_frame_bits
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cw = encode_frame_bits(rng.integers(0, 2, 50).astype(np.uint8))
        rel = rng.uniform(5, 100, 162)
        soft = np.where(cw, 128 + rel, 128 - rel)
        err = rng.choice(162, int(rng.integers(0, 16)), replace=False)
        soft[err] = 256 - soft[err]
        out.append(np.clip(np.round(soft), 0, 255).astype(np.uint8))
    return np.stack(out)


def rescue_lanes():
    """(lanes, active) as the tree's decoder hands them to the kernel in
    one decode of phase 12's scene. The decode runs under the tree's
    ``captured.eager()``: a first call would run the decode twice (its
    warm-up, then its capture) and a replay would run no Python, so the
    recorder sees the one call only eagerly. A tree older than the
    captured programs decodes eagerly as it is."""
    import contextlib
    import importlib.util

    import torch

    from uwspr_tpu_torch.config import (DemodConfig, PipelineConfig,
                                        with_serving_defaults)
    from uwspr_tpu_torch.pipeline import device_decoder as ddm
    dec = ddm.DeviceDecoder(with_serving_defaults(PipelineConfig(
        demod=DemodConfig(osd_depth=4)), chip_smoke.OSD_WINDOWS),
        device="cuda")
    got = []
    orig = ddm.osd_decode_lanes

    def recording(lanes, G, order, active=None):
        got.append((lanes.clone(), active.clone()))
        return orig(lanes, G, order, active)
    eager = contextlib.nullcontext
    if importlib.util.find_spec("uwspr_tpu_torch.pipeline.captured"):
        from uwspr_tpu_torch.pipeline.captured import eager
    ddm.osd_decode_lanes = recording
    try:
        with eager():
            dec.decode_windows_ri(
                torch.from_numpy(chip_smoke.deep_windows()).cuda())
    finally:
        ddm.osd_decode_lanes = orig
    torch.cuda.synchronize()
    (lanes, active), = got
    return lanes, active, dec._osd_G


def run() -> dict:
    import torch

    from uwspr_tpu_torch.fec import osd_torch
    lanes, active, G = rescue_lanes()
    cw = torch.from_numpy(codeword_lanes()).cuda()
    cases = {f"rescue lanes ({lanes.shape[0]}, {int(active.sum())} "
             f"active), order 4": (lanes, active, 4)}
    for order in (1, 2, 3, 4):
        cases[f"codeword lanes (64, all active), order {order}"] = (
            cw, None, order)
    res = {}
    for name, (x, act, order) in cases.items():
        _, t, outs = chip_smoke.time_turns(
            [("kernel", lambda: osd_torch.osd_decode_lanes(x, G, order,
                                                           act))],
            {"kernel": 10})
        plain = osd_torch.osd_decode_lanes_plain(
            x.cpu(), G.cpu(), order, None if act is None else act.cpu())
        chip_smoke.require(chip_smoke.osd_equal(outs["kernel"], plain),
                           f"{name}: the kernel differs from the plain "
                           f"version")
        res[name] = t["kernel"]
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
    res = run()
    for k, v in res.items():
        print(f"[{tree.name}] osd_decode {k}: "
              f"{', '.join(f'{x:.4f}' for x in v)} ms (turns)", flush=True)
    line = {"tree": str(tree), "card": card, "results": res}
    print(json.dumps(line), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "osd_kernel.json", "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
