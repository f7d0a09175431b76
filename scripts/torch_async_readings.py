#!/usr/bin/env python3
"""bench.py's dispatch pattern on the device engine of any checkout, on one
CUDA card.

    python3 scripts/torch_async_readings.py [--tree PATH] [--out DIR]

Builds ``DeviceDecoder(with_serving_defaults(PipelineConfig(), 128))`` of
the uwspr_tpu_torch package found under ``--tree`` (default: this
checkout) and takes ``chip_smoke.async_readings`` on bench.py's scene
(seed 0, 128 windows of "VE3EMB FN25 30" at -18 dB, resident on the card):
8 batches dispatched back to back, then one synchronize (the host clock at
each return, each batch's CUDA-event time, ms/window), then the idle share
of a torch.profiler trace over 4 back-to-back batches. Two checkouts are
compared on one card by running the script once per tree, in turns
(A, B, B, A) within one call; set UWSPR_TORCH_BUILD_DIR to one directory
so that trees with the same kernel sources share one build.

Prints the card's name and power limit, the readings and a JSON line;
with ``--out`` the JSON is also appended to DIR/async_readings.jsonl.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    # chip_smoke (it imports nothing of the package at import time) from
    # this checkout, the package from the tree
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, str(tree))
    import torch

    import uwspr_tpu_torch
    from uwspr_tpu_torch.config import PipelineConfig, with_serving_defaults
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    pkg = pathlib.Path(uwspr_tpu_torch.__file__).resolve().parents[1]
    if pkg != tree:
        raise RuntimeError(f"imported uwspr_tpu_torch from {pkg}, not {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    n = chip_smoke.N_WINDOWS
    ri_c = torch.from_numpy(chip_smoke.make_windows(n)).cuda()
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), n),
                        device="cuda")
    r = chip_smoke.async_readings(dec, ri_c)
    chip_smoke.log_readings(card, f"tree {tree}", r)
    line = {"tree": str(tree), "card": card, **r}
    print(json.dumps(line), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "async_readings.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
