#!/usr/bin/env python3
"""Frames decoded with the device OSD on and off, each spot held to the
message sent.

    python3 scripts/torch_osd_decodes.py [--seed N] [--batches B] \
        [--orders 4 ...] [--device cuda|cpu] [--out DIR]

from the root of a checkout. Makes the benchmark's ``cycle_deep`` traffic
(``wsprbench/traffic/cycle_deep.json``: batches of 32 cycle-aligned
windows, one frame each at -30 dB) from the seed and decodes its first B
batches through ``DeviceDecoder`` at the ``narrowband_osd`` configuration
(``wsprbench/configs/``: the Fano at 500 cycles a bit, then the OSD) under
the serving defaults, at each OSD order of ``--orders`` (default: the
configuration's) and with ``osd_depth`` 0. The message each window was
sent is read from the frames the generator synthesises: ``gen.synth_frames``
is wrapped while the traffic is made, and each frame's channel symbols are
looked up in ``gen.message_table``. Prints the card's name and power limit
and one JSON line: for each setting the windows, the frames decoded (the
sent message among the window's spots), the spots, the wrong spots (a
message not sent in the window), the OSD-tagged spots and the wrong ones
among them, each also per 32 windows, and the OSD tally; with the OSD on,
``lanes``: every candidate the rescue decoded, with its window, quality,
margin, cross-jiggle agreement, whether it was accepted, and whether its
message is the one sent. Those come from the benchmark's plain rescue
(``wsprbench/checks/device_plain_osd.py``) run on the fields the
decoder's rescue was handed, so that setting decodes eagerly
(``captured.eager()``), and ``lanes_equal`` says whether the plain
rescue accepted the very candidates the decoder tagged. With ``--out`` the
line is also appended to DIR/osd_decodes.jsonl. On the CPU keep B small
and the budget low (``--maxcycles``): the plain Fano walks every failed
lane to its end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def traffic_and_sent(traffic: dict, seed: int, device) -> tuple:
    """(the generator's pool, the message text of each window): the frames
    the generator hands to ``gen.synth_frames`` are recorded, and each
    one's channel symbols looked up in the message table."""
    from wsprbench import gen
    if traffic["signals"] != 1:
        raise ValueError("one signal a window")
    texts, _, syms = gen.message_table()
    text_of = {row.tobytes(): t for row, t in zip(syms, texts)}
    drawn, synth = [], gen.synth_frames

    def recording(symbols, *a, **k):
        drawn.extend(text_of[row.tobytes()] for row in np.asarray(symbols))
        return synth(symbols, *a, **k)
    gen.synth_frames = recording
    try:
        pool = gen.generate(traffic, seed, device)["pool"]
    finally:
        gen.synth_frames = synth
    if len(drawn) != pool.shape[0] * pool.shape[1]:
        raise RuntimeError(f"{len(drawn)} frames synthesised for "
                           f"{pool.shape[0] * pool.shape[1]} windows")
    return pool, drawn


def pipeline_config(fields: dict, **demod):
    from uwspr_tpu_torch.config import PipelineConfig
    base = PipelineConfig()
    parts = {k: dataclasses.replace(getattr(base, k), **v)
             for k, v in fields.items()}
    parts["demod"] = dataclasses.replace(parts["demod"], **demod)
    return dataclasses.replace(base, **parts)


def rescued(fields: list, demod: dict) -> dict:
    """The plain rescue of the recorded ``_osd_rescue`` fields of one
    decode (prefano fields and the Fano's results, numpy)."""
    from wsprbench.checks.device_plain_osd import rescue
    pre, succ, payload, jbest = fields
    fano = {"success": succ & pre["worth"], "payload": payload,
            "jiggle": jbest}
    return rescue(pre, fano, demod)


def decode(cfg, pool, sent, device) -> dict:
    import contextlib
    from uwspr_tpu_torch.config import with_serving_defaults
    from uwspr_tpu_torch.pipeline import captured
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    from uwspr_tpu_torch.protocol.messages import unpack_message
    B, W = pool.shape[:2]
    dec = DeviceDecoder(with_serving_defaults(cfg, W), device=device)
    d = cfg.demod
    osd_on = d.osd_depth > 0
    kept = []
    if osd_on:
        rescue = dec._osd_rescue

        def recording(pre, *a):
            kept.append(({k: pre[k].cpu().numpy() for k in (
                "gate", "worth", "sync2", "deint")},
                *(x.cpu().numpy() for x in a)))
            return rescue(pre, *a)
        dec._osd_rescue = recording
    n = {"windows": B * W, "frames": 0, "spots": 0, "wrong": 0, "osd": 0,
         "osd_wrong": 0}
    demod = {k: getattr(d, k) for k in (
        "osd_depth", "osd_max_lanes", "osd_min_quality", "osd_min_margin",
        "osd_margin_agree")}
    lanes, equal = [], True
    for b in range(B):
        with captured.eager() if osd_on else contextlib.nullcontext():
            out = dec.fetch(dec.decode_windows_ri(pool[b]))
        if osd_on:
            ref = rescued(kept.pop(), demod)
            equal &= bool((ref["osd"] == out.osd).all())
            for w, c in zip(*np.nonzero(~np.isnan(ref["quality"]))):
                u = unpack_message(bytes(ref["payload"][w, c]))
                lanes.append({
                    "batch": b, "window": int(w), "candidate": int(c),
                    "quality": float(ref["quality"][w, c]),
                    "margin": float(ref["margin"][w, c]),
                    "agree": bool(ref["agree"][w, c]),
                    "accepted": bool(ref["osd"][w, c]),
                    "message": u.text if u is not None else None,
                    "sent": u is not None and u.text == sent[b * W + w]})
        for w in range(W):
            spots = dec.spots(out.window(w))
            want = sent[b * W + w]
            n["frames"] += any(s.message == want for s in spots)
            for s in spots:
                n["spots"] += 1
                n["wrong"] += s.message != want
                n["osd"] += s.osd > 0
                n["osd_wrong"] += s.osd > 0 and s.message != want
    n.update({f"{k}_per_32": v * 32 / (B * W) for k, v in list(n.items())
              if k != "windows"})
    n["osd_tally"] = dec.osd_tally()
    if osd_on:
        n["lanes_equal"] = equal
        n["lanes"] = lanes
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=4_500_000_001)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--maxcycles", type=int, default=None)
    ap.add_argument("--orders", type=int, nargs="+", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch
    from wsprbench import run as R
    R.set_build_env(ROOT)
    device = torch.device(a.device)
    traffic = R.load_json(ROOT / "wsprbench" / "traffic" / "cycle_deep.json")
    fields = R.load_json(ROOT / "wsprbench" / "configs"
                         / "narrowband_osd.json")["pipeline"]
    pool, sent = traffic_and_sent(traffic, a.seed, device)
    pool = pool[:a.batches]
    budget = {} if a.maxcycles is None else {"maxcycles": a.maxcycles}
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    print(card, flush=True)
    orders = a.orders or [fields["demod"]["osd_depth"]]
    res = {"seed": a.seed, "card": card, "batches": len(pool)}
    for k in orders + [0]:
        res[f"osd_depth_{k}"] = decode(pipeline_config(
            fields, osd_depth=k, **budget), pool, sent, device)
    line = json.dumps(res)
    print(line, flush=True)
    if a.out:
        d = pathlib.Path(a.out)
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "osd_decodes.jsonl", "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
