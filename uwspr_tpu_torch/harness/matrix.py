"""The port's benchmark matrix (scripts/bench_matrix.py) on one card.

    python -m uwspr_tpu_torch.harness.matrix [--device cuda|cpu]
                                             [--only ROW]

Rows, each at the reference's configuration and scene, with its row keys:

  wideband_multi              halfbandwidth 187, maxfreqs 200, 10 frames a
                              window at -15 dB, 32 windows, untouched
                              wideband serving defaults: 320/320 decoded
  deepsnr_device_full_budget  32 windows at -29, -30 and -31 dB, full Fano
                              budget, serving defaults: the device engine's
                              spot sets equal the hybrid engine's (32/32),
                              decoded within tolerance of the record
  channels_256                256 channels at -18 dB in two 128-window
                              steps: 256/256
  noise_only_serving          128 noise windows: no spot
  dense_deepsnr_serving       3 frames a window at -29 dB, 64 windows,
                              order-3 device OSD: decoded within tolerance
  serve_4096ch_single_chip    4096 channels in 32 steps of 128, a frame in
                              a random eighth of them, synthesised on the
                              card (scenes.serve_4096_scene): 512/512

``--only ROW`` runs one row and merges it into torch_results/matrix.json,
as the reference's ``--only`` does. ``golden_single`` reads a capture that
is not in the repository (examples/VE3EMB.c2); it is refused.

Times are the host clock ending on ``torch.cuda.synchronize()`` and CUDA
events (timed_batch); rt_factor is the real-time factor against one 9 s
hop per window.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import torch

from uwspr_tpu_torch.config import (CoarseConfig, DemodConfig,
                                    PipelineConfig, with_serving_defaults)
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.harness import common, scenes
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder

HOP_S = 9.0
REFERENCE = "BENCH_MATRIX_r05.json"
GOLDEN_REFUSED = ("golden_single decodes examples/VE3EMB.c2 "
                  "(scripts/bench_matrix.py:89-104), a capture that is not "
                  "in the repository; the row waits until it is")
ORDER = ["golden_single", "wideband_multi", "deepsnr_device_full_budget",
         "channels_256", "noise_only_serving", "dense_deepsnr_serving",
         "serve_4096ch_single_chip"]


def _ri(windows, device) -> torch.Tensor:
    return torch.from_numpy(scenes.to_ri(windows)).to(device)


def _times(b: common.Batch, n: int) -> dict:
    return {"ms_per_window": b.seconds / n * 1e3,
            "ms_per_window_events": (None if b.event_seconds is None
                                     else b.event_seconds / n * 1e3),
            "first_decode_s": b.first_seconds,
            "rt_factor": HOP_S * n / b.seconds}


def _reference_row(config: str) -> dict:
    return next(r for r in common.load_record(REFERENCE)["rows"]
                if r["config"] == config)


def row_golden(device):
    raise SystemExit(GOLDEN_REFUSED)


def row_wideband(device, n_windows=32, n_sig=10, snr_db=-15.0,
                 seed=3):
    cfg = with_serving_defaults(PipelineConfig(
        coarse=CoarseConfig(halfbandwidth=187, maxfreqs=200)), n_windows)
    dec = DeviceDecoder(cfg, device=device)
    windows, expected = scenes.wideband_scene(n_windows, n_sig, snr_db, seed)
    b = common.timed_batch(dec, _ri(windows, device))
    typed = dec.unpack_output(b.out)
    found = [set(dec.messages(typed.window(w))) for w in range(n_windows)]
    n_dec = sum(len(found[w] & expected[w]) for w in range(n_windows))
    n_exp = sum(len(e) for e in expected)
    return {"config": "wideband_multi", "halfbandwidth": 187,
            "maxfreqs": 200, "signals_per_window": n_sig, "snr_db": snr_db,
            "windows": n_windows, **_times(b, n_windows),
            "decoded": f"{n_dec}/{n_exp}",
            "decodes_per_s": n_dec / b.seconds,
            "fano_overflow": int(typed.fano_overflow.sum()),
            "exact": {"all_decoded": n_dec == n_exp}}


def row_deepsnr(device, n_windows=32, seed=5):
    cfg = with_serving_defaults(PipelineConfig(), n_windows)
    dev = DeviceDecoder(cfg, device=device)
    hyb = DeviceDecoder(cfg, device=device, fano_mode="host")
    sub, exact, rates = [], {}, {}
    for snr_db, windows in scenes.deepsnr_scenes(n_windows, seed):
        ri = _ri(windows, device)
        b = common.timed_batch(dev, ri)
        typed = dev.unpack_output(b.out)
        dev_msgs = [frozenset(dev.messages(typed.window(w)))
                    for w in range(n_windows)]
        ph = hyb.decode_ri_batch(ri)
        hyb_msgs = [frozenset(hyb.messages(ph.window(w)))
                    for w in range(n_windows)]
        agree = sum(dev_msgs[w] == hyb_msgs[w] for w in range(n_windows))
        ok = sum(scenes.EXPECTED in m for m in dev_msgs)
        p = common.point(snr_db)
        rates[p] = ok / n_windows
        exact[f"spot_sets_agree_{p}"] = agree == n_windows
        sub.append({"snr_db": snr_db, "windows": n_windows,
                    **_times(b, n_windows), "decoded_device": ok,
                    "decoded_hybrid": sum(scenes.EXPECTED in m
                                          for m in hyb_msgs),
                    "spot_set_agreement": f"{agree}/{n_windows}",
                    "gated_fano_lanes": int(typed.fano_attempts.sum()),
                    "fano_overflow": int(typed.fano_overflow.sum())})
        common.log(f"  {snr_db}: {sub[-1]}")
    ref = {common.point(q["snr_db"]): q["decoded_device"] / q["windows"]
           for q in _reference_row("deepsnr_device_full_budget")["points"]}
    return {"config": "deepsnr_device_full_budget",
            "maxcycles": cfg.demod.maxcycles,
            "engine": "device (the Fano kernel) against hybrid (native Fano)",
            "points": sub, "exact": exact,
            "vs_reference": {"decoded_device": common.vs_reference(
                rates, ref, "decoded_device", n_windows)}}


def row_channels(device, n_ch=256, snr_db=-18.0, seed=4,
                 step=128):
    dec = DeviceDecoder(PipelineConfig(demod=DemodConfig(
        probe_dtype="bf16", refine_max_lanes=2 * step,
        fano_compact_lanes=2 * step)), device=device)
    ri = _ri(scenes.channels_scene(n_ch, snr_db, seed), device)
    outs, dts, evs = [], [], []
    for lo in range(0, n_ch, step):
        b = common.timed_batch(dec, ri[lo:lo + step])
        outs.append(b.out)
        dts.append(b.seconds)
        evs.append(b.event_seconds)
    dt = sum(dts)
    typed = dec.unpack_output(torch.cat(outs))
    ok = sum(scenes.EXPECTED in dec.messages(typed.window(w))
             for w in range(n_ch))
    sps = n_ch * 45000.0 / dt
    return {"config": "channels_256", "channels": n_ch, "snr_db": snr_db,
            "decoded": f"{ok}/{n_ch}", "step_seconds": dt,
            "step_seconds_events": (None if None in evs else sum(evs)),
            "window_samples_per_s_per_chip": sps,
            "realtime_channel_capacity": sps / 5000.0,
            "meets_realtime_budget": dt < HOP_S,
            "exact": {"all_decoded": ok == n_ch}}


def row_noise_only(device, n_windows=128, seed=11):
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), n_windows),
                        device=device)
    b = common.timed_batch(dec, _ri(scenes.noise_only_scene(n_windows, seed),
                                    device))
    spots = int(dec.unpack_output(b.out).success.sum())
    return {"config": "noise_only_serving", "windows": n_windows,
            **_times(b, n_windows), "spots_emitted": spots,
            "exact": {"no_spot": spots == 0}}


def row_dense_deepsnr(device, n_windows=64, n_sig=3,
                      snr_db=-29.0, seed=12):
    cfg = with_serving_defaults(PipelineConfig(), n_windows)
    cfg = dataclasses.replace(cfg, demod=dataclasses.replace(
        cfg.demod, osd_depth=3, cand_compact_lanes=4 * n_windows,
        refine_max_lanes=4 * n_windows, osd_max_lanes=128))
    dec = DeviceDecoder(cfg, device=device)
    windows, expected = scenes.dense_deepsnr_scene(n_windows, n_sig, snr_db,
                                                   seed)
    b = common.timed_batch(dec, _ri(windows, device))
    typed = dec.unpack_output(b.out)
    found = [set(dec.messages(typed.window(w))) for w in range(n_windows)]
    n_dec = sum(len(found[w] & expected[w]) for w in range(n_windows))
    n_exp = sum(len(e) for e in expected)
    ref = _reference_row("dense_deepsnr_serving")
    num, den = map(int, ref["decoded"].split("/"))
    return {"config": "dense_deepsnr_serving", "signals_per_window": n_sig,
            "snr_db": snr_db, "windows": n_windows, **_times(b, n_windows),
            "decoded": f"{n_dec}/{n_exp}",
            "fano_overflow": int(typed.fano_overflow.sum()),
            "vs_reference": {"decoded": common.vs_reference(
                {common.point(snr_db): n_dec / n_exp},
                {common.point(ref["snr_db"]): num / den}, "decoded",
                n_exp)}}


def row_serve_4096(device, n_ch=4096, snr_db=-18.0, seed=13,
                   step=128):
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), step),
                        device=device)
    t0 = time.perf_counter()
    scene, emb = scenes.serve_4096_scene(n_ch, snr_db, seed, device=device)
    common.sync(device)
    common.log(f"  synthesised {n_ch} channel windows on {device} in "
               f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dec.decode_windows_ri(scene[:step])
    common.sync(device)
    first = time.perf_counter() - t0
    cuda = device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    outs = [dec.decode_windows_ri(scene[lo:lo + step])
            for lo in range(0, n_ch, step)]
    if cuda:
        end.record()
    common.sync(device)
    dt = time.perf_counter() - t0
    typed = dec.unpack_output(torch.cat(outs))
    ok = sum(scenes.EXPECTED in dec.messages(typed.window(int(w)))
             for w in emb)
    sps = n_ch * 45000.0 / dt
    return {"config": "serve_4096ch_single_chip", "channels": n_ch,
            "frames_embedded": len(emb), "decoded": f"{ok}/{len(emb)}",
            "hop_step_seconds": dt,
            "hop_step_seconds_events": (start.elapsed_time(end) / 1e3
                                        if cuda else None),
            "window_samples_per_s_per_chip": sps,
            "realtime_channel_capacity": sps / 5000.0,
            "meets_realtime_budget": dt < HOP_S,
            "scene": "synthesised on the card (torch.Generator noise, the "
                     "reference's frame placement and 4-FSK modulation)",
            "first_decode_s": first,
            "exact": {"all_decoded": ok == len(emb)}}


ROWS = {"golden_single": row_golden, "wideband_multi": row_wideband,
        "deepsnr_device_full_budget": row_deepsnr,
        "channels_256": row_channels, "noise_only_serving": row_noise_only,
        "dense_deepsnr_serving": row_dense_deepsnr,
        "serve_4096ch_single_chip": row_serve_4096}


def main(argv=None) -> int:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--only", choices=sorted(ROWS),
                   help="run one row and merge it into the record")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    names = [args.only] if args.only else [n for n in ORDER
                                           if n != "golden_single"]
    card = common.card_identity(device)
    rows = []
    for name in names:
        common.log(f"--- {name} ---")
        rows.append({**ROWS[name](device), "card": card})
        print(json.dumps(rows[-1]), flush=True)
    path = pathlib.Path(args.out) / "matrix.json"
    if args.only and path.exists():
        record = json.loads(path.read_text())
        record["rows"] = sorted(
            [r for r in record["rows"] if r["config"] != args.only] + rows,
            key=lambda r: ORDER.index(r["config"]))
    else:
        record = {**common.record_head("matrix", REFERENCE, device),
                  "refused": {"golden_single": GOLDEN_REFUSED},
                  "rows": rows}
    return common.finish(record, args.out, "matrix")


if __name__ == "__main__":
    sys.exit(main())
