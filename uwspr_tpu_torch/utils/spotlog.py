"""Spot/message logging compatible with the reference's file outputs.

The reference appends decodes to ``messagelog.txt`` (start/handoff/elapsed
times, frame counter, freq/SNR/drift, hex payload —
lib/sync_and_demodulate_impl.cc:97-108,506-526) and maintains
``hashtable.txt`` via the unpacker block. SpotLogger reproduces the
messagelog format closely enough for downstream tooling, plus a structured
JSONL sink for modern consumers.

The port's own copy of uwspr_tpu/utils/spotlog.py (its ``Spot`` is the
port's, uwspr_tpu_torch/pipeline/decoder.py), held equal to it by
tests/test_torch_copies.py.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict

from uwspr_tpu_torch.pipeline.decoder import Spot


class SpotLogger:
    def __init__(self, text_path: str | None = "messagelog.txt",
                 jsonl_path: str | None = None,
                 spots_path: str | None = None,
                 allwspr_path: str | None = None,
                 dial_freq_mhz: float = 0.0):
        self.start = time.time()
        self.framecount = 0
        self.dial_freq_mhz = dial_freq_mhz
        self._text = open(text_path, "a") if text_path else None
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        # wsprd "wspr_spots.txt" format (the file the reference's unpacker
        # opens, WSPR_unpacker_impl.cc:58-67):
        #   YYMMDD HHMM snr dt freq drift message
        self._spots = open(spots_path, "a") if spots_path else None
        # wsprd "ALL_WSPR.TXT" append-only archive (the other file the
        # reference's unpacker opens at the same site): one line per decode
        # with sync quality, metric diagnostics and the RF frequency
        self._allwspr = open(allwspr_path, "a") if allwspr_path else None
        if self._text:
            self._text.write(
                f"Start time: {time.asctime(time.localtime(self.start))}\n\n")
            self._text.flush()

    def log(self, spot: Spot) -> None:
        self.framecount += 1
        if self._text:
            now = time.time()
            dt = int(now - self.start)
            self._text.write(
                f"Handoff time : {time.asctime(time.localtime(now))}\n"
                f"Elapsed time: {dt // 3600:02d}:{(dt // 60) % 60:02d}:"
                f"{dt % 60:02d}\n"
                f"Frame: {self.framecount}\n"
                f"Baseband freq is {spot.freq:2.2f} Hz\n"
                f"(6 Hz) SNR is {spot.snr:2.2f} dB\n")
            if spot.mode == 0:
                self._text.write(f"Linear drift is {spot.drift:2.2f} Hz\n")
            else:
                v = spot.slm_params
                self._text.write(
                    f"Nonlinear drift  V=:({v[0]:2.2f},{v[1]:2.2f}) "
                    f"p=({int(v[2])},{int(v[3])})\n")
            hexmsg = "".join(f"{b:02x}" for b in spot.payload)
            self._text.write(f"Data: {hexmsg}\n\n")
            self._text.flush()
        if self._jsonl:
            d = asdict(spot)
            d["payload"] = spot.payload.hex()
            d.pop("unpacked", None)
            d["time"] = time.time()
            # default=float: slm_params and friends may carry numpy
            # scalars, which json cannot serialize natively
            self._jsonl.write(json.dumps(d, default=float) + "\n")
            self._jsonl.flush()
        if self._spots:
            # dt uses the wsprd convention shared with ALL_WSPR.TXT below:
            # seconds relative to the nominal 2 s frame start.
            t = time.gmtime()
            self._spots.write(
                f"{time.strftime('%y%m%d %H%M', t)} {spot.snr:6.1f} "
                f"{spot.shift / 375.0 - 2.0:5.2f} {spot.freq:10.6f} "
                f"{spot.drift:2.0f}  {spot.message}\n")
            self._spots.flush()
        if self._allwspr:
            # wsprd ALL_WSPR.TXT line: date time sync*10 snr dt freq(MHz)
            # message drift cycles/81 jiggle
            t = time.gmtime()
            rf_mhz = self.dial_freq_mhz + (1500.0 + spot.freq) / 1e6
            self._allwspr.write(
                f"{time.strftime('%y%m%d %H%M', t)} "
                f"{int(10 * spot.sync):3d} {spot.snr:3.0f} "
                f"{spot.shift / 375.0 - 2.0:5.2f} {rf_mhz:11.7f}  "
                f"{spot.message:<22s} {spot.drift:2.0f} "
                f"{spot.fano_cycles // 81:5d} {spot.jiggle:4d}\n")
            self._allwspr.flush()

    def close(self) -> None:
        for f in (self._text, self._jsonl, self._spots, self._allwspr):
            if f:
                f.close()


__all__ = ["SpotLogger"]
