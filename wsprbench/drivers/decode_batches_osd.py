"""Driver loop ``decode_batches_osd``: ``decode_batches``' loop, loaded
from its file and run as it is, with the device OSD's tally of the decoder
that loop builds put into ``r.counters`` once the loop, its window and its
check are done.

The loop keeps no handle on its decoder, so the constructor of
``DeviceDecoder`` is wrapped for the length of the run and keeps the
decoder's ``osd_counts`` tensor alone (the decoder is freed as the loop
frees it). The tally (``device_decoder.OSD_TALLY``) is summed on the card
inside every decode, warm-up and capture included, and read here with one
sync: ``osd_<name>`` for each name, ``osd_decodes`` the decodes it covers.
A program without the tally gives no such counter, and the readers of the
OSD's counters return None."""

from __future__ import annotations


def run(r) -> None:
    from uwspr_tpu_torch.pipeline import device_decoder as dd
    from wsprbench.run import load_module
    loop = load_module(r.root / "wsprbench" / "drivers" / "decode_batches.py")
    kept, init = [], dd.DeviceDecoder.__init__

    def keeping(self, *a, **k):
        init(self, *a, **k)
        counts = getattr(self, "osd_counts", None)
        if counts is not None:
            kept.append(counts)
    dd.DeviceDecoder.__init__ = keeping
    try:
        loop.run(r)
    finally:
        dd.DeviceDecoder.__init__ = init
    names = getattr(dd, "OSD_TALLY", None)
    if kept and names:
        total = sum(t.cpu() for t in kept)
        r.counters.update({f"osd_{k}": int(v)
                           for k, v in zip(names, total.tolist())})
