"""Driver loop ``decode_batches_mp``: ``decode_batches``' loop, loaded from
its file and run as it is, with the device OSD's tally and the multipass
tally of the decoder that loop builds put into ``r.counters`` once the
loop, its window and its check are done.

The loop keeps no handle on its decoder, so the constructor of
``DeviceDecoder`` is wrapped for the length of the run and keeps the
decoder's tally tensors alone (the decoder is freed as the loop frees
it). Both tallies are summed on the card inside every decode, warm-up and
capture included, and read here with one sync each: ``osd_<name>`` for
each name of ``device_decoder.OSD_TALLY`` and ``mp_<name>`` for each of
the decoder's ``mp_names`` (``mp_decodes`` the decodes it covers). A
program without a tally gives no such counter, and its readers return
None."""

from __future__ import annotations


def run(r) -> None:
    from uwspr_tpu_torch.pipeline import device_decoder as dd
    from wsprbench.run import load_module
    loop = load_module(r.root / "wsprbench" / "drivers" / "decode_batches.py")
    kept, init = [], dd.DeviceDecoder.__init__
    osd_names = getattr(dd, "OSD_TALLY", None)

    def keeping(self, *a, **k):
        init(self, *a, **k)
        for prefix, attr, names in (
                ("osd", "osd_counts", osd_names),
                ("mp", "mp_counts", getattr(self, "mp_names", None))):
            counts = getattr(self, attr, None)
            if counts is not None and names:
                kept.append((prefix, tuple(names), counts))
    dd.DeviceDecoder.__init__ = keeping
    try:
        loop.run(r)
    finally:
        dd.DeviceDecoder.__init__ = init
    totals = {}
    for prefix, names, counts in kept:
        key = (prefix, names)
        totals[key] = totals.get(key, 0) + counts.cpu()
    for (prefix, names), total in totals.items():
        r.counters.update({f"{prefix}_{k}": int(v)
                           for k, v in zip(names, total.tolist())})
