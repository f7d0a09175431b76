"""The port's result harnesses: the counterparts of the reference's
``bench.py`` and ``scripts/`` harnesses that write its records.

One module per harness, each run as

    python -m uwspr_tpu_torch.harness.<name> [--device cuda|cpu]

``bench`` (bench.py's JSON line), ``matrix`` (scripts/bench_matrix.py),
``sweeps`` (scripts/sweep_r05_artifact.py), ``osd_sweeps``
(scripts/sweep_osd_artifact.py and scripts/sweep_osd_device_artifact.py),
``multipass`` (scripts/multipass_artifact.py), ``ring_ingest``
(scripts/bench_ring_ingest.py) and ``osd_calibrate``
(scripts/osd_calibrate.py). Each writes ``torch_results/<name>.json``: the
card's name and power limit, the port's rows, and a ``vs_reference`` block
that holds each decode rate against the reference's record point by point
(``common.vs_reference``). ``scenes`` builds every scene they decode,
bitwise equal to the reference's windows. The harnesses run on the card
unless the caller passes ``--device cpu``; nothing falls back.
"""
