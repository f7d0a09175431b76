"""Structured per-stage timing — first-class version of the reference's
commented-out wsprd timing accumulator (treadwav/tcandidates/tsync0/1/2/
tfano/ttotal, lib/WSPR_unpacker_impl.cc:68-74) and its ad-hoc wall-clock
prints (lib/sliding_window_stream_to_pdu_impl.cc:79-92).

The port's own copy of uwspr_tpu/utils/timers.py (imports pointed inside
uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageTimers:
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_ms": round(1000 * v / max(self.counts[k], 1), 2)}
                for k, v in sorted(self.totals.items())}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


GLOBAL_TIMERS = StageTimers()

__all__ = ["StageTimers", "GLOBAL_TIMERS"]
