"""Stage markers of the device decode: an empty kernel a stage
(``csrc/marks.cu``), launched at the start of each stage.

Not a TPU kernel: a device trace of the JAX program names XLA's fusions,
while a trace of the port's captured graph holds nothing but its kernels.
A graph captured from one stream is a chain, so in a ``torch.profiler``
trace of a replay the kernels between ``uwspr_mark_<X>`` and the next
marker belong to stage X, on the device trace's own clock, and line up
with the host's ``uwspr.*`` spans (``utils/profiler.py::span``).
``uwspr_mark_end`` follows the packed output. The stages, in order:

- ``stft``: the STFT power;
- ``coarse``: the smoothed spectrum, the peak pick and the sync grid;
- ``select``: the model selection and its index arithmetic;
- ``compact``: the candidate compaction, or the uncompacted lane
  flattening;
- ``refine``: the phase A/B probes;
- ``prefano_tail``: the fine grid, soft symbols, gates and deinterleave;
- ``fano1``, ``fano2``: the Fano's two phases (``fano2`` where J > 1);
  where one launch walks every jiggle (fano_compact_lanes > 0) ``fano1``
  holds the whole walk and ``fano2`` the first-success selection after
  it;
- ``osd``: the device OSD (osd_depth > 0);
- ``subtract``: the multipass subtraction after each pass but the last
  (``MultipassConfig.passes`` > 1): the compaction of the pass's new
  decodes and the subtraction kernel; the next pass then opens with its
  own ``stft`` marker, so a multipass replay holds the markers from
  ``stft`` to ``subtract`` once a pass (``osd`` to ``subtract`` not in
  the last) and ``pack`` and ``end`` once;
- ``pack``: the packed output;
- ``end``.

A marker is a one-thread kernel that does nothing. The markers are always
on: a single-pass replay holds about eleven more kernel nodes. On a CPU
tensor ``mark`` does nothing.
"""

from __future__ import annotations

import torch

from uwspr_tpu_torch.utils import cuda_build

STAGES = ("stft", "coarse", "select", "compact", "refine", "prefano_tail",
          "fano1", "fano2", "osd", "subtract", "pack", "end")
_INDEX = {s: i for i, s in enumerate(STAGES)}


def mark(stage: str, x: torch.Tensor) -> None:
    """Launch ``stage``'s marker on ``x``'s device and current stream (a
    capture records it into the graph); nothing for a CPU tensor. Raises
    KeyError for a stage not in STAGES."""
    i = _INDEX[stage]
    if x.device.type != "cuda":
        return
    code = cuda_build.load_library().uwspr_mark(
        i, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch("uwspr_mark", code)


__all__ = ["STAGES", "mark"]
