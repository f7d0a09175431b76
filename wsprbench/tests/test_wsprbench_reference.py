"""The plain reference decodes what was sent, its selection is the literal
scan, and its Fano decodes a clean frame and times out on noise."""

from __future__ import annotations

import json

import numpy as np
import torch

from wsprbench import gen
from wsprbench import run as R
from wsprbench.reference import protocol as P
from wsprbench.reference.decode import PlainDecoder, outputs, to_numpy
from wsprbench.reference.fano import decode_gated, fano_lane
from wsprbench.reference.select import select_literal

CPU = torch.device("cpu")


def _pipeline(name: str) -> dict:
    return json.loads((R.ROOT / "wsprbench" / "configs" / f"{name}.json")
                      .read_text())["pipeline"]


def test_reference_decodes_the_sent_messages_on_whole_frames():
    texts, pays, syms = gen.message_table()
    rng = np.random.default_rng(3)
    msgs = [7, 42, 93]
    windows = []
    for m in msgs:
        z = np.zeros(gen.FL, np.complex64)
        f = gen.synth_frames(syms[[m]], np.asarray([rng.uniform(-4, 4)]),
                             CPU)[0].numpy()
        s = int(rng.integers(0, 2000))
        z[s:s + P.FRAME_SAMPLES] = f[0] + 1j * f[1]
        z += gen.noise_sigma(-12.0) * (rng.standard_normal(gen.FL)
                                       + 1j * rng.standard_normal(gen.FL))
        windows.append(np.stack([z.real, z.imag]).astype(np.float32))
    pipe = _pipeline("narrowband")
    dec = PlainDecoder(pipe, len(msgs), CPU)
    pre = to_numpy(dec.prefano(torch.as_tensor(np.stack(windows))))
    lanes = decode_gated(pre["gate"], pre["deint"], P.METTAB, 60, 300,
                         procs=2)
    out = outputs(pre, lanes)
    for w, m in enumerate(msgs):
        got = {bytes(out["payload"][w, c]) for c in
               np.flatnonzero(out["success"][w])}
        assert bytes(pays[m]) in got


def test_selection_is_the_literal_scan():
    rng = np.random.default_rng(0)
    grid = rng.uniform(0.0, 1.0, (6, 5, 3, 7)).astype(np.float32)
    grid[1, 2, 1, 4] = np.nan
    is_nl = np.array([False, False, True, True, True, True, True])
    best, idx = select_literal(grid, is_nl, 1.2)
    for lane in range(grid.shape[0]):
        b, bi = np.float32(-1e30), 0
        for n, v in enumerate(grid[lane].reshape(-1)):
            ok = (np.float32(v / b) > np.float32(1.2)) if is_nl[n % 7] \
                else v > b
            if ok:
                b, bi = v, n
        assert (best[lane], idx[lane]) == (b, bi)


def test_fano_decodes_a_clean_frame_and_times_out_on_noise():
    _, pays, syms = gen.message_table()
    sym = syms[11].astype(np.int64)
    bits = (sym >> 1)[P.INTERLEAVE_PERM]          # coded-bit order
    soft = np.where(bits == 1, 255, 0)
    ok, data = fano_lane(soft, P.METTAB, 60, 10000)
    assert ok and data[:7] == bytes(pays[11])
    noise = np.random.default_rng(1).integers(0, 256, 162)
    ok, _ = fano_lane(noise, P.METTAB, 60, 20)
    assert not ok
