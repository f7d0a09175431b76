"""The device engine's captured program (uwspr_tpu_torch/pipeline/
captured.py), on the CPU.

A CUDA graph can be captured and replayed only on a card, so this file
holds what the CPU can show: a CPU decoder builds no program and decodes
eagerly (its outputs are held to the JAX package by the parity tests of
the other files, unchanged); ``decode_windows_ri`` goes through the
decoder's program where it has one, and the per-window program
(``_window_program``) has a program of its own; ``eager()`` nests and
restores its state after an exception; a program holds its function
weakly, and the per-window copy is in no reference cycle; the card's
pool MiB are its live programs'; a graph's kernel nodes counted by
kernel from its DOT print, and the replays' launches in the harness's
counts; and, read from the
sources, no ``except`` around a capture or replay and no environment
variable that could turn graphs off. The capture itself, bit-identity
of every path's replay to its eager run, handles in flight, the
replays' launch counts against the eager run's and the absence of a
synchronising op on a warm call are ``chip_smoke.py``'s phase 20 on the
card.
"""

import ast
import gc
import inspect
import pathlib
import textwrap
import weakref

import numpy as np
import pytest
import torch

from uwspr_tpu_torch.config import DemodConfig, PipelineConfig
from uwspr_tpu_torch.demod.finesync import complex_to_ri
from uwspr_tpu_torch.harness import replay
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.pipeline import captured, device_decoder
from uwspr_tpu_torch.pipeline.captured import (KERNEL_SYMBOLS,
                                               REPLAY_LAUNCHES,
                                               CapturedProgram, dot_kernels,
                                               eager, eager_active, pool_mib)
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

TOY = PipelineConfig(demod=DemodConfig(n_jiggles=3, maxcycles=4))


@pytest.fixture(scope="module")
def window():
    """One (2, 45000) window holding "VE3EMB FN25 30" at -18 dB."""
    rng = np.random.default_rng(0)
    z = awgn(synthesize_frame("VE3EMB", "FN25", 30, start_sample=1000,
                              freq_offset=1.5), -18, rng=rng)
    return z.astype(np.complex64)


class RecordingProgram:
    """A stand-in for CapturedProgram on the CPU: records the decoder and
    input shape of each call and runs the function eagerly."""

    def __init__(self, device, fn):
        self.device, self.fn = device, fn
        self.calls = []

    def __call__(self, x):
        x = torch.as_tensor(x)
        self.calls.append((self.fn.__self__, tuple(x.shape)))
        return self.fn(x)


def test_cpu_decoder_builds_no_program(window):
    dec = DeviceDecoder(TOY, device="cpu")
    assert dec.program is None
    assert dec._window_program().program is None
    ri = complex_to_ri(window)[None]
    out = dec.decode_windows_ri(ri)
    with eager():
        again = dec.decode_windows_ri(ri)
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="CUDA device"):
        CapturedProgram(torch.device("cpu"), dec._decode)


def test_batch_and_per_window_programs_are_apart(window, monkeypatch):
    monkeypatch.setattr(device_decoder, "CapturedProgram", RecordingProgram)
    dec = DeviceDecoder(TOY, device="cpu")
    dec.program = RecordingProgram(dec.device, dec._decode)
    win = dec._window_program()
    assert win is not dec and win.program is not dec.program
    assert win.program.calls == [] and dec._window_program() is win
    ri = complex_to_ri(window)[None]
    shape = tuple(ri.shape)
    batch = dec.decode_windows_ri(ri)
    one = dec(window)
    # the batch path at W = 1 and the per-window program at W = 1: one
    # input shape, two programs, each running its own decoder's function
    assert dec.program.calls == [(dec, shape)]
    assert win.program.calls == [(win, shape)]
    assert win.config.demod.fano_compact_lanes == 0
    assert batch.shape == (1, dec.n_cand, 23)
    assert one.success.shape == (dec.n_cand,)


def test_eager_nests_and_restores():
    assert not eager_active()
    with eager():
        assert eager_active()
        with eager():
            assert eager_active()
        assert eager_active()
    assert not eager_active()
    with pytest.raises(RuntimeError, match="inside"):
        with eager():
            with eager():
                raise RuntimeError("inside")
    assert not eager_active()


class Owner:
    def __init__(self):
        self.program = CapturedProgram(torch.device("cuda"), self.run)

    def run(self, x):
        return x


def test_program_holds_its_function_weakly():
    """The program holds its owner's method weakly: the owner goes with
    its last reference, no reference cycle keeps it (or its graphs)."""
    owner = Owner()
    ref, program = weakref.ref(owner), owner.program
    assert program._fn() == owner.run
    del owner
    assert ref() is None and program._fn() is None


def test_per_window_program_leaves_with_its_decoder():
    """No reference cycle holds the per-window copy (or its graphs): it
    goes with the decoder's last reference, without a collection, so no
    later collection can destroy its graphs during another capture."""
    dec = DeviceDecoder(TOY, device="cpu")
    win = dec._window_program()
    assert win._per_window is None and dec._window_program() is win
    ref = weakref.ref(win)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del dec, win
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


def test_pool_mib_sums_the_live_programs():
    """The card's pool MiB are those of its live programs: a dropped
    decoder's pool leaves the sum with it."""
    owners = [Owner() for _ in range(3)]
    for o, (index, mib) in zip(owners, ((0, 12.5), (0, 2.0), (1, 7.0))):
        o.program.index, o.program.pool_mib = index, mib
    assert pool_mib(0) == 14.5 and pool_mib(1) == 7.0 and pool_mib(2) == 0
    del owners[0]
    assert pool_mib(0) == 2.0
    owners[0].program.index = None          # not captured yet
    assert pool_mib(0) == 0.0


# kernel nodes as CUDA prints a captured decode (cuGraphDebugDotPrint,
# flags 0): one node a launch, labelled with its index and mangled symbol
DOT = """digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_131"[style="bold" shape="octagon" label="131
_ZN2at6native18elementwise_kernelILi128ELi2EZNS0_22gpu_kernel_impl_nocastIZZZNS0_23direct_copy_kernel_cudaERNS_18TensorIteratorBaseEEEEviT1_
"];
"graph_1_node_130"[style="bold" shape="octagon" label="130
_ZN45_GLOBAL__N__e789c3d9_12_sync_grid_cu_04b6cda516sync_grid_kernelEPKfiiiiPKiiPKhiS1_iPf
"];
"graph_1_node_132"[style="bold" shape="octagon" label="132
_ZN47_GLOBAL__N__76cca7d7_14_select_best_cu_7cd6584318select_best_kernelEPKfPKhiidiPfPi
"];
"graph_1_node_140"[style="bold" shape="octagon" label="140
_ZN39_GLOBAL__N__f3f5ed12_7_fano_cu_48368fb311fano_kernelEPKhS1_PKiiiPhS4_PiS5_S5_
"];
"graph_1_node_150"[style="bold" shape="octagon" label="150
_ZN39_GLOBAL__N__f3f5ed12_7_fano_cu_48368fb311fano_kernelEPKhS1_PKiiiPhS4_PiS5_S5_
"];
"graph_1_node_3"[style="bold" shape="octagon" label="3
_ZN46_GLOBAL__N__7d51678e_13_stft_power_cu_4c748c6c14stft_power_mmaILi12EEEvPK6float2iiiiPKfPK5uint2iPf
"];
"graph_1_node_160"[style="bold" shape="octagon" label="160
_ZN38_GLOBAL__N__d13f3ce1_6_osd_cu_270ce17810osd_kernelEPKhS1_PKfiPiPfS5_S4_
"];
"graph_1_node_7"[style="solid" shape="rectangle" label="7
MEMCPY
"];
"graph_1_node_131" -> "graph_1_node_132";
}
}
"""


def test_graph_kernel_nodes_counted_by_kernel():
    assert dot_kernels(DOT) == {"select_best": 1, "fano_decode": 2,
                                "probe_powers": 0, "stft_power": 1,
                                "osd_decode": 1, "sync_grid": 1,
                                "probe_lanes": 0, "subtract_lanes": 0}
    assert set(KERNEL_SYMBOLS) == {n for n, _ in captured.COUNTED}
    assert dot_kernels("digraph dot {\n}\n") == dict.fromkeys(
        KERNEL_SYMBOLS, 0)


def test_replay_launches_are_in_the_counts():
    """The harness's launch counts add the replays' kernel nodes to the
    wrappers' own launches, and its reset clears both."""
    replay.reset_counters()
    try:
        REPLAY_LAUNCHES["select_best"] += 3
        REPLAY_LAUNCHES["fano_decode"] += 6
        launches, plain = replay.counters()
        assert launches == {"select_best": 3, "fano_decode": 6,
                            "probe_powers": 0, "stft_power": 0,
                            "osd_decode": 0, "sync_grid": 0,
                            "probe_lanes": 0, "subtract_lanes": 0}
        assert not any(plain.values())
    finally:
        replay.reset_counters()
    assert not any(replay.counters()[0].values())


def _handlers_and_env(tree: ast.AST) -> tuple[list, list]:
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    env = [n for n in ast.walk(tree)
           if (isinstance(n, ast.Attribute) and n.attr in ("environ",
                                                          "getenv"))
           or (isinstance(n, ast.Name) and n.id in ("environ", "getenv"))]
    return handlers, env


def test_no_fallback_in_capture_or_replay():
    src = pathlib.Path(captured.__file__).read_text()
    handlers, env = _handlers_and_env(ast.parse(src))
    assert handlers == [] and env == []
    assert "import os" not in src
    for fn in (DeviceDecoder.decode_windows_ri, DeviceDecoder._decode):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        handlers, env = _handlers_and_env(tree)
        assert handlers == [] and env == [], fn.__name__
    # the only switch is eager(): the program takes no other
    params = inspect.signature(CapturedProgram).parameters
    assert list(params) == ["device", "fn"]


@pytest.mark.cuda
def test_handles_in_flight_fetch_their_own_batch_on_card(window):
    """Two batches in flight on a card: each handle carries its own copy
    to the host, queued behind its batch, and its fetch gives what the
    batch decoded alone gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a captured program)")
    dec = DeviceDecoder(TOY, device="cuda")
    a = complex_to_ri(window)[None]
    b = np.ascontiguousarray(a[..., ::-1])
    alone = [dec.decode_windows_ri(x).cpu() for x in (a, b)]
    handles = [dec.decode_windows_ri(x) for x in (a, b)]
    for h, want in zip(handles, alone):
        host, _ = h.uwspr_host
        assert host.is_pinned() and host.device.type == "cpu"
        got = dec.fetch(h)
        assert torch.equal(host, want)
        np.testing.assert_array_equal(got.success,
                                      dec.unpack_output(want).success)
    assert dec.unpack_output(alone[0]).success.any()
