#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's decode paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. device: the card's name and power limit (nvidia-smi), its maximum SM
   clock, torch and CUDA versions; exits non-zero when
   torch.cuda.is_available() is False;
2. build: compiles uwspr_tpu_torch/csrc/*.cu (one nvcc per source, all
   started together, then one link) and the port's native C++ Fano decoder
   (uwspr_tpu_torch/fec/fano_native.cc) with g++, into the port's build
   directory; prints each kernel's registers, static shared memory and
   spills (ptxas -v; none may spill), the probe and STFT kernels' dynamic
   shared memory at the paths' shapes, and, read from the library with
   cuobjdump, the tensor-core (HMMA) instructions of the STFT kernel and
   every kernel's local-memory loads and stores (LDL, STL; none may occur
   in the selection and Fano kernels);
3. selection kernel against its plain version: real-shaped
   (1664, 5, 26, 126) grids from the scene's coarse stage and from random
   data with NaNs and negatives, the adversarial cases of
   tests/test_select_pallas.py, lanes whose accepts step on -0, +0,
   subnormals, infinities and quotients that pass the threshold only
   before rounding (special_lanes), and an all-linear bank; best bitwise
   equal, index equal; then, with a bank that is not linear-first (the
   default flags shuffled, which the plain version refuses), against a
   literal numpy scan of 256 scene lanes, the adversarial lanes, 64 random
   lanes and the special lanes;
4. Fano kernel against its plain version at small budgets (clean, noisy,
   all-timeout and inactive lanes) and against the native C++ decoder at
   the full 10,000-cycle budget, including a block of 128 lanes that all
   time out; bit-exact;
5. probe kernel against its plain version at the host engine's shapes on
   one scene window (C = 200 candidates of the scene's coarse search): the
   (L=5, F=1) lag stage, the (L=1, F=5) freq stage, the (L=1, F=1) drift
   stage and the 17-jiggle soft-symbol call, with nonzero drift and edge lags -200 and 3400, a
   16-freq (L=2, F=16) case and lags past the zero padding (clipped in
   the kernel as ops/probe.py::lag_offsets clips them); |corr| to rtol 2e-4 + atol 2e-2
   (tests/test_probe_pallas.py), the derived sync to 1e-5;
6. STFT kernel against its plain version (matmul_bf16) on the 128-window
   scene, full width and at the device decoder's 48-column window; each
   window to 1e-5 of its peak power (bf16 x bf16 products are exact in
   f32, so only the f32 summation order differs);
7. the device slice: DeviceDecoder(with_serving_defaults(PipelineConfig(),
   128), device="cuda") on bench.py's scene (seed 0, 128 windows of
   "VE3EMB FN25 30" at -18 dB): 128/128 decoded, 8 noise-only windows give
   no message, both kernels launched and neither plain version called,
   and a 2-window input agrees with the port's CPU run;
8. the host slice: WindowDecoder(PipelineConfig(), device="cuda") at full
   default width (maxfreqs 200, 17 jiggles, maxcycles 10,000, native Fano)
   on the scene's first 16 windows: every window yields the spot, 4 noise
   windows none, the probe and selection kernels launched and no plain
   version called; fano_backend="jax" gives the same spots through the
   Fano kernel; a 2-window input agrees with the port's CPU run;
9. the device slice with stft_impl="pallas": 128/128 decoded with the STFT
   kernel launched and its plain version never called; ms/window beside
   the default configuration's, timed in turns;
10. the serving runtimes on a stream of 128 channels x 24 hops (81,000
   samples of 375 S/s baseband; 124 channels carry one "VE3EMB FN25 30"
   frame at -18 dB placed so that one ring window holds it whole, 4 carry
   noise only), at with_serving_defaults(PipelineConfig(), 128):
   RingServe decodes every frame in its window and nothing in the noise
   channels, with the selection and Fano kernels launched and no plain
   version called; DeviceRingDecoder's packed output of every hop is
   bitwise equal to DeviceDecoder.decode_windows_ri on the 128 windows
   sliced at the ring's boundaries, and so are a ring resumed from
   state() at hop 12, push_hops(4) and staged ingest (pinned buffer, copy
   stream); int16 ingest decodes the same messages; torch.profiler
   reads the host-to-device bytes of 4 steady-state hops, at least the
   hop block and at most the block plus 64 KiB, and splits a hop's time
   by kernel; the hybrid engine (fano_mode "host") gives the
   device engine's spots with the native Fano and with the Fano kernel
   (fano_backend "jax"); BatchedStreamDecoder(batch_windows=128) on the
   128 channels and on 100 of them (a zero-padded flush) decodes every
   window that holds a whole frame and drops nothing; StreamDecoder on 2
   channels with the device (W = 1: no compaction, the per-window Fano
   cap), hybrid and host engines agrees window by window where a window
   holds a whole frame or none (cut frames are reported), and resumes
   from a checkpoint with the same tail;
11. the wideband configuration (the GNU Radio block's default
   halfbandwidth 187: hpbm 256, the whole 512-bin spectrum, C = 200) at
   with_serving_defaults(PipelineConfig(coarse=CoarseConfig(
   halfbandwidth=187, maxfreqs=200)), 32) on scripts/bench_matrix.py's
   scene (32 windows, 10 frames each across +/-170 Hz at -15 dB, seed 3):
   320/320 decoded with the einsum grid on bf16 operands; again with
   stft_impl="pallas" (the STFT kernel at (32, 348, 512)), the same
   message sets; the host engine on 2 of the windows
   gives the same message sets; ms/window by CUDA events and wall, peak
   device memory;
12. on-device OSD: 32 windows of one frame at -30 dB (the deep-SNR recipe
   of scripts/bench_matrix.py, seed 5) at osd_depth 4 against osd_depth 0
   under with_serving_defaults(., 32): every Fano decode of the OSD-off
   run kept, at least one OSD-tagged spot and every one of them the
   transmitted message; the rescue's lanes through fec/osd_torch.py on the
   card equal to the CPU run and, for the first 16, to the host
   fec/osd.osd_decode at order 4; the OSD stage's ms and the decode's with
   OSD on and off;
13. multipass: StreamDecoder(passes=2) with the device and hybrid engines
   on tests/test_multipass.py's masked scene (seed 100) decodes the strong
   frame in pass 0 and the weak one in pass 1, passes=1 misses the weak
   one; wall ms per window;
   on each of the paths of 11 to 13, every select_best and fano_decode_batch
   call the device engine made is recorded (kernel_calls) and replayed: the
   selection grid (the wideband (6400, 5, 26, 126) grid among them) through
   select_best_plain, best bitwise and index equal; the Fano lanes (the
   wideband chunk, the deep-SNR timeouts, each pass's W = 1 lanes) through
   the native C++ decoder at the call's budget, bit-exact, inactive lanes to
   the kernel's contract;
14. timing: each kernel, its plain version and, where one exists, the one
   PyTorch call that computes the same function (torch.stft for the STFT,
   the plain version's complex torch.bmm for the probe; none for the
   selection walk and the Fano search) at the paths' shapes, with CUDA
   events, in turns plain, kernel, library, library, kernel, plain, each
   turn behind a spin kernel so that calls run back to back on the card;
   kernel and plain are also held equal on those inputs. Each kernel's bound is
   the least time the card could take: the larger of its bytes over the
   HBM rate and its operations over their peak rate (H100 SXM data sheet,
   700 W), and for Fano the longest lane's forward looks times one
   shared-memory round trip. Selection is also timed at the host engine's
   (200, 5, 26, 126) grid of the scene's first window, and Fano at
   maxcycles 10,000 on a block of 128 lanes of uniform noise that all run
   the full budget and on a mixed chunk of 192 clean lanes and 64 such
   timeouts (held to the native decoder; the plain version would take
   hours there, so it is not timed). Selection is also timed on the
   wideband (6400, 5, 26, 126) grid, and the STFT on the wideband
   (32, 348, 512) call. Then the runtimes, in turns, with
   CUDA events behind the spin kernel and on the host clock: the ring's ms
   per hop (f32 and int16 ingest) beside DeviceDecoder on the same
   windows, BatchedStreamDecoder and StreamDecoder(engine="device") per
   window;
15. (run after 13, before the timing of 14) the uwspr-torch CLI
   (uwspr_tpu_torch.cli.main in this process, stdout and stderr captured),
   each command with the kernel counts set to 0 just before it and read
   just after: (a) encode "VE3EMB FN25 30" at +2.5 Hz, c2towav, then
   decode of the wav on the default device and engine prints the message
   with the selection and Fano kernels launched and no plain version
   called; (b) --engine host (probe and selection kernels) and --engine
   hybrid print it too; (c) every selection and Fano call of (a) replayed
   through select_best_plain and fano_native.cc, bit-exact; (d)
   Downconverter on the card against the port's CPU run, within 1e-5 of
   the output's peak, on that wav (1.44 M audio samples) and on a one-hour
   capture (43.2 M), the device half (mix and strided FIR) timed by CUDA
   events beside its bound; (e) serve --runtime ring --channels 128
   --windows 24 --snr -18 prints the spots of RingServe driven here on the
   same synthetic blocks, every one the sent message; (f) python -m
   uwspr_tpu_torch.cli serve --input - --format s16 as a process of its
   own, fed one frame's 12 kS/s audio, prints the spot, exits 0 and
   imports no jax* or uwspr_tpu* module (-X importtime), and its wall time
   is taken; (g) sweep --engine device from -15 to -27 dB and --engine
   host at -15 dB, 32 trials a point, decode 32/32 at -15 dB; (h) a sender
   and a wav receiver flowgraph, written here, through grc, and decode of
   the sender's wav; (i) decode --trace-dir writes a torch.profiler trace
   that names select_best_kernel and fano_kernel; (j) warmup --batch
   1,128;
16. (run after 15, before the timing of 14) the multi-device layer
   (uwspr_tpu_torch/parallel/) on phase 10's stream at PipelineConfig()
   (the config serve --mesh runs: no compaction, the per-window Fano cap):
   (a) ShardedStreamDecoder on a 1x1 mesh over NCCL in this process at
   wins_per_shard 4; (b) four ranks sharing this card over gloo, under
   python -m torch.distributed.run (this script with the argument
   mesh-rank), on a 2x2 mesh at wins_per_shard 2. In each, the selection
   and Fano kernels launched and no plain version called, every select_best
   and fano_decode_batch call replayed as in 11 to 13, and the spots equal
   BatchedStreamDecoder's (all channels) and StreamDecoder's (two channels)
   of phase 10 on every window that holds a whole frame or none; in (b)
   also each rank's packed output bitwise equal to decode_windows_ri on its
   own windows, the same spot list on every rank, every rank's kernel
   counts gathered to rank 0, and the hybrid engine's spots equal to the
   device engine's. (c) serve --mesh 2x2 --dist-backend gloo --channels 8
   under the launcher and serve --mesh 1x1 --dist-backend nccl in this
   process print the spot lines of serve --runtime python on the same
   synthetic source; (d) NCCL asked for two ranks on this one card (this
   script with the argument mesh-refusal, two ranks) raises the port's
   SharedDeviceError. (e) times a mesh step by CUDA events and the host
   clock, the halo exchange's share of it and channel-windows/s: (a) in
   turns with BatchedStreamDecoder on the same stream, (b) in its ranks
   before their checks, with nothing else on the card (four ranks on one
   card measure the exchange's cost, not scaling); (c) and (d) start once
   (b) has timed, and run beside (b)'s checks.
17. (run after 16, before the timing of 14) the result harnesses
   (uwspr_tpu_torch/harness/), each path with the kernel counts set to 0
   just before it and read just after: (a) python -m
   uwspr_tpu_torch.harness.bench as a process of its own: its last stdout
   line parses with bench.py's keys and a value above 0, its record says
   128/128 with the selection and Fano kernels launched (its own
   counters) and no plain version called, and it imports no jax* or
   uwspr_tpu* module (-X importtime); (b) the SNR sweep's -29 and -30 dB
   points, 50 trials, with the device and hybrid engines, the earlier
   points' trials drawn and skipped: equal trial by trial and within
   tolerance of SWEEP_r05.json (harness/common.py: 2 trials a point, 4 a
   curve); (c) the device OSD sweep at -30 dB, 25 trials, order 4: no
   false-valid spot, Fano and OSD rates within tolerance of
   SWEEP_OSD_DEVICE_r05.json; (d) the matrix row noise_only_serving (128
   noise windows): no spot; (e) the multipass row at -12 dB (host engine,
   probe and selection kernels) on the trials that fit 20 s: the strong
   frame decodes in each, the weak frame misses no more trials than
   MULTIPASS_r02.json's plus the tolerance. Every kernel call of (b) to
   (e), and of one decode of (a)'s decoder on (a)'s scene in this process,
   is recorded and replayed as in 11 to 13; the host engine's probe_powers
   calls of (e) through probe_powers_plain within phase 5's tolerance.
18. (run after 17, before the timing of 14) the multi-chip evidence
   (uwspr_tpu_torch/harness/scaling.py's ``run``, which also writes the
   records of ``python -m uwspr_tpu_torch.harness.scaling``): (a) the
   compute controls in this process, ShardedDecoder.decode on a (1,1) mesh
   over NCCL at PipelineConfig() on scripts/weak_scaling.py's scenes (1
   and 4 channels, 1 and 4 windows a shard, 128, 256 and 512 channels),
   every frame decoded, timed by CUDA events and the host clock after one
   recorded decode of each; (b) one world of 8 gloo ranks sharing this
   card, under the launcher (this script with the argument scaling-rank):
   the CollectiveLog of one ShardedDecoder.decode and one
   ShardedStreamDecoder.step on each of SCALING_r05.json's five meshes
   equals the hand formula and the record (the same rounds and ppermute
   bytes, one all_reduce; the step adds exactly one all_gather) on every
   rank; the pod dry run ((8,1), 32 channels at 4 a shard) decodes its 8
   frames and the multichip dry run ((2,4)) decodes "VE3EMB FN25 30"
   across every time-shard boundary. On all four paths (the controls'
   recorded decodes, the five rows' decodes and steps, the two dry runs)
   the kernel counts are set to 0 just before each run and read just
   after, the selection and Fano kernels launch in every run (on every
   rank), no plain version is called, and every selection and Fano call
   is replayed against its oracle bit-exact (harness/replay.py). The
   bounds are priced at the controls' compute (data-sheet interconnect
   rates, not measured; the NVLink latency a step assumed, its bound also
   given as a function of it).

Every path is driven with the kernel counts set to 0 just before it and
read just after. Prints a JSON line of the runtimes', wideband, OSD and
multipass times, a JSON line of the CLI phase's results, a JSON line of
the mesh phase's results, a JSON line of the harness phase's results, a
JSON line of the scaling phase's results,
then a JSON line of per-kernel results (launches
on the main path, on the ring and on every other path, times, bound,
library call) before the last line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
N_WINDOWS = 128
N_HOST = 16             # scene windows through the host engine
SNR_DB = -18.0
EXPECTED = "VE3EMB FN25 30"
STFT_RTOL = 1e-5        # of each window's peak power


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset_all_counters():
    from uwspr_tpu_torch.harness.replay import reset_counters
    reset_counters()


def read_counters():
    """(kernel launches, plain calls) of every kernel, by name."""
    from uwspr_tpu_torch.harness.replay import counters
    return counters()


# ---------------------------------------------------------------- phase 1

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    sm_mhz = int(clk.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"tf32: cuda.matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32} (the decoder pins both off)"
        f"; max SM clock {sm_mhz} MHz")
    return card, sm_mhz


# ---------------------------------------------------------------- phase 2

def phase_build():
    from uwspr_tpu_torch.fec.host import load_native_fano
    from uwspr_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_library()
    info = cuda_build.build_info
    log(f"[build] nvcc {' '.join(cuda_build.NVCC_FLAGS)} "
        f"{[str(p.relative_to(ROOT)) for p in cuda_build.kernel_sources()]}"
        f" -> {pathlib.Path(info['library']).relative_to(ROOT)} in "
        f"{info['seconds']:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    res = cuda_build.kernel_resources(info["log"])
    for name, r in res.items():
        log(f"[build] ptxas {name}: {r['registers']} registers, "
            f"{r['smem_bytes']} bytes static smem, {r['spill_bytes']} bytes "
            f"spilled")
        require(r["spill_bytes"] == 0, f"{name} spills registers")
    lib = cuda_build.load_library()
    # dynamic shared memory at the paths' shapes
    from uwspr_tpu_torch.ops import probe, stft
    for L, F in ((5, 1), (1, 5), (1, 1), (17, 1), (2, 16)):
        S, threads, smem = probe.kernel_tiling(L, F)
        require(lib.uwspr_probe_powers_smem(S, F) == smem,
                "probe kernel_tiling's shared memory differs from the C side")
        log(f"[build] probe_powers_kernel at L={L}, F={F}: {S} symbols x "
            f"{threads} threads per block, {smem} bytes dynamic smem")
    for ncols in (48, 512):
        nt = stft.mma_tiles(ncols)
        log(f"[build] stft_power_mma<{nt}> ({ncols} columns): "
            f"{lib.uwspr_stft_power_smem(512, 128, nt)} bytes dynamic smem")
    sass = cuda_build.sass_counts(info["library"], "HMMA")
    mma = {k: v for k, v in sass.items() if "stft_power_mma" in k}
    log(f"[build] tensor-core instructions (cuobjdump -sass) in the STFT "
        f"kernels: {json.dumps(mma)}")
    require(len(mma) == 4 and all(sum(v.values()) > 0 for v in mma.values()),
            "the STFT kernels carry no HMMA instruction")
    # local memory: none in the selection and Fano kernels, whose state
    # lives in registers and shared memory; the probe kernel's sincosf
    # keeps a small array there for its slow-path range reduction
    ldl = cuda_build.sass_counts(info["library"], "LDL")
    stl = cuda_build.sass_counts(info["library"], "STL")
    local = {k: sum(v.values()) + sum(stl.get(k, {}).values())
             for k, v in ldl.items()}
    log(f"[build] local-memory instructions (LDL + STL, cuobjdump -sass): "
        f"{json.dumps(local)}")
    require(all(n == 0 for k, n in local.items()
                if "select_best" in k or "fano" in k),
            "the selection or Fano kernel uses local memory")
    native = load_native_fano()
    log(f"[build] native Fano decoder built from "
        f"uwspr_tpu_torch/fec/fano_native.cc: {native._name}")


# ---------------------------------------------------------------- scene

def make_windows(n: int, seed: int = 0):
    """bench.py's workload (bench.py:39-51): n windows of one frame at
    SNR_DB with random frequency offsets and starts."""
    from uwspr_tpu_torch.io.channel import awgn
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    rng = np.random.default_rng(seed)
    wins = []
    for _ in range(n):
        f = float(rng.uniform(-5, 5))
        start = int(rng.integers(0, 2000))
        z = synthesize_frame("VE3EMB", "FN25", 30, start_sample=start,
                             freq_offset=f)
        wins.append(awgn(z, SNR_DB, rng=rng))
    return to_ri(np.stack(wins))


def noise_windows(n: int, seed: int = 1):
    from uwspr_tpu_torch.io.channel import noise_sigma
    rng = np.random.default_rng(seed)
    s = noise_sigma(SNR_DB)
    z = (rng.normal(scale=s, size=(n, 45000))
         + 1j * rng.normal(scale=s, size=(n, 45000)))
    return to_ri(z)


def to_ri(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=1).astype(np.float32)


# ---------------------------------------------------------------- phase 3

def phase_select(dec, ri_cuda):
    import torch

    from uwspr_tpu_torch.ops import select as sel
    is_nl = dec.state["is_nl"]
    M = is_nl.shape[0]
    cases = {}
    z_all = torch.complex(ri_cuda[:, 0], ri_cuda[:, 1])
    with torch.no_grad():
        grid = dec.coarse_grid(z_all)["grid"]
    scene = grid.reshape((-1,) + grid.shape[2:]).contiguous()
    require(tuple(scene.shape) == (N_WINDOWS * dec.n_cand, 5, 26, M),
            f"scene grid shape {tuple(scene.shape)}")
    cases["scene"] = (scene, is_nl)
    rng = np.random.default_rng(17)
    rand = rng.normal(size=tuple(scene.shape)).astype(np.float32) * 0.1
    rand[0, 2, 3, :] = np.nan
    rand[1, :, :, 40:] = np.nan
    rand[5::97, 1, :, :7] = np.nan
    rand[7, :, :, :] = np.nan
    cases["random_nan_neg"] = (torch.from_numpy(rand).cuda(), is_nl)
    neg = np.full((2, 5, 26, M), -100.0, np.float32)
    neg[0, 0, 0, 0] = -5.0
    neg[0, 0, 2, 1] = -80.0
    neg[0, 0, 4, 3] = -60.0
    esc = np.full((1, 5, 26, M), 1e-6, np.float32)
    esc[0, 0, 0, [0, 4, 7, 10]] = [1e-4, 2e-3, 0.3, 40.0]
    deep = np.full((1, 5, 26, M), 1e-9, np.float32)
    deep[0, 1, 3, [0, 3, 5, 8, 11]] = [1e-7, 5e-6, 1e-4, 9e-3, 0.7]
    adv = np.concatenate([neg, esc, deep, rand[:9]])       # 13 lanes
    cases["adversarial"] = (torch.from_numpy(adv).cuda(), is_nl)
    cases["all_linear"] = (torch.from_numpy(rand[:333]).cuda(),
                           torch.zeros_like(is_nl))
    spec, _ = special_lanes(is_nl.cpu().numpy())
    cases["special_values"] = (torch.from_numpy(spec).cuda(), is_nl)
    max_err = 0.0
    for name, (g, nl) in cases.items():
        bk, ik = sel.select_best(g, nl, threshold=10.0)
        bp, ip = sel.select_best_plain(g, nl, threshold=10.0)
        torch.cuda.synchronize()
        require(torch.equal(bk.view(torch.int32), bp.view(torch.int32)),
                f"select {name}: best differs bitwise")
        require(torch.equal(ik, ip), f"select {name}: index differs")
        max_err = max(max_err, float((bk - bp).abs().nan_to_num().max()))
        log(f"[select] {name} {tuple(g.shape)}: kernel == plain "
            f"(best bitwise, idx equal)")
    # a bank that is not linear-first, against the literal scan
    shuffled = is_nl.cpu().numpy().copy()
    np.random.default_rng(4).shuffle(shuffled)
    shuffled[[31, 32, 63, 64, 95]] = False      # linear on the chunk edges
    lanes = np.concatenate([scene[:256].cpu().numpy(), adv, rand[:64],
                            special_lanes(shuffled)[0]])
    bk, ik = sel.select_best(torch.from_numpy(lanes).cuda(),
                             torch.from_numpy(shuffled).cuda(),
                             threshold=10.0)
    bs, is_ = literal_scan(lanes, shuffled, 10.0)
    require(np.array_equal(bk.cpu().numpy().view(np.int32), bs.view(np.int32))
            and np.array_equal(ik.cpu().numpy(), is_),
            "select: kernel differs from the literal scan on an unordered "
            "bank")
    log(f"[select] unordered bank (linear models at "
        f"{np.flatnonzero(~shuffled).tolist()}), {len(lanes)} lanes: kernel "
        f"== literal numpy scan (best bitwise, idx equal)")
    return scene, max_err


def literal_scan(grid: np.ndarray, is_nl: np.ndarray, thr: float):
    """The reference's sequential walk over each lane's (5, lags, M) grid
    in order (search.py::select_best_scan), vectorised over lanes; f32
    division is IEEE in numpy as in the kernel."""
    L, M = grid.shape[0], grid.shape[-1]
    flat = grid.reshape(L, -1)
    best = np.full(L, -1e30, np.float32)
    idx = np.zeros(L, np.int32)
    thr = np.float32(thr)
    with np.errstate(all="ignore"):
        for j in range(flat.shape[1]):
            v = flat[:, j]
            upd = (v / best > thr) if is_nl[j % M] else (v > best)
            best = np.where(upd, v, best)
            idx = np.where(upd, np.int32(j), idx)
    return best, idx


def near_threshold(thr: float = 10.0, seed: int = 3):
    """(b, lo, hi), positive floats with lo / b above thr as real numbers
    but not after f32 rounding (fl(lo / b) == thr) and fl(hi / b) > thr."""
    from fractions import Fraction
    rng = np.random.default_rng(seed)
    t = np.float32(thr)
    for b in rng.uniform(1, 2, 4096).astype(np.float32):
        lo = np.nextafter(t * b, np.float32(np.inf))
        while Fraction(float(lo)) <= Fraction(float(t)) * Fraction(float(b)):
            lo = np.nextafter(lo, np.float32(np.inf))
        hi = np.nextafter(lo, np.float32(np.inf))
        if lo / b == t and hi / b > t:
            return b, lo, hi
    raise AssertionError("no near-threshold pair found")


def special_lanes(is_nl: np.ndarray, lags: int = 26):
    """Lanes whose accept chains (threshold 10) step on -0, +0, subnormals,
    +inf and -inf, and on quotients that pass the threshold only before
    rounding; every other value is NaN. Each group holds at most one value
    for a linear model, placed first, then values for nonlinear models, so
    the chains hold for any bank order. Returns the (5, 5, lags, M) grid
    and the values the literal scan accepts at threshold 10."""
    M = is_nl.shape[0]
    lin = int(np.flatnonzero(~is_nl)[0])
    nls = np.flatnonzero(is_nl)
    nls = nls[nls > lin]
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    inf = np.float32(np.inf)
    b, lo, hi = near_threshold()
    # per lane: {group: (linear value or None, [nonlinear values])}
    plan = [
        {0: (np.float32(-0.0), [-tiny, np.float32(5.0), -11 * tiny]),
         1: (np.float32(0.0), [np.float32(-3.0), np.float32(0.0),
                               np.float32(-0.0), 2 * tiny]),
         2: (None, [7 * tiny, inf]),
         3: (inf, [np.float32(1.0), -inf, inf]),
         5: (None, [np.float32(3e38), np.float32(-3e38)])},
        {0: (None, [-inf, np.float32(5.0), -inf]),
         1: (b, [lo, hi]),
         4: (None, [lo, np.float32(10) * hi])},
        {0: (-b, [-lo, -hi]),
         2: (np.float32(0.0), [tiny, np.float32(-1.0), 7 * tiny])},
        {0: (inf, [-inf, inf, np.float32(1e30)])},
        {0: (3 * tiny, [np.float32(3e-44), np.float32(1e-38)]),
         3: (None, [np.float32(1e-37), np.float32(1e-36)])},
    ]
    grid = np.full((len(plan), 5 * lags, M), np.nan, np.float32)
    for lane, groups in enumerate(plan):
        for g, (lv, nv) in groups.items():
            if lv is not None:
                grid[lane, g, lin] = lv
            grid[lane, g, nls[:len(nv)]] = nv
    accepted = [np.float32(-0.0), -tiny, -11 * tiny, np.float32(0.0),
                2 * tiny, inf, -inf, b, hi, -b, -hi, tiny]
    return grid.reshape(len(plan), 5, lags, M), accepted


# ---------------------------------------------------------------- phase 4

def fano_lanes(rng, n, sigma, scale=50.0):
    """n soft-symbol lanes: encoded random payloads plus gaussian noise
    (tests/test_fano_pallas.py:20-31); sigma None gives uniform noise."""
    from uwspr_tpu_torch.protocol.fec_encode import encode_bits
    if sigma is None:
        return rng.integers(0, 256, size=(n, 162)).astype(np.uint8)
    out = []
    for _ in range(n):
        bits = rng.integers(0, 2, size=50).astype(np.uint8)
        coded = encode_bits(np.concatenate([bits, np.zeros(31, np.uint8)]))
        soft = (np.where(coded == 1, 1.0, -1.0) * scale
                + rng.normal(0, sigma, 162) + 128)
        out.append(np.clip(soft, 0, 255).astype(np.uint8))
    return np.stack(out)


def native_decode(symbols, maxcycles):
    """The native C++ decoder through the port's host Fano backend."""
    from uwspr_tpu_torch.fec.host import fano_decode_batch_host
    succ, data, metric, cycles, maxnp = fano_decode_batch_host(
        symbols, backend="native", device="cpu", maxcycles=maxcycles)
    return {"success": succ, "data": data, "metric": metric,
            "cycles": cycles.astype(np.int32),
            "maxnp": maxnp.astype(np.int32)}


def fano_equal(a: dict, b: dict, what: str) -> float:
    """Require every result field equal; return the largest absolute
    difference over the integer fields (0 when bit-exact)."""
    from uwspr_tpu_torch.harness.replay import fano_difference
    err, bad = fano_difference(a, b)
    require(not bad, f"fano {what}: {'; '.join(bad)}")
    return err


def phase_fano():
    import torch

    from uwspr_tpu_torch.protocol.constants import FANO_METTAB
    from uwspr_tpu_torch.fec import fano
    met_c = torch.from_numpy(FANO_METTAB).cuda()
    rng = np.random.default_rng(5)
    # small budgets: kernel vs plain (plain on CPU copies: it is a lockstep
    # loop of tiny ops, one per primitive move)
    lanes = np.concatenate([fano_lanes(rng, 60, 10.0),
                            fano_lanes(rng, 60, 45.0),
                            fano_lanes(rng, 80, None)])      # 200 lanes
    active = rng.random(200) > 0.2
    err = 0.0
    for mc in (25, 120):
        k = fano.fano_decode_batch(torch.from_numpy(lanes).cuda(), met_c,
                                   torch.from_numpy(active).cuda(),
                                   maxcycles=mc)
        p = fano.fano_decode_batch_plain(torch.from_numpy(lanes),
                                         torch.from_numpy(FANO_METTAB),
                                         torch.from_numpy(active),
                                         maxcycles=mc)
        torch.cuda.synchronize()
        err = max(err, fano_equal(k, p, f"kernel vs plain maxcycles={mc}"))
        inact = ~active
        require(not k["success"].cpu().numpy()[inact].any()
                and (k["data"].cpu().numpy()[inact] == 0).all()
                and (k["metric"].cpu().numpy()[inact] == 0).all()
                and (k["cycles"].cpu().numpy()[inact] == 1).all()
                and (k["maxnp"].cpu().numpy()[inact] == 0).all(),
                "fano: inactive lanes break the contract")
        log(f"[fano] kernel == plain, 200 lanes (clean, noisy, noise, "
            f"{int(inact.sum())} inactive), maxcycles={mc}: bit-exact")
    # full budget: kernel vs the native C++ decoder
    full = np.concatenate([fano_lanes(rng, 64, 10.0),
                           fano_lanes(rng, 64, 48.0),
                           fano_lanes(rng, 128, None)])      # 256 lanes
    t0 = time.perf_counter()
    k = fano.fano_decode_batch(torch.from_numpy(full).cuda(), met_c,
                               maxcycles=10000)
    torch.cuda.synchronize()
    tk = time.perf_counter() - t0
    n = native_decode(full, 10000)
    err = max(err, fano_equal(k, n, "kernel vs native maxcycles=10000"))
    timeouts = int((n["cycles"] == 810002).sum())
    require(timeouts >= 128, f"expected >= 128 timeout lanes, got {timeouts}")
    log(f"[fano] kernel == native fano_native.cc at maxcycles=10000, 256 "
        f"lanes ({timeouts} full-budget timeouts incl. a 128-lane block): "
        f"bit-exact; kernel {tk * 1e3:.1f} ms wall")
    return err


# ---------------------------------------------------------------- phase 5

def probe_cases(hdec, ri):
    """The host engine's probe calls on the scene's first window, at the
    C = 200 candidates its coarse search gives: name -> (lags, freqs,
    drift_sym, want_symbols) as CUDA tensors. Linear lanes get a random
    nonzero drift; lanes 1 and 2 read the edge lags -200 and 3400."""
    import torch

    from uwspr_tpu_torch.demod.finesync import drift_offsets
    from uwspr_tpu_torch.device import exact_f32
    z = ri[0, 0] + 1j * ri[0, 1]
    with torch.no_grad(), exact_f32():
        cands = hdec.coarse(z)
    C = len(cands.freq)
    rng = np.random.default_rng(3)
    drift = (cands.drift + rng.uniform(-1.5, 1.5, C)).astype(np.float32)
    dsym = drift_offsets(cands, drift, float(hdec.config.coarse.cf))
    shift = cands.shift.astype(np.int64)
    f1 = cands.freq.astype(np.float32)
    lag5 = shift[:, None] + np.arange(-128, 129, 64)[None, :]
    lag5[1] = -200 + np.arange(-128, 129, 64)
    lag5[2] = 3400 + np.arange(-128, 129, 64)
    lag1 = shift[:, None].copy()
    lag1[1, 0], lag1[2, 0] = -200, 3400
    jig = hdec.fine.jiggle_offsets()
    lag17 = shift[:, None] + jig[None, :]
    lag17[1] = -200 + jig
    lag17[2] = 3400 + jig
    cases = {
        "lag stage (L=5, F=1)": (lag5, f1[:, None], False),
        "freq stage (L=1, F=5)": (
            lag1, f1[:, None] + np.float32(0.25) * np.arange(-2, 3,
                                                             dtype=np.float32),
            False),
        "drift stage (L=1, F=1)": (lag1, f1[:, None], False),
        "soft symbols (L=17, F=1)": (lag17, f1[:, None], True),
    }

    def cu(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).cuda()
    return {name: (cu(lags, np.int32), cu(freqs, np.float32),
                   cu(dsym, np.float32), want)
            for name, (lags, freqs, want) in cases.items()}


def probe_error(pk, pp, what: str) -> float:
    """Require |pk - pp| <= PROBE_ATOL + PROBE_RTOL * |pp| and the derived
    sync within SYNC_ATOL (uwspr_tpu_torch/harness/replay.py); return
    max |pk - pp|."""
    from uwspr_tpu_torch.harness.replay import probe_difference
    err, bad = probe_difference(pk, pp)
    require(not bad, f"probe {what}: {'; '.join(bad)}")
    return err


def phase_probe(hdec, ri):
    import torch

    from uwspr_tpu_torch.device import exact_f32
    from uwspr_tpu_torch.harness.replay import (PROBE_ATOL, PROBE_RTOL,
                                                SYNC_ATOL)
    from uwspr_tpu_torch.ops import probe
    cases = probe_cases(hdec, ri)
    z_ri = torch.from_numpy(np.ascontiguousarray(ri[0])).cuda()
    # any F <= 16: a case off the host engine's shapes
    lags, freqs, dsym, _ = cases["lag stage (L=5, F=1)"]
    checks = dict(cases)
    checks["16 freqs (L=2, F=16)"] = (
        lags[:, 1:3].contiguous(),
        freqs + 0.1 * torch.arange(16, device=freqs.device) - 0.8, dsym, False)
    # lags past the zero padding, clipped as ops/probe.py::lag_offsets
    far = lags[:, :2].clone()
    far[0] = torch.tensor([-50000, -4000])
    far[1] = torch.tensor([50000, 9000])
    far[2] = torch.tensor([-4100, 45100])
    checks["lags past the padding (L=2, F=1)"] = (far, freqs, dsym, False)
    err = 0.0
    for name, (lags, freqs, dsym, _) in checks.items():
        L = lags.shape[1]
        with torch.no_grad(), exact_f32():
            pk = probe.probe_powers(z_ri, lags, freqs, dsym, n_lags=L)
            pp = probe.probe_powers_plain(z_ri, lags, freqs, dsym, n_lags=L)
        torch.cuda.synchronize()
        e = probe_error(pk, pp, name)
        err = max(err, e)
        log(f"[probe] {name} {tuple(pk.shape)}: kernel == plain within "
            f"rtol {PROBE_RTOL} atol {PROBE_ATOL} (max |diff| {e:.3g}, "
            f"max power {float(pp.max()):.4g}); sync within {SYNC_ATOL}")
    return err, z_ri, cases


# ---------------------------------------------------------------- phase 6

def stft_error(pk, pp, what: str) -> float:
    """Require every window's |pk - pp| <= STFT_RTOL * its peak power;
    return max |pk - pp|."""
    require(pk.shape == pp.shape, f"stft {what}: shape {tuple(pk.shape)}")
    d = (pk - pp).abs()
    peak = pp.amax(dim=(-2, -1), keepdim=True)
    rel = float((d / peak).max())
    require(rel <= STFT_RTOL, f"stft {what}: {rel:.3g} of the peak power")
    return float(d.max())


def phase_stft(dec, ri_c):
    import torch

    from uwspr_tpu_torch.device import exact_f32
    from uwspr_tpu_torch.ops import stft
    cfg = dec.config.coarse
    z = torch.complex(ri_c[:, 0], ri_c[:, 1])
    kw = dict(n_ffts=cfg.n_ffts, size=cfg.fft_size, hop=cfg.spb // 2)
    err = 0.0
    inputs = {}
    for name, col in (("full width", None), ("column window", dec._cols)):
        consts = stft.stft_constants(cfg.fft_size, col, z.device)
        with torch.no_grad(), exact_f32():
            pk = stft.stft_power_core(z, impl="pallas", col_window=col,
                                      consts=consts, **kw)
            pp = stft.stft_power_core(z, impl="matmul_bf16", col_window=col,
                                      consts=consts, **kw)
        torch.cuda.synchronize()
        e = stft_error(pk, pp, name)
        err = max(err, e)
        inputs[name] = (col, consts)
        log(f"[stft] {name} {tuple(pk.shape)}: kernel == plain within "
            f"{STFT_RTOL} of each window's peak power (max |diff| {e:.3g})")
    return err, z, kw, inputs


# ---------------------------------------------------------------- phase 7

def phase_slice(card, dec, ri, ri_c):
    import torch

    from uwspr_tpu_torch.config import (DemodConfig, PipelineConfig,
                                  with_serving_defaults)
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder

    t0 = time.perf_counter()
    out = dec.decode_windows_ri(ri_c)
    torch.cuda.synchronize()
    log(f"[slice] warm-up decode of {N_WINDOWS} windows: "
        f"{time.perf_counter() - t0:.3f} s")
    reps = 5
    torch.cuda.reset_peak_memory_stats()
    reset_all_counters()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = dec.decode_windows_ri(ri_c)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    launches, plain = read_counters()
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] launches during {reps} decodes: {launches}; plain calls: "
        f"{plain}")
    require(launches["select_best"] > 0 and launches["fano_decode"] > 0,
            f"a kernel of the path was not launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"a plain version ran on the card path: {plain}")

    a = out.cpu().numpy()
    require(a.shape == (N_WINDOWS, dec.n_cand, 23),
            f"output shape {a.shape}")
    require(bool(np.isfinite(a).all()), "non-finite output values")
    typed = dec.unpack_output(a)
    ok = sum(EXPECTED in dec.messages(typed.window(w))
             for w in range(N_WINDOWS))
    log(f"[slice] {ok}/{N_WINDOWS} windows decoded to '{EXPECTED}'")
    require(ok == N_WINDOWS, f"only {ok}/{N_WINDOWS} windows decoded")
    log(f"[slice] {card}: {dt * 1e3 / N_WINDOWS:.4f} ms/window, "
        f"{N_WINDOWS * 45000 / dt:.1f} window-samples/s "
        f"({dt * 1e3:.2f} ms per {N_WINDOWS}-window batch, mean of {reps}); "
        f"peak device memory {peak / 2**20:.1f} MiB")

    ndec = DeviceDecoder(with_serving_defaults(PipelineConfig(), 8),
                         device="cuda")
    nout = ndec.unpack_output(ndec.decode_windows_ri(
        torch.from_numpy(noise_windows(8)).cuda()))
    nmsg = sum(len(ndec.messages(nout.window(w))) for w in range(8))
    require(nmsg == 0, f"noise-only windows gave {nmsg} messages")
    log("[slice] 8 noise-only windows: 0 messages")

    # agreement with the port's CPU run (plain versions) on a small input
    cfg2 = with_serving_defaults(PipelineConfig(
        demod=DemodConfig(maxcycles=2000)), 2)
    small = np.concatenate([ri[:1], noise_windows(1, seed=2)])
    og = DeviceDecoder(cfg2, device="cuda").decode_windows_ri(
        torch.from_numpy(small).cuda()).cpu().numpy()
    oc = DeviceDecoder(cfg2, device="cpu").decode_windows_ri(
        torch.from_numpy(small)).numpy()
    tg, tc = dec.unpack_output(og), dec.unpack_output(oc)
    for key in ("success", "valid", "fano_attempts", "fano_overflow"):
        require(np.array_equal(getattr(tg, key), getattr(tc, key)),
                f"cuda vs cpu run: {key} differs")
    s = tg.success
    require(np.array_equal(tg.payload[s], tc.payload[s])
            and np.array_equal(tg.shift[s], tc.shift[s])
            and np.array_equal(tg.mode[s], tc.mode[s]),
            "cuda vs cpu run: decoded candidates differ")
    df = float(np.abs(tg.freq[s] - tc.freq[s]).max(initial=0.0))
    dsync = float(np.abs(tg.sync[s] - tc.sync[s]).max(initial=0.0))
    log(f"[slice] 2-window input, cuda vs the port's cpu run: messages, "
        f"valid, success, gates equal; |dfreq| {df:.3g} Hz, |dsync| "
        f"{dsync:.3g}")
    return launches


# ---------------------------------------------------------------- phase 8

def spot_key(s):
    return (s.message, s.candidate, s.jiggle, s.shift, s.mode)


def phase_host_slice(card, hdec, ri):
    import dataclasses

    from uwspr_tpu_torch.config import PipelineConfig
    from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
    zs = (ri[:N_HOST, 0] + 1j * ri[:N_HOST, 1]).astype(np.complex64)
    t0 = time.perf_counter()
    hdec(zs[0])
    log(f"[host] warm-up decode of one window: "
        f"{time.perf_counter() - t0:.3f} s")
    reset_all_counters()
    res, ms = [], []
    for z in zs:
        t0 = time.perf_counter()
        res.append(hdec(z))
        ms.append((time.perf_counter() - t0) * 1e3)
    dt = sum(ms) / N_HOST / 1e3
    launches, plain = read_counters()
    log(f"[host] launches during {N_HOST} decodes: {launches}; plain calls: "
        f"{plain}")
    require(launches["probe_powers"] > 0 and launches["select_best"] > 0,
            f"a kernel of the host path was not launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"a plain version ran on the host path: {plain}")
    ok = sum(EXPECTED in [s.message for s in r.spots] for r in res)
    log(f"[host] {ok}/{N_HOST} windows decoded to '{EXPECTED}'")
    require(ok == N_HOST, f"host engine: only {ok}/{N_HOST} decoded")
    log(f"[host] {card}: {dt * 1e3:.3f} ms/window (WindowDecoder("
        f"PipelineConfig()), mean of {N_HOST} after one warm-up; median "
        f"{float(np.median(ms)):.3f}, p90 {float(np.percentile(ms, 90)):.3f})"
        f"; stages "
        f"{json.dumps(hdec.timers.summary())}")
    noise = noise_windows(4)
    nz = noise[:, 0] + 1j * noise[:, 1]
    nspots = sum(len(hdec(z).spots) for z in nz)
    require(nspots == 0, f"host engine: noise windows gave {nspots} spots")
    log("[host] 4 noise-only windows: 0 spots")

    jdec = WindowDecoder(dataclasses.replace(PipelineConfig(),
                                             fano_backend="jax"),
                         device="cuda")
    reset_all_counters()
    jres = [jdec(z) for z in zs]
    jl, jp = read_counters()
    require(jl["fano_decode"] > 0 and jp["fano_decode"] == 0,
            f"fano_backend='jax': Fano kernel {jl}, plain {jp}")
    for w, (a, b) in enumerate(zip(res, jres)):
        require([(spot_key(s), s.payload) for s in a.spots]
                == [(spot_key(s), s.payload) for s in b.spots],
                f"host engine window {w}: native and jax Fano spots differ")
    log(f"[host] fano_backend='jax': same spots in {N_HOST} windows, Fano "
        f"kernel launched {jl['fano_decode']} times")

    small = [zs[0], nz[0]]
    cdec = WindowDecoder(PipelineConfig(), device="cpu")
    dfreq = dsync = 0.0
    for w, z in enumerate(small):
        g, c = hdec(z), cdec(z)
        for key in ("n_candidates", "n_worth_a_try", "n_fano_attempts"):
            require(getattr(g, key) == getattr(c, key),
                    f"host cuda vs cpu window {w}: {key} differs")
        require([spot_key(s) for s in g.spots]
                == [spot_key(s) for s in c.spots],
                f"host cuda vs cpu window {w}: spots differ")
        for a, b in zip(g.spots, c.spots):
            dfreq = max(dfreq, abs(a.freq - b.freq))
            dsync = max(dsync, abs(a.sync - b.sync))
    require(dfreq <= 1e-3 and dsync <= 1e-4,
            f"host cuda vs cpu: |dfreq| {dfreq:.3g}, |dsync| {dsync:.3g}")
    log(f"[host] 2-window input, cuda vs the port's cpu run: counts, "
        f"messages, candidate, jiggle, shift, mode equal; |dfreq| "
        f"{dfreq:.3g} Hz, |dsync| {dsync:.3g}")
    return launches, dt


# ---------------------------------------------------------------- phase 9

def phase_pallas_slice(card, dec, ri_c):
    import torch

    from uwspr_tpu_torch.config import (CoarseConfig, PipelineConfig,
                                  with_serving_defaults)
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    pdec = DeviceDecoder(with_serving_defaults(
        PipelineConfig(coarse=CoarseConfig(stft_impl="pallas")), N_WINDOWS),
        device="cuda")
    pdec.decode_windows_ri(ri_c)
    torch.cuda.synchronize()
    reset_all_counters()
    out = pdec.decode_windows_ri(ri_c)
    torch.cuda.synchronize()
    launches, plain = read_counters()
    log(f"[pallas] launches in one decode: {launches}; plain calls: {plain}")
    require(launches["stft_power"] > 0 and launches["select_best"] > 0
            and launches["fano_decode"] > 0,
            f"a kernel of the pallas-STFT path was not launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"a plain version ran on the pallas-STFT path: {plain}")
    typed = pdec.unpack_output(out)
    ok = sum(EXPECTED in pdec.messages(typed.window(w))
             for w in range(N_WINDOWS))
    log(f"[pallas] {ok}/{N_WINDOWS} windows decoded to '{EXPECTED}'")
    require(ok == N_WINDOWS, f"pallas STFT: only {ok}/{N_WINDOWS} decoded")

    reps = 3

    def batch_ms(d):
        t0 = time.perf_counter()
        for _ in range(reps):
            d.decode_windows_ri(ri_c)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps / N_WINDOWS
    d1, p1, p2, d2 = (batch_ms(dec), batch_ms(pdec), batch_ms(pdec),
                      batch_ms(dec))
    log(f"[pallas] {card}: stft_impl='pallas' {(p1 + p2) / 2:.4f} ms/window,"
        f" default (matmul_bf16) {(d1 + d2) / 2:.4f} ms/window (turns d/p/p/d"
        f" {d1:.4f}, {p1:.4f}, {p2:.4f}, {d2:.4f}; {reps} batches of "
        f"{N_WINDOWS} each)")
    return launches


# ---------------------------------------------------------------- phase 10

RING_CH = 128          # channels of the serving stream
RING_SIGNAL = 124      # channels 0..123 carry one frame; the rest noise only
RING_HOPS = 24         # 81,000 samples (216 s) of 375 S/s baseband
HOP, FL = 3375, 45000
PREFILL = -(-FL // HOP) - 1          # 13 hops before the ring decodes
FRAME = 162 * 256                    # samples of one frame
HTOD_SLACK = 64 * 1024               # bytes beside the block per hop
PADDED_CH = 100        # BatchedStreamDecoder channels whose last batch is
                       # short: 11 windows each, 8 x 128 + 76


def runtime_config():
    """The serving configuration of the runtime phase: narrowband, 17
    jiggles, maxcycles 10,000, under with_serving_defaults at C = 128."""
    from uwspr_tpu_torch.config import PipelineConfig, with_serving_defaults
    return with_serving_defaults(PipelineConfig(), RING_CH)


def base_config():
    """What a user of StreamDecoder and BatchedStreamDecoder passes; they
    apply the serving defaults of their own batch width on the card."""
    from uwspr_tpu_torch.config import PipelineConfig
    return PipelineConfig()


def make_stream(seed: int = 11):
    """(RING_CH, RING_HOPS * HOP) complex64 noise at SNR_DB, each of the
    first RING_SIGNAL channels with one EXPECTED frame at a random
    frequency offset. A frame sits in ring window k (samples
    [(k+1)*HOP - FL, (k+1)*HOP), k >= PREFILL, random) at an offset in
    [160, 750) or [1300, 2000); so that ring window holds it whole, the
    ones before and after do not (that takes an offset <= 153 or >= 3375),
    and the host windower's window (start j*HOP) that holds it whole, if
    any, has it at offset <= 3000 or <= 875 (lags the coarse search
    reaches). Returns (z, {channel: frame start})."""
    from uwspr_tpu_torch.io.channel import noise_sigma
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    rng = np.random.default_rng(seed)
    n = RING_HOPS * HOP
    s = noise_sigma(SNR_DB)
    z = (rng.normal(scale=s, size=(RING_CH, n))
         + 1j * rng.normal(scale=s, size=(RING_CH, n))).astype(np.complex64)
    starts = {}
    for c in range(RING_SIGNAL):
        k = int(rng.integers(PREFILL, RING_HOPS))
        off = int(rng.integers(160, 1450))
        off = off if off < 750 else off - 750 + 1300
        starts[c] = (k + 1) * HOP - FL + off
        frame = synthesize_frame("VE3EMB", "FN25", 30, pad_to=None,
                                 freq_offset=float(rng.uniform(-5, 5)))
        z[c, starts[c]:starts[c] + FRAME] += frame
        require(holds(starts, c, ring_starts()) == [k],
                f"frame placement of channel {c}")
    return z, starts


def ring_starts():
    """{ring hop k: first sample of the window the ring decodes after k}."""
    return {k: (k + 1) * HOP - FL for k in range(PREFILL, RING_HOPS)}


def windower_starts():
    """{window index j: first sample} of the host windower's windows."""
    return {j: j * HOP for j in range((RING_HOPS * HOP - FL) // HOP + 1)}


def coverage(start: int, lo: int) -> str:
    """How the window [lo, lo + FL) holds the frame at ``start``."""
    if lo <= start and start + FRAME <= lo + FL:
        return "whole"
    if start + FRAME <= lo or start >= lo + FL:
        return "none"
    return "partial"


def holds(starts, c, windows) -> list:
    """The windows (keys of ``windows``) that hold channel c's frame
    whole."""
    return [w for w, lo in windows.items()
            if coverage(starts[c], lo) == "whole"]


def hop_block(z, k):
    return z[:, k * HOP:(k + 1) * HOP]


def ring_windows(z, k, dev):
    """The ring's windows after hop k, sliced from the stream: the newest FL
    samples of every channel as (C, 2, FL) float32 on ``dev``."""
    import torch
    return torch.from_numpy(to_ri(z[:, (k + 1) * HOP - FL:(k + 1) * HOP])
                            ).to(dev)


def check_found(found, holds, what):
    """found {(window, channel): [messages]}: every channel of ``holds``
    decodes EXPECTED in a window that holds its frame whole, and the noise
    channels decode nothing."""
    for c, ws in holds.items():
        require(any(EXPECTED in found.get((w, c), []) for w in ws),
                f"{what}: channel {c} decodes no frame in its windows {ws}")
    noisy = {k: v for k, v in found.items() if k[1] >= RING_SIGNAL and v}
    require(not noisy, f"{what}: noise channels decoded {noisy}")


def spot_fields(ring, handle):
    """{(channel, message, freq, shift, jiggle)} of one ring handle."""
    return sorted((c, s.message, s.freq, s.shift, s.jiggle)
                  for c, s in ring.spots(ring.fetch(handle)))


def profile_hops(ring, blocks):
    """ring.push_hop(b) for b in blocks under torch.profiler, the first hop
    a warm-up the trace leaves out (CUPTI can miss the first copy it
    sees): per traced hop, the host-to-device bytes (the memcpy events'
    byte counts), the wall time, the device time of all kernels and of the
    Fano and selection kernels, and the idle share (1 - kernel time / wall
    time)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    n = len(blocks) - 1
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(path))) as prof:
            for i, b in enumerate(blocks):
                if i == 1:
                    t0 = time.perf_counter()
                ring.push_hop(b)
                torch.cuda.synchronize()
                if i == n:      # before the last step writes the trace
                    wall = (time.perf_counter() - t0) * 1e3 / n
                prof.step()
        events = json.loads(path.read_text())["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    require(copies, "the profiler trace holds no host-to-device copy")
    kernels = [e for e in events if e.get("cat") == "kernel"]

    def ms(pred):
        return sum(float(e["dur"]) for e in kernels
                   if pred(e["name"])) / 1e3 / n
    busy = ms(lambda name: True)
    return {"htod_bytes": sum(int(e["args"]["bytes"]) for e in copies) / n,
            "wall_ms": wall, "kernel_ms": busy,
            "fano_ms": ms(lambda name: "fano_kernel" in name),
            "select_ms": ms(lambda name: "select_best_kernel" in name),
            "idle_share": 1.0 - busy / wall}


def phase_runtimes(card):
    """The serving runtimes on the card (see the module doc, phase 10)."""
    import dataclasses
    import tempfile

    import torch

    from uwspr_tpu_torch.pipeline.device_ring import (DeviceRingDecoder,
                                                      RingServe)
    from uwspr_tpu_torch.pipeline.stream import (BatchedStreamDecoder,
                                                 StreamDecoder)
    dev = "cuda"
    cfg = runtime_config()
    z, starts = make_stream()
    ring_holds = {c: holds(starts, c, ring_starts()) for c in starts}
    win_holds = {c: holds(starts, c, windower_starts()) for c in starts}
    log(f"[serve] stream: {RING_CH} channels x {RING_HOPS} hops "
        f"({RING_HOPS * HOP} samples), frames in {RING_SIGNAL} channels")

    # RingServe, what `uwspr serve --runtime ring` builds: the main path
    serve = RingServe(cfg, n_channels=RING_CH, device=dev)
    reset_all_counters()
    found = {}
    for k in range(RING_HOPS):
        for c, r in serve.push(hop_block(z, k)):
            found.setdefault((k, c), []).extend(s.message for s in r.spots)
    torch.cuda.synchronize()
    launches, plain = read_counters()
    log(f"[serve] RingServe launches over {RING_HOPS} hops: {launches}; "
        f"plain calls: {plain}")
    require(launches["select_best"] > 0 and launches["fano_decode"] > 0,
            f"a kernel of the ring path was not launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"a plain version ran on the ring path: {plain}")
    require(len(found) == (RING_HOPS - PREFILL) * RING_CH,
            f"RingServe reported {len(found)} channel-windows")
    check_found(found, ring_holds, "RingServe")
    log(f"[serve] RingServe: all {RING_SIGNAL} frames decoded in the window "
        f"that holds them whole; {RING_CH - RING_SIGNAL} noise channels "
        f"decoded nothing ({serve.stats.spots} spots in "
        f"{serve.stats.windows} channel-windows)")
    del serve

    # every hop bitwise equal to the decoder on the sliced windows
    ring = DeviceRingDecoder(cfg, n_channels=RING_CH, device=dev)
    ref, half = {}, None
    for k in range(RING_HOPS):
        if k == RING_HOPS // 2:
            half = ring.state()
        h = ring.push_hop(hop_block(z, k))
        require((h is None) == (k < PREFILL), f"ring handle at hop {k}")
        if h is not None:
            ref[k] = h
            want = ring.decoder.decode_windows_ri(
                ring_windows(z, k, ring.decoder.device))
            require(torch.equal(h, want),
                    f"ring hop {k} differs from the decoder on the sliced "
                    f"windows")
    log(f"[serve] DeviceRingDecoder: {len(ref)} hops, each bitwise equal to "
        f"DeviceDecoder.decode_windows_ri on the {RING_CH} windows sliced "
        f"at the ring's boundaries")

    r2 = DeviceRingDecoder(cfg, n_channels=RING_CH, device=dev)
    r2.restore(half)
    for k in range(RING_HOPS // 2, RING_HOPS):
        h = r2.push_hop(hop_block(z, k))
        if k >= PREFILL:
            require(torch.equal(h, ref[k]), f"resumed ring hop {k} differs")
    del r2
    log(f"[serve] state() at hop {RING_HOPS // 2}, restore() in a new ring: "
        f"tail bitwise equal")

    r3 = DeviceRingDecoder(cfg, n_channels=RING_CH, device=dev)
    for k in range(PREFILL):
        r3.push_hop(hop_block(z, k))
    out = r3.push_hops(np.stack([hop_block(z, PREFILL + i)
                                 for i in range(4)]))
    require(all(torch.equal(out[i], ref[PREFILL + i]) for i in range(4)),
            "push_hops(4) differs from four push_hop calls")
    log("[serve] push_hops(4) bitwise equal to four push_hop calls")

    r4 = DeviceRingDecoder(cfg, n_channels=RING_CH, device=dev)
    last = PREFILL + 4
    nxt = r4.stage(hop_block(z, 0))
    for k in range(last):
        cur = nxt
        if k + 1 < last:
            nxt = r4.stage(hop_block(z, k + 1))      # copy while k decodes
        h = r4.push_hop(cur)
        if h is not None:
            require(torch.equal(h, ref[k]), f"staged hop {k} differs")
    host = r4.stage(hop_block(z, 0)).host
    require(bool(host) and all(x.is_pinned() for x in host),
            "stage() does not copy from pinned memory")
    del r4
    log("[serve] stage() (pinned buffer, copy stream, event) then "
        "push_hop(staged): bitwise equal to push_hop(block)")

    r16 = DeviceRingDecoder(cfg, n_channels=RING_CH, ingest_dtype="int16",
                            device=dev)
    found16 = {}
    for k in range(RING_HOPS):
        h = r16.push_hop(hop_block(z, k))
        if h is not None:
            for c, s in r16.spots(r16.fetch(h)):
                found16.setdefault((k, c), []).append(s.message)
    check_found(found16, ring_holds, "int16 ring")

    def per_channel(f):
        return {c: {m for (_, cc), ms in f.items() if cc == c for m in ms}
                for c in range(RING_CH)}
    require(per_channel(found16) == per_channel(found),
            "int16 ingest decodes other messages than f32 ingest")
    log("[serve] ingest_dtype='int16': the same messages in every channel")

    htod = {}
    block_bytes = {"f32": RING_CH * 2 * HOP * 4, "int16": RING_CH * 2 * HOP * 2
                   + RING_CH * 4}
    for name, r, k0 in (("f32", r3, PREFILL + 4), ("int16", r16, 0)):
        prof = profile_hops(r, [hop_block(z, (k0 + i) % RING_HOPS)
                                for i in range(5)])
        htod[name] = prof["htod_bytes"]
        require(block_bytes[name] <= htod[name]
                <= block_bytes[name] + HTOD_SLACK,
                f"{name} ring: {htod[name]:.0f} B host-to-device per hop, "
                f"block {block_bytes[name]} B")
        log(f"[serve] {card}: {name} ring under torch.profiler, per hop: "
            f"wall {prof['wall_ms']:.3f} ms, kernels {prof['kernel_ms']:.3f} "
            f"ms (Fano {prof['fano_ms']:.3f}, selection "
            f"{prof['select_ms']:.3f}), idle share "
            f"{prof['idle_share']:.4f}")
    full = RING_CH * 2 * FL * 4
    log(f"[serve] host-to-device bytes per steady-state hop (torch.profiler, "
        f"4 hops after a warm-up hop): f32 {htod['f32']:.0f} B (block {block_bytes['f32']} B), "
        f"int16 {htod['int16']:.0f} B (block + scales "
        f"{block_bytes['int16']} B); full f32 windows would be {full} B")
    del r3, r16

    rh = DeviceRingDecoder(cfg, n_channels=RING_CH, fano_mode="host",
                           device=dev)
    for k in range(RING_HOPS):
        h = rh.push_hop(hop_block(z, k))
        if h is not None:
            require(spot_fields(rh, h) == spot_fields(ring, ref[k]),
                    f"hybrid (native Fano) spots differ at hop {k}")
    del rh
    rj = DeviceRingDecoder(dataclasses.replace(cfg, fano_backend="jax"),
                           n_channels=RING_CH, fano_mode="host", device=dev)
    reset_all_counters()
    for k in range(PREFILL + 2):
        h = rj.push_hop(hop_block(z, k))
        if h is not None:
            require(spot_fields(rj, h) == spot_fields(ring, ref[k]),
                    f"hybrid (jax Fano) spots differ at hop {k}")
    jl, jp = read_counters()
    require(jl["fano_decode"] > 0 and jp["fano_decode"] == 0,
            f"hybrid fano_backend='jax': Fano kernel {jl}, plain {jp}")
    del rj
    log(f"[serve] hybrid (fano_mode='host'): native Fano spots equal device "
        f"mode's in all {len(ref)} hops (message, freq, shift, jiggle); "
        f"fano_backend='jax' the same, Fano kernel launched "
        f"{jl['fano_decode']} times")

    n_win = (RING_HOPS * HOP - FL) // HOP + 1
    for n_ch in (RING_CH, PADDED_CH):
        bsd = BatchedStreamDecoder(base_config(), n_channels=n_ch,
                                   batch_windows=128, device=dev)
        seen, res = {}, []
        for k in range(RING_HOPS):
            res.extend(bsd.push(hop_block(z[:n_ch], k)))
        pushed = len(res)
        res.extend(bsd.flush())
        bfound = {}
        for c, r in res:
            j = seen[c] = seen.get(c, -1) + 1
            bfound[(j, c)] = [s.message for s in r.spots]
        require(len(res) == n_ch * n_win and bsd.windower.dropped == 0,
                f"BatchedStreamDecoder: {len(res)} windows, dropped "
                f"{bsd.windower.dropped}")
        for c in range(min(n_ch, RING_SIGNAL)):
            for j in win_holds[c]:
                require(EXPECTED in bfound[(j, c)],
                        f"BatchedStreamDecoder: channel {c} window {j} holds "
                        f"a whole frame and did not decode it")
        check_found(bfound, {c: win_holds[c] for c in range(min(
            n_ch, RING_SIGNAL)) if win_holds[c]}, "BatchedStreamDecoder")
        if n_ch == RING_CH:
            single = {"batched": bfound}
        short = len(res) - pushed
        require(short == (n_ch * n_win) % 128,
                f"BatchedStreamDecoder flush gave {short} windows")
        log(f"[serve] BatchedStreamDecoder(batch_windows=128), {n_ch} "
            f"channels: {len(res)} windows, {pushed} in full batches, "
            f"{short} in the zero-padded flush; every window that holds a "
            f"whole frame decoded it; dropped 0")
        del bsd

    chans = [c for c in range(RING_SIGNAL) if win_holds[c]][:2]
    sub = z[chans]
    runs = {}
    for engine in ("device", "hybrid", "host"):
        sd = StreamDecoder(base_config(), n_channels=2, engine=engine,
                           device=dev)
        reset_all_counters()
        runs[engine] = [(k, ch, sorted({s.message for s in r.spots}))
                        for k in range(RING_HOPS)
                        for ch, r in sd.push(hop_block(sub, k))]
        launches_e, plain_e = read_counters()
        want = {"device": ("select_best", "fano_decode"),
                "hybrid": ("select_best",),
                "host": ("probe_powers", "select_best")}[engine]
        require(all(launches_e[w] > 0 for w in want)
                and all(v == 0 for v in plain_e.values()),
                f"StreamDecoder({engine}): launches {launches_e}, plain "
                f"{plain_e}")
        for i, c in enumerate(chans):
            for j in win_holds[c]:
                require(EXPECTED in runs[engine][j * 2 + i][2],
                        f"StreamDecoder({engine}): channel {c} window {j}")
        log(f"[serve] StreamDecoder(engine={engine!r}) on channels {chans}: "
            f"{len(runs[engine])} windows; launches {launches_e}")
    # every window: (hop, channel, messages); window j of each channel comes
    # at hop PREFILL + j. The engines must agree where a window holds a
    # whole frame or none of it; a window that cuts a frame is reported
    require(runs["device"] == runs["hybrid"],
            "StreamDecoder device and hybrid engines disagree")
    cut = []
    for a, b in zip(runs["device"], runs["host"]):
        k, ch = a[0], a[1]
        cov = coverage(starts[chans[ch]], (k - PREFILL) * HOP)
        if a != b:
            require(cov == "partial", f"StreamDecoder device {a} and host "
                    f"{b} disagree on a window that holds {cov} frame")
            cut.append((a, b))
    require(len(runs["device"]) == len(runs["host"]), "window counts")
    sd1 = StreamDecoder(base_config(), n_channels=2, engine="device",
                        device=dev)
    split = RING_HOPS // 2
    for k in range(split):
        sd1.push(hop_block(sub, k))
    with tempfile.TemporaryDirectory() as tmp:
        sd1.save_checkpoint(tmp)
        sd2 = StreamDecoder(base_config(), n_channels=2, engine="device",
                            device=dev)
        sd2.load_checkpoint(tmp)
    tail = [(k, ch, sorted({s.message for s in r.spots}))
            for k in range(split, RING_HOPS)
            for ch, r in sd2.push(hop_block(sub, k))]
    require(tail == [x for x in runs["device"] if x[0] >= split],
            "StreamDecoder resumed from a checkpoint gives other spots")
    log(f"[serve] StreamDecoder: device and hybrid engines agree in all "
        f"{len(runs['host'])} windows, the host engine in all but "
        f"{len(cut)} windows that cut a frame {cut}; checkpoint at hop "
        f"{split} and resume: the same tail")
    # {(window, channel): messages} of StreamDecoder's device engine
    single["stream"] = {(k - PREFILL, chans[ch]): m
                        for k, ch, m in runs["device"]}
    return launches, htod, z, ring, single


def time_runtime_turns(cases):
    """cases [(name, setup, run)]: run() does some units of work (hops,
    windows) and returns their count. In turns A B .. B A, each turn runs
    setup() untimed, then run() between CUDA events behind the spin kernel,
    then setup() and run() again on the host clock ending in a
    synchronize. Returns {name: (event ms per unit, wall ms per unit,
    event turns, wall turns)}."""
    import torch
    ev = {name: [] for name, _, _ in cases}
    wall = {name: [] for name, _, _ in cases}
    for name, setup, run in cases:         # warm-up
        setup()
        run()
    torch.cuda.synchronize()
    for name, setup, run in list(cases) + list(reversed(cases)):
        setup()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        n = run()
        e.record()
        torch.cuda.synchronize()
        ev[name].append(s.elapsed_time(e) / n)
        setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        wall[name].append((time.perf_counter() - t0) * 1e3 / n)
    return {name: (sum(ev[name]) / len(ev[name]),
                   sum(wall[name]) / len(wall[name]), ev[name], wall[name])
            for name, _, _ in cases}


def timing_runtimes(card, z, ring, htod):
    """ms per hop of the ring (f32 and int16 ingest) beside the DeviceDecoder
    on the same windows, ms per window of BatchedStreamDecoder and of
    StreamDecoder(engine="device")."""
    from uwspr_tpu_torch.pipeline.device_ring import DeviceRingDecoder
    from uwspr_tpu_torch.pipeline.stream import (BatchedStreamDecoder,
                                                 StreamDecoder)
    dev = "cuda"
    cfg = runtime_config()
    rings = {"f32": ring,
             "int16": DeviceRingDecoder(cfg, n_channels=RING_CH,
                                        ingest_dtype="int16", device=dev)}
    prefill = {}
    for name, r in rings.items():
        r.restore({"ring": np.zeros((RING_CH, 2, FL), np.float32),
                   "filled": 0})
        for k in range(PREFILL):
            r.push_hop(hop_block(z, k))
        prefill[name] = r.state()
    windows = [ring_windows(z, k, ring.decoder.device)
               for k in range(PREFILL, RING_HOPS)]
    state = {}

    def ring_case(name):
        r = rings[name]

        def setup():
            r.restore(prefill[name])

        def run():
            for k in range(PREFILL, RING_HOPS):
                r.push_hop(hop_block(z, k))
            return RING_HOPS - PREFILL
        return (f"ring {name}", setup, run)

    def decoder_run():
        for w in windows:
            ring.decoder.decode_windows_ri(w)
        return len(windows) * RING_CH

    def batched_setup():
        state["bsd"] = BatchedStreamDecoder(base_config(), n_channels=RING_CH,
                                            batch_windows=128, device=dev)

    def batched_run():
        bsd = state["bsd"]
        return sum(len(bsd.push(hop_block(z, k)))
                   for k in range(RING_HOPS)) + len(bsd.flush())

    def stream_setup():
        state["sd"] = StreamDecoder(base_config(), n_channels=1,
                                    engine="device", device=dev)

    def stream_run():
        return sum(len(state["sd"].push(hop_block(z[:1], k)))
                   for k in range(RING_HOPS))
    t = time_runtime_turns([ring_case("f32"), ring_case("int16"),
                            ("decoder", lambda: None, decoder_run),
                            ("batched", batched_setup, batched_run),
                            ("stream", stream_setup, stream_run)])

    def fmt(name):
        ev, wall, evt, wallt = t[name]
        return (f"{ev:.4f} ms (events; turns "
                f"{', '.join(f'{x:.4f}' for x in evt)}), wall {wall:.4f} ms "
                f"(turns {', '.join(f'{x:.4f}' for x in wallt)})")
    for name in ("f32", "int16"):
        ev = t[f"ring {name}"][0]
        log(f"[timing] {card}: ring {name} ingest, C = {RING_CH}: "
            f"{fmt('ring ' + name)} per hop, {RING_CH / ev * 1e3:.1f} "
            f"channel-windows/s; host-to-device {htod[name]:.0f} B per hop")
    log(f"[timing] {card}: DeviceDecoder W = {RING_CH} on the ring's windows: "
        f"{fmt('decoder')} per window ({t['decoder'][0] * RING_CH:.3f} ms "
        f"per batch, the ring {t['ring f32'][0]:.3f} ms per hop)")
    log(f"[timing] {card}: BatchedStreamDecoder(batch_windows=128) over "
        f"{RING_CH} channels: {fmt('batched')} per window")
    log(f"[timing] {card}: StreamDecoder(engine='device'), W = 1: "
        f"{fmt('stream')} per window")
    return {name: {"ms": v[0], "wall_ms": v[1]} for name, v in t.items()}


# ---------------------------------------------------------------- phase 11

WB_WINDOWS = 32
WB_CALLS = ["K1ABC", "W9XYZ", "N2AB", "VE3EMB", "G4CDE",
            "JA1FG", "VK2HI", "PY3JK", "ZS6LM", "OH2NP"]
WB_GRIDS = ["FN42", "EM12", "FN31", "FN25", "IO91",
            "PM95", "QF56", "GF49", "KG33", "KP20"]
WB_SNR_DB = -15.0
WB_HOST = 2             # of its windows through the host engine


def wideband_windows(seed: int = 3):
    """scripts/bench_matrix.py:106-137's scene: WB_WINDOWS windows of noise
    at WB_SNR_DB, each with the 10 frames of WB_CALLS spread across +/-170
    Hz; returns (ri, the expected message set of each window)."""
    from uwspr_tpu_torch.io.channel import noise_sigma
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    rng = np.random.default_rng(seed)
    sigma = noise_sigma(WB_SNR_DB)
    base = np.linspace(-170, 170, len(WB_CALLS))
    wins, expected = [], []
    for _ in range(WB_WINDOWS):
        z = (rng.normal(scale=sigma, size=45000)
             + 1j * rng.normal(scale=sigma, size=45000)).astype(np.complex64)
        exp = set()
        for k, (call, grid) in enumerate(zip(WB_CALLS, WB_GRIDS)):
            f = float(base[k] + rng.uniform(-2, 2))
            z += synthesize_frame(call, grid, 30,
                                  start_sample=int(rng.integers(0, 2000)),
                                  freq_offset=f, pad_to=45000)
            exp.add(f"{call} {grid} 30")
        wins.append(z)
        expected.append(exp)
    return to_ri(np.stack(wins)), expected


def decode_timed(dec, ri_c, reps=1):
    """(last packed output, ms/window by CUDA events, ms/window wall)."""
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.record()
    for _ in range(reps):
        out = dec.decode_windows_ri(ri_c)
    e.record()
    torch.cuda.synchronize()
    W = ri_c.shape[0] * reps
    return (out, s.elapsed_time(e) / W,
            (time.perf_counter() - t0) * 1e3 / W)


def kernel_calls():
    """A recorder of every selection and Fano call of the device engine and
    every selection and probe call of the host engine, for a replay
    against their oracles (uwspr_tpu_torch/harness/replay.py)."""
    from uwspr_tpu_torch.harness.replay import KernelReplay
    return KernelReplay()


def replay_path(calls, what):
    """Every call that ``calls`` recorded held to its oracle
    (KernelReplay.replay: selection bitwise, Fano bit-exact with the
    inactive lanes to the kernel's contract, probe within PROBE_RTOL and
    PROBE_ATOL); fails on any difference; the calls and lanes replayed go
    to REPLAYED."""
    t0 = time.perf_counter()
    r = calls.replay()
    require(r["ok"], f"{what}: the path's kernel calls differ from their "
            f"oracles: {r['failures'][:5]}")
    log(f"[{what}] the path's own kernel inputs replayed: "
        f"{r['select_calls']} select_best calls ({r['select_lanes']} lanes) "
        f"== select_best_plain (best bitwise, idx equal); "
        f"{r['fano_calls']} fano_decode calls ({r['fano_active_lanes']} "
        f"active lanes, {r['fano_timeouts']} full-budget timeouts) == "
        f"native fano_native.cc (bit-exact), inactive lanes to contract; "
        f"{r['probe_calls']} probe_powers calls ({r['probe_candidates']} "
        f"candidates) == probe_powers_plain within tolerance (max |diff| "
        f"{r['probe_max_abs_err']:.3g}); {time.perf_counter() - t0:.2f} s")
    REPLAYED[what] = r


REPLAYED = {}           # path -> the kernel calls its replay held to oracles


def path_run(dec, ri_c, kernels, what):
    """One decode of the path with every count set to 0 just before it and
    read just after: the path's kernels launched, no plain version called;
    then every selection and Fano call of that decode replayed against its
    oracle (replay_path). Returns (packed output, launches, the
    recorded calls)."""
    import torch
    with kernel_calls() as calls:
        reset_all_counters()
        out = dec.decode_windows_ri(ri_c)
        torch.cuda.synchronize()
        launches, plain = read_counters()
    log(f"[{what}] launches in one decode: {launches}; plain calls: "
        f"{plain}")
    require(all(launches[k] > 0 for k in kernels),
            f"{what}: a kernel of the path was not launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"{what}: a plain version ran on the path: {plain}")
    replay_path(calls, what)
    return out, launches, calls


def phase_wideband(card):
    """The wideband configuration (the GNU Radio block's default
    halfbandwidth 187: the whole 512-bin spectrum, C = 200) at W = 32."""
    import dataclasses

    import torch

    from uwspr_tpu_torch.config import (CoarseConfig, PipelineConfig,
                                        with_serving_defaults)
    from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    ri, expected = wideband_windows()
    ri_c = torch.from_numpy(ri).cuda()
    coarse = CoarseConfig(halfbandwidth=187, maxfreqs=200)
    cfg = with_serving_defaults(PipelineConfig(coarse=coarse), WB_WINDOWS)
    dec = DeviceDecoder(cfg, device="cuda")
    d = cfg.demod
    log(f"[wideband] hpbm {cfg.coarse.hpbm}, C = {dec.n_cand}, columns "
        f"{dec._cols}, caps cand/refine/fano {d.cand_compact_lanes}/"
        f"{d.refine_max_lanes}/{d.fano_compact_lanes}, stft "
        f"{cfg.coarse.stft_impl}, grid auto (einsum, bf16)")
    t0 = time.perf_counter()
    dec.decode_windows_ri(ri_c)
    torch.cuda.synchronize()
    log(f"[wideband] warm-up decode of {WB_WINDOWS} windows: "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    out, launches, calls = path_run(dec, ri_c, ("select_best",
                                                "fano_decode"), "wideband")
    peak = torch.cuda.max_memory_allocated()
    a = out.cpu().numpy()
    require(a.shape == (WB_WINDOWS, 200, 23) and bool(np.isfinite(a).all()),
            f"wideband output shape {a.shape} or non-finite values")
    typed = dec.unpack_output(a)
    found = [set(dec.messages(typed.window(w))) for w in range(WB_WINDOWS)]
    n_dec = sum(len(found[w] & expected[w]) for w in range(WB_WINDOWS))
    n_exp = sum(len(e) for e in expected)
    extra = sum(len(found[w] - expected[w]) for w in range(WB_WINDOWS))
    log(f"[wideband] {n_dec}/{n_exp} frames decoded, {extra} other "
        f"messages; fano_attempts {int(typed.fano_attempts.sum())}, "
        f"fano_overflow {int(typed.fano_overflow.sum())}; peak device "
        f"memory {peak / 2**20:.1f} MiB")
    require(n_dec == n_exp, f"wideband: only {n_dec}/{n_exp} decoded")

    pdec = DeviceDecoder(with_serving_defaults(PipelineConfig(
        coarse=dataclasses.replace(coarse, stft_impl="pallas")), WB_WINDOWS),
        device="cuda")
    pdec.decode_windows_ri(ri_c)
    pout, plaunches, _ = path_run(pdec, ri_c, ("stft_power", "select_best",
                                               "fano_decode"),
                                  "wideband pallas")
    ptyped = pdec.unpack_output(pout)
    require([set(pdec.messages(ptyped.window(w))) for w in range(WB_WINDOWS)]
            == found, "wideband: the pallas STFT gives other message sets")
    log(f"[wideband] stft_impl='pallas': the same message sets, STFT kernel "
        f"at ({WB_WINDOWS}, 348, 512)")

    z_all = torch.complex(ri_c[:, 0], ri_c[:, 1])
    (grid, is_nl, *_), = calls.select       # the path's own grid
    grid, is_nl = grid.cuda(), is_nl.cuda()

    hdec = WindowDecoder(PipelineConfig(coarse=coarse), device="cuda")
    for w in range(WB_HOST):
        hs = {s.message for s in hdec(ri[w, 0] + 1j * ri[w, 1]).spots}
        require(hs == found[w], f"wideband window {w}: host engine "
                f"{sorted(hs)} against device {sorted(found[w])}")
    log(f"[wideband] host engine WindowDecoder(PipelineConfig(coarse=...)), "
        f"{WB_HOST} windows: the device engine's message sets")

    turns = [decode_timed(d_, ri_c, 2)[1:] for d_ in (dec, pdec, pdec, dec)]
    ms = {"auto": [turns[0], turns[3]], "pallas": [turns[1], turns[2]]}
    for k, v in ms.items():
        log(f"[wideband] {card}: stft {k}: "
            f"{sum(t[0] for t in v) / 2:.4f} ms/window by CUDA events, "
            f"{sum(t[1] for t in v) / 2:.4f} wall (turns "
            f"{', '.join(f'{t[0]:.4f}/{t[1]:.4f}' for t in v)}; 2 batches "
            f"of {WB_WINDOWS} each)")
    return {"launches": launches, "pallas_launches": plaunches,
            "grid": grid, "is_nl": is_nl, "z": z_all,
            "stft": (dec._cols, dec._stft_consts),
            "ms": {k: sum(t[0] for t in v) / 2 for k, v in ms.items()},
            "wall_ms": {k: sum(t[1] for t in v) / 2 for k, v in ms.items()},
            "peak_mib": peak / 2**20, "decoded": f"{n_dec}/{n_exp}"}


# ---------------------------------------------------------------- phase 12

OSD_WINDOWS = 32
OSD_SNR_DB = -30.0
OSD_HOST_LANES = 16     # rescue lanes held to the host osd_decode


def deep_windows(seed: int = 5):
    """scripts/bench_matrix.py:157-205's deep-SNR recipe at OSD_SNR_DB:
    one "VE3EMB FN25 30" frame per window (seeded afresh)."""
    from uwspr_tpu_torch.io.channel import awgn
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    rng = np.random.default_rng(seed)
    wins = []
    for _ in range(OSD_WINDOWS):
        z = synthesize_frame("VE3EMB", "FN25", 30,
                             start_sample=int(rng.integers(0, 2000)),
                             freq_offset=float(rng.uniform(-5, 5)))
        wins.append(awgn(z, OSD_SNR_DB, rng=rng))
    return to_ri(np.stack(wins))


def profile_call(fn):
    """fn() under torch.profiler, after one warm-up call the trace leaves
    out: (wall ms, kernel launches, kernel ms, the three kernels with the
    most device time as (name, ms, count))."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(path))) as prof:
            for i in range(2):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                prof.step()
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by = {}
    for e in kernels:
        t, n = by.get(e["name"], (0.0, 0))
        by[e["name"]] = (t + float(e["dur"]) / 1e3, n + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:3]
    return (wall, len(kernels), sum(t for t, _ in by.values()),
            [(k[:60], round(t, 3), n) for k, (t, n) in top])


def phase_osd(card):
    """On-device OSD at order 4 against the same windows with OSD off."""
    import torch

    from uwspr_tpu_torch.config import (DemodConfig, PipelineConfig,
                                        with_serving_defaults)
    from uwspr_tpu_torch.fec.osd import osd_decode
    from uwspr_tpu_torch.pipeline import device_decoder as ddm
    ri_c = torch.from_numpy(deep_windows()).cuda()
    on = ddm.DeviceDecoder(with_serving_defaults(PipelineConfig(
        demod=DemodConfig(osd_depth=4)), OSD_WINDOWS), device="cuda")
    off = ddm.DeviceDecoder(with_serving_defaults(PipelineConfig(),
                                                  OSD_WINDOWS), device="cuda")
    for d_ in (on, off):
        d_.decode_windows_ri(ri_c)
    # the rescue's lanes, as the decoder hands them to osd_torch
    captured = []
    decode_lanes = ddm.osd_decode_lanes

    def recording(lanes, G, order):
        captured.append((lanes.clone(), order))
        return decode_lanes(lanes, G, order)
    ddm.osd_decode_lanes = recording
    try:
        out_on, launches, _ = path_run(on, ri_c, ("select_best",
                                                  "fano_decode"), "osd")
    finally:
        ddm.osd_decode_lanes = decode_lanes
    ton = on.unpack_output(out_on)
    toff = off.unpack_output(off.decode_windows_ri(ri_c))
    s = toff.success
    require(bool(ton.success[s].all()) and np.array_equal(
        ton.payload[s], toff.payload[s]) and not ton.osd[s].any(),
            "osd: a Fano decode of the OSD-off run was not kept")
    spots = [sp for w in range(OSD_WINDOWS) for sp in on.spots(ton.window(w))]
    tagged = [sp for sp in spots if sp.osd > 0]
    fano_ok = sum(EXPECTED in off.messages(toff.window(w))
                  for w in range(OSD_WINDOWS))
    both_ok = sum(EXPECTED in on.messages(ton.window(w))
                  for w in range(OSD_WINDOWS))
    log(f"[osd] {OSD_WINDOWS} windows at {OSD_SNR_DB} dB: Fano alone "
        f"{fano_ok}/{OSD_WINDOWS}, with order-4 device OSD {both_ok}/"
        f"{OSD_WINDOWS}; {len(tagged)} OSD-tagged spots "
        f"{sorted({sp.message for sp in tagged})}; fano_overflow "
        f"{int(ton.fano_overflow.sum())}")
    require(len(tagged) >= 1, "osd: no OSD-tagged spot")
    require(all(sp.message == EXPECTED for sp in tagged),
            "osd: an OSD-tagged spot is not the transmitted message")
    require(len(captured) == 1 and captured[0][1] == 4,
            f"osd: {len(captured)} OSD batches")
    lanes = captured[0][0]
    G = on._osd_G
    u, q, m, f = decode_lanes(lanes, G, 4)
    uc, qc, mc, fc = decode_lanes(lanes.cpu(), G.cpu(), 4)
    require(all(torch.equal(a.cpu(), b) for a, b in
                ((u, uc), (q, qc), (m, mc), (f, fc))),
            "osd: osd_torch on the card differs from the CPU run")
    lanes_np = lanes.cpu().numpy().astype(np.uint8)
    dq = 0.0
    for i in range(min(OSD_HOST_LANES, len(lanes_np))):
        ref = osd_decode(lanes_np[i], order=4)
        require(np.array_equal(u[i].cpu().numpy(), ref.info_bits)
                and int(f[i]) == ref.flips,
                f"osd: lane {i} differs from the host osd_decode")
        dq = max(dq, abs(float(q[i]) - ref.quality),
                 abs(float(m[i]) - ref.margin))
    require(dq < 1e-3, f"osd: quality/margin {dq:.3g} from the host")
    log(f"[osd] {len(lanes_np)} rescue lanes: osd_torch on the card == the "
        f"CPU run (bits, quality, margin, flips); the first "
        f"{min(OSD_HOST_LANES, len(lanes_np))} == host osd_decode order 4 "
        f"(bits, flips; quality/margin within {dq:.3g})")
    ms, turns, _ = time_turns([("osd", lambda: decode_lanes(lanes, G, 4))],
                              {"osd": 3})
    wall, nk, kms, top = profile_call(lambda: decode_lanes(lanes, G, 4))
    log(f"[osd] {card}: the OSD stage under torch.profiler: wall "
        f"{wall:.3f} ms, {nk} kernel launches, kernels {kms:.3f} ms (idle "
        f"share {1 - kms / wall:.4f}); most device time: {top}")
    dturns = [decode_timed(d_, ri_c)[1:] for d_ in (off, on, on, off)]
    log(f"[osd] {card}: the OSD stage (osd_torch order 4 on {len(lanes_np)} "
        f"lanes) {ms['osd']:.3f} ms (turns {fmt_turns(turns)}); decode "
        f"ms/window by CUDA events off {(dturns[0][0] + dturns[3][0]) / 2:.4f}"
        f", on {(dturns[1][0] + dturns[2][0]) / 2:.4f} (turns off/on/on/off "
        f"{', '.join(f'{t[0]:.4f}/{t[1]:.4f}' for t in dturns)}, events/wall)")
    return {"launches": launches, "osd_ms": ms["osd"],
            "osd_kernel_launches": nk, "osd_kernel_ms": kms,
            "osd_lanes": len(lanes_np), "fano_decoded": fano_ok,
            "with_osd_decoded": both_ok, "osd_tagged": len(tagged),
            "ms_off": (dturns[0][0] + dturns[3][0]) / 2,
            "ms_on": (dturns[1][0] + dturns[2][0]) / 2}


# ---------------------------------------------------------------- phase 13

STRONG = ("VE3EMB", "FN25", 30)
WEAK = ("K1ABC", "FN42", 37)


def masked_scene(seed: int = 100, sep_hz: float = 1.5,
                 weak_rel_db: float = -9.0, strong_snr: float = -13.0):
    """tests/test_multipass.py:20-30: a strong frame at 0 Hz and a weak one
    sep_hz away, weak_rel_db below it, in AWGN."""
    from uwspr_tpu_torch.io.channel import awgn
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    rng = np.random.default_rng(seed)
    strong = synthesize_frame(*STRONG, start_sample=int(rng.integers(500,
                                                                     2500)),
                              freq_offset=0.0)
    weak = synthesize_frame(*WEAK, start_sample=int(rng.integers(500, 2500)),
                            freq_offset=sep_hz)
    return awgn(strong + 10.0 ** (weak_rel_db / 20.0) * weak, strong_snr,
                rng=rng)


def phase_multipass(card):
    """StreamDecoder(passes=2) on the card, device and hybrid engines."""
    import torch

    from uwspr_tpu_torch.config import PipelineConfig
    from uwspr_tpu_torch.pipeline.stream import StreamDecoder
    z = masked_scene()
    strong, weak = "VE3EMB FN25 30", "K1ABC FN42 37"
    out = {}
    for engine, kernels in (("device", ("select_best", "fano_decode")),
                            ("hybrid", ("select_best",))):
        res, ms, counts = {}, {}, {}
        calls = kernel_calls()
        for i, passes in enumerate((1, 2, 2, 1)):   # the first two: warm-up
            sd = StreamDecoder(PipelineConfig(), engine=engine,
                               passes=passes, device="cuda")
            # the first passes=2 run records its kernel calls for the
            # replay; the second run of each is the timed one
            with calls if i == 1 else contextlib.nullcontext():
                reset_all_counters()
                t0 = time.perf_counter()
                (_, r), = sd.push(z)
                torch.cuda.synchronize()
                ms[passes] = (time.perf_counter() - t0) * 1e3
                res[passes] = r
                counts[passes] = read_counters()
        replay_path(calls, f"multipass {engine}")
        launches, plain = counts[2]
        require(all(launches[k] > 0 for k in kernels)
                and all(v == 0 for v in plain.values()),
                f"multipass {engine}: launches {launches}, plain {plain}")
        two = [(s.message, s.pass_index) for s in res[2].spots]
        one = [s.message for s in res[1].spots]
        log(f"[multipass] {engine}: passes=2 {two}; passes=1 {one}; "
            f"launches in the passes=2 run {launches}")
        require(two == [(strong, 0), (weak, 1)],
                f"multipass {engine}: passes=2 gave {two}")
        require(weak not in one, f"multipass {engine}: passes=1 found the "
                f"weak frame")
        log(f"[multipass] {card}: {engine} engine, wall ms per window "
            f"passes=2 {ms[2]:.3f}, passes=1 {ms[1]:.3f} (second run of "
            f"each)")
        out[engine] = {"passes2_ms": ms[2], "passes1_ms": ms[1],
                       "launches": launches}
    return out


# ---------------------------------------------------------------- phase 15

CLI_FREQ = 2.5          # Hz, the encoded frame's offset
HOUR = 12000 * 3600     # audio samples of a one-hour 12 kS/s capture
FRONTEND_RTOL = 1e-5    # of the output's peak magnitude
F32_FLOP_S = 67e12      # H100 SXM data sheet, f32 outside the tensor cores


def run_cli(argv):
    """uwspr_tpu_torch.cli.main(argv) in this process -> (stdout, stderr)."""
    import io

    from uwspr_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main([str(a) for a in argv])
    return out.getvalue(), err.getvalue()


def cli_path(argv, kernels, what, calls=None):
    """One CLI command with every count set to 0 just before it and read
    just after: the named kernels launched, no plain version called;
    ``calls`` (a kernel_calls()) records the device engine's kernel calls.
    Returns (stdout, stderr, launches, wall seconds)."""
    import torch
    with calls if calls is not None else contextlib.nullcontext():
        reset_all_counters()
        t0 = time.perf_counter()
        out, err = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = read_counters()
    log(f"[cli] {what}: uwspr-torch {' '.join(map(str, argv))} "
        f"({wall:.2f} s)")
    for line in (out + err).splitlines()[:12]:
        log(f"[cli]   | {line}")
    log(f"[cli] {what}: launches {launches}; plain calls {plain}")
    require(all(launches[k] > 0 for k in kernels),
            f"cli {what}: a kernel of the path was not launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"cli {what}: a plain version ran on the path: {plain}")
    return out, err, launches, wall


def spot_messages(out):
    """The messages of decode's spot lines."""
    return [ln.split("    (", 1)[0] for ln in out.splitlines()
            if "    (freq " in ln]


def event_ms(fn, reps):
    """Mean ms per call of fn by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def cli_decodes(tmp):
    """(a) encode -> c2towav -> decode x.wav on the default device and
    engine, its kernel calls recorded; (b) the host and hybrid engines;
    (c) the replay of (a)'s selection and Fano calls."""
    c2, wav = tmp / "x.c2", tmp / "x.wav"
    run_cli(["encode", *EXPECTED.split(), "--freq-offset", CLI_FREQ,
             "-o", c2])
    run_cli(["c2towav", c2, "-o", wav])
    calls = kernel_calls()
    runs = {}
    for name, extra, kernels in (
            ("device", [], ("select_best", "fano_decode")),
            ("host", ["--engine", "host"], ("probe_powers", "select_best")),
            ("hybrid", ["--engine", "hybrid"], ("select_best",))):
        out, err, launches, wall = cli_path(
            ["decode", wav, *extra], kernels, f"decode ({name})",
            calls if name == "device" else None)
        require(spot_messages(out) == [EXPECTED],
                f"cli decode ({name}) printed {spot_messages(out)}")
        require(f"({name} engine on cuda;" in err,
                f"cli decode ({name}) ran another engine: {err}")
        runs[name] = {"wall_s": wall,
                      "summary": err.strip().splitlines()[-1]}
        runs[name + "_launches"] = launches
    replay_path(calls, "cli decode")
    return c2, wav, runs


def cli_frontend(card, wav):
    """(d) Downconverter on the card against the port's CPU run on the
    frame's wav and on a one-hour capture; ms of the device half (mix and
    strided FIR) by CUDA events, and of the whole call on the host clock."""
    import torch

    from uwspr_tpu_torch.frontend.downconvert import Downconverter
    from uwspr_tpu_torch.io.wavfile import read_wav
    audio, _ = read_wav(wav)
    rng = np.random.default_rng(15)
    hour = (np.resize(audio, HOUR)
            + 0.05 * rng.standard_normal(HOUR, dtype=np.float32))
    card_dc, cpu_dc = Downconverter(device="cuda"), Downconverter(device="cpu")
    res = {}
    for name, a in (("wav", audio), ("hour", hour)):
        card_dc(a)                                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card_dc(a)
        wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = cpu_dc(a)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        peak = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        require(got.shape == want.shape == (len(a) // 32,)
                and err <= FRONTEND_RTOL * peak,
                f"downconvert on the card differs from the CPU run on "
                f"{name}: {err} of peak {peak}")
        n = len(a) // 32 * 32
        x = torch.from_numpy(a[:n]).cuda()
        lo = torch.from_numpy(card_dc.mixer(n)).cuda()
        ms = event_ms(lambda: card_dc.planes(x, lo), reps=3)
        # least time: read the audio and the mixer once, write the planes
        # once; 2 mix products and 2 x 257 multiply-adds per output
        nbytes = 4 * n + 8 * n + 8 * (n // 32)
        flops = 2 * n + 2 * 2 * 257 * (n // 32)
        bound_ms = max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S) * 1e3
        log(f"[cli] {card}: downconvert {name} ({len(a):,} audio samples): "
            f"device half {ms:.4f} ms (CUDA events; bound {bound_ms:.4f} "
            f"ms, bytes), whole call {wall_ms:.1f} ms wall with the host "
            f"mixer and copies, CPU run {cpu_ms:.1f} ms; max |card - cpu| "
            f"{err:.3g} = {err / peak:.3g} of the peak")
        res[name] = {"samples": len(a), "ms": ms, "bound_ms": bound_ms,
                     "wall_ms": wall_ms, "cpu_wall_ms": cpu_ms,
                     "max_err_of_peak": err / peak}
        del x, lo
    return res


def cli_ring(card):
    """(e) serve --runtime ring at 128 channels on the synthetic source,
    against RingServe driven in-process on the same blocks."""
    import argparse

    from uwspr_tpu_torch import cli
    from uwspr_tpu_torch.pipeline.device_ring import RingServe
    out, err, launches, wall = cli_path(
        ["serve", "--runtime", "ring", "--channels", RING_CH, "--windows",
         RING_HOPS, "--snr", SNR_DB], ("select_best", "fano_decode"),
        "serve --runtime ring")
    got = [ln for ln in out.splitlines() if ln.startswith("ch")]
    args = argparse.Namespace(snr=SNR_DB, channels=RING_CH,
                              windows=RING_HOPS, duty=0.3)
    ring = RingServe(n_channels=RING_CH, device="cuda")
    info = {"sent": 0}
    want = []
    for block in cli._synthetic_source(args, ring.ring.hop, info):
        for ch, r in ring.push(block):
            want += [f"ch{ch}: {s.message} ({s.freq:+.2f} Hz)"
                     for s in r.spots]
    require(got == want, f"cli ring printed {len(got)} spots, RingServe "
            f"on the same blocks {len(want)}")
    require(want and all(ln.split(": ", 1)[1].startswith(EXPECTED + " (")
                         for ln in want),
            "cli ring: a spot that is not the sent message")
    summary = err.strip().splitlines()[-1]
    rate = float(summary.split(" window-samples/s")[0].rsplit(" ", 1)[1])
    shed = int(summary.split(" lanes shed")[0].rsplit(" ", 1)[1])
    log(f"[cli] {card}: serve --runtime ring: {len(got)} spots of "
        f"{info['sent']} frames sent, all {EXPECTED}, equal to RingServe "
        f"in-process; {rate:.0f} window-samples/s; {shed} lanes shed")
    return launches, {"spots": len(got), "sent": info["sent"],
                      "window_samples_s": rate, "lanes_shed": shed,
                      "wall_s": wall}


def cli_stdin(card, tmp):
    """(f) python -m uwspr_tpu_torch.cli serve --input - --format s16 as a
    process of its own, fed one frame's 12 kS/s audio; -X importtime lists
    every module it imports. A second, plain run gives the wall time a
    user pays (cold start included; the kernel library is already built)."""
    from uwspr_tpu_torch.frontend.downconvert import upconvert
    from uwspr_tpu_torch.protocol.modulate import synthesize_frame
    z = synthesize_frame("VE3EMB", "FN25", 30, start_sample=750,
                         freq_offset=1.5)
    audio = np.concatenate([upconvert(z), np.zeros(24000, np.float32)])
    s16 = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    argv = ["-m", "uwspr_tpu_torch.cli", "serve", "--input", "-",
            "--format", "s16"]
    runs = {}
    for name, flags in (("importtime", ["-X", "importtime"]), ("plain", [])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *flags, *argv], input=s16,
                              capture_output=True, cwd=tmp, env=env,
                              timeout=300)
        runs[name] = (proc, time.perf_counter() - t0)
        out, err = proc.stdout.decode(), proc.stderr.decode()
        require(proc.returncode == 0,
                f"cli stdin ({name}) exited {proc.returncode}: {err[-2000:]}")
        require(f"ch0: {EXPECTED} (" in out,
                f"cli stdin ({name}) printed {out!r}")
    err = runs["importtime"][0].stderr.decode()
    rows = [ln.split("|") for ln in err.splitlines()
            if ln.startswith("import time:") and ln.count("|") == 2]
    mods = [r[2].strip() for r in rows[1:]]          # rows[0]: the header
    # seconds spent importing: the cumulative times of top-level imports
    # (one space before the name; nested ones are indented further)
    import_s = sum(int(r[1]) for r in rows[1:]
                   if not r[2].startswith("  ")) / 1e6
    # jax*, or any uwspr package but the port (the JAX package among them)
    leaked = [m for m in mods if m.split(".")[0].startswith("jax")
              or (m.split(".")[0].startswith("uwspr")
                  and m.split(".")[0] != "uwspr_tpu_torch")]
    require("uwspr_tpu_torch.frontend.downconvert" in mods and not leaked,
            f"cli stdin process imported {leaked}")
    plain = runs["plain"][0]
    log(f"[cli] {card}: serve --input - --format s16 in its own process: "
        f"{plain.stdout.decode().strip()}; {len(mods)} modules imported "
        f"in {import_s:.2f} s, none jax* or uwspr_tpu*; wall "
        f"{runs['plain'][1]:.2f} s (with -X importtime "
        f"{runs['importtime'][1]:.2f} s)")
    return {"wall_s": runs["plain"][1],
            "importtime_wall_s": runs["importtime"][1],
            "modules": len(mods), "import_s": import_s, "summary":
            plain.stderr.decode().strip().splitlines()[-1]}


def cli_sweeps(card):
    """(g) the device sweep from -15 to -27 dB and the host sweep at -15 dB,
    32 trials a point."""
    import torch
    out = {}
    for engine, snr, kernels in (
            ("device", ("-15", "-27", "-4"), ("select_best", "fano_decode")),
            ("host", ("-15", "-15", "1"), ("probe_powers", "select_best"))):
        text, _, launches, wall = cli_path(
            ["sweep", "--engine", engine, "--snr", *snr, "--trials", 32],
            kernels, f"sweep --engine {engine}")
        doc = json.loads(text.splitlines()[-1])
        require(doc["decode_rate"]["-15"] == 1.0 and doc["engine"] == engine
                and doc["backend"] == torch.cuda.get_device_name(0),
                f"cli sweep ({engine}): {doc}")
        log(f"[cli] {card}: sweep --engine {engine}, 32 trials a point: "
            f"{doc['decode_rate']} in {wall:.2f} s")
        out[engine] = {"decode_rate": doc["decode_rate"], "wall_s": wall}
    return out


def _grc_block(key, **params):
    ps = "".join(f"<param><key>{k}</key><value>{v}</value></param>"
                 for k, v in params.items())
    return f"<block><key>{key}</key>{ps}</block>"


def _grc_flowgraph(blocks, links):
    cs = "".join(f"<connection><source_block_id>{a}</source_block_id>"
                 f"<sink_block_id>{b}</sink_block_id></connection>"
                 for a, b in links)
    return ("<?xml version='1.0' encoding='utf-8'?>\n<flow_graph>"
            + "".join(blocks) + cs + "</flow_graph>")


def cli_grc(card, tmp, c2):
    """(h) a sender flowgraph (C2 file -> wav sink) and a receiver
    flowgraph (wav source -> the uwspr decode chain, the GNU Radio block's
    maxfreqs 200), written here, through ``grc``; then ``decode`` of the
    sender's wav."""
    sender, receiver, sent = tmp / "send.grc", tmp / "recv.grc", tmp / "s.wav"
    var = [_grc_block("variable", id=k, value=v) for k, v in (
        ("samp_rate", 12000), ("Frame_Length", 45000),
        ("Center_Frequency", 1500), ("Half_Bandwidth", 10))]
    sender.write_text(_grc_flowgraph(var + [
        _grc_block("C2_File_Source", id="c2", file=f"/home/author/{c2.name}",
                   repeat="False"),
        _grc_block("blocks_wavfile_sink", id="ws", file="/home/author/s.wav")],
        [("c2", "ws")]))
    receiver.write_text(_grc_flowgraph(var + [
        _grc_block("blocks_wavfile_source", id="w0", file=sent,
                   repeat="False"),
        _grc_block("rational_resampler_xxx", id="rr", decim=32),
        _grc_block("uwspr_sliding_window_stream_to_pdu", id="sw", fs=375,
                   fl="Frame_Length", shift=9, C=2),
        _grc_block("uwspr_FDR", id="fdr", fs=375, fl="Frame_Length",
                   spb=256, maxdrift=0, maxfreqs=200,
                   halfbandwidth="Half_Bandwidth", cf="Center_Frequency",
                   threshold=10),
        _grc_block("blocks_message_debug", id="dbg")],
        [("w0", "rr"), ("rr", "sw"), ("sw", "fdr"), ("fdr", "dbg")]))
    out, _ = run_cli(["grc", sender, "--files-dir", c2.parent, "-o", sent])
    require(sent.exists(), f"cli grc sender wrote no wav: {out}")
    out, err, _, wall = cli_path(
        ["grc", receiver], ("select_best", "fano_decode"), "grc receiver")
    require(EXPECTED in out and "kind: receiver" in err,
            f"cli grc receiver printed {out!r}")
    out, _, _, _ = cli_path(["decode", sent], ("select_best", "fano_decode"),
                            "decode of the grc sender's wav")
    require(spot_messages(out) == [EXPECTED],
            f"cli decode of the sender's wav printed {out!r}")
    log(f"[cli] {card}: grc sender -> {sent.name}, grc receiver and decode "
        f"of it both gave {EXPECTED}")
    return {"receiver_wall_s": wall}


def cli_trace(tmp, c2):
    """(i) decode --trace-dir: a trace that names the selection and Fano
    kernels."""
    tdir = tmp / "trace"
    cli_path(["decode", c2, "--trace-dir", tdir],
             ("select_best", "fano_decode"), "decode --trace-dir")
    files = sorted(tdir.glob("*.pt.trace.json"))
    require(len(files) == 1, f"cli trace: {files}")
    text = files[0].read_text()
    names = {k: text.count(k) for k in ("select_best_kernel", "fano_kernel")}
    require(all(names.values()), f"cli trace names no kernel: {names}")
    log(f"[cli] decode --trace-dir: {files[0].name}, {len(text):,} bytes, "
        f"kernel names {names}")
    return {"bytes": len(text), "kernel_names": names}


def phase_cli(card):
    """The uwspr-torch CLI on the card (see the module doc, phase 15).
    Returns (results, {path: launches})."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        c2, wav, decodes = cli_decodes(tmp)
        launches = {f"cli_decode_{k}": decodes.pop(f"{k}_launches")
                    for k in ("device", "host", "hybrid")}
        frontend = cli_frontend(card, wav)
        launches["cli_ring"], ring = cli_ring(card)
        stdin = cli_stdin(card, tmp)
        sweeps = cli_sweeps(card)
        grc = cli_grc(card, tmp, c2)
        trace = cli_trace(tmp, c2)
        t0 = time.perf_counter()
        out, _ = run_cli(["warmup", "--batch", "1,128"])
        warm = time.perf_counter() - t0
        require("W=128 engine=hybrid narrowband: ran in" in out,
                f"cli warmup printed {out!r}")
        log(f"[cli] warmup --batch 1,128 in {warm:.2f} s:\n{out.rstrip()}")
    return ({"decode": decodes, "frontend": frontend, "ring": ring,
             "stdin": stdin, "sweep": sweeps, "grc": grc, "trace": trace,
             "warmup_s": warm}, launches)


# ---------------------------------------------------------------- phase 16

MESH_WINS = {"1x1": 4, "2x2": 2}    # wins_per_shard of (a) and (b)
MESH_CLI_CH = 8
MESH_TIMEOUT_S = 300                # of each launcher subprocess


def mesh_feed(dec, z):
    """The stream hop by hop through a ShardedStreamDecoder, then its
    flush: ({(window, channel): [messages]}, [(channel, window, message,
    freq)] in the order the decoder returned them)."""
    got = []
    for k in range(RING_HOPS):
        got += dec.push(hop_block(z, k))
    got += dec.flush()
    found = {}
    for c, w, s in got:
        found.setdefault((w, c), []).append(s.message)
    return found, [(c, w, s.message, float(s.freq)) for c, w, s in got]


def check_mesh_spots(found, starts, single, what):
    """The mesh's spots against the single-device runtimes of phase 10
    (BatchedStreamDecoder on every channel, StreamDecoder on two), window
    by window as message sets, where the window holds a whole frame or
    none; every whole frame decoded, the noise channels nothing. Returns
    the windows that cut a frame and differ."""
    cut = []
    for name, ref in single.items():
        for (j, c), msgs in ref.items():
            cov = (coverage(starts[c], j * HOP) if c in starts else "none")
            mine = sorted(set(found.get((j, c), [])))
            theirs = sorted(set(msgs))
            if cov == "partial":
                if mine != theirs:
                    cut.append((name, j, c, mine, theirs))
                continue
            require(mine == theirs,
                    f"{what}: channel {c} window {j} holds {cov} frame: "
                    f"{mine}, {name} {theirs}")
    win = windower_starts()
    check_found(found, {c: holds(starts, c, win) for c in starts
                        if holds(starts, c, win)}, what)
    return cut


def mesh_step_timing(dec, x0, tail0, reps=3):
    """ms per mesh step on (x0, tail0) (ShardedStreamDecoder.step: the
    sharded decode, the gather, the spots) by CUDA events and by the host
    clock, every rank in step behind a barrier; and the halo exchange alone
    (extend_with_halo on this rank's block, the host-to-device copy of the
    extended row not included) on the host clock."""
    import torch
    import torch.distributed as dist

    from uwspr_tpu_torch.parallel.mesh import extend_with_halo
    n = dec.step_len // dec.hop
    dec.step(x0, tail0, n)                          # warm-up
    ev, wall = [], []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        dec.step(x0, tail0, n)
        e.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(s.elapsed_time(e))
    x_ri, tail_ri = dec.dec.rank_block(x0, tail0)
    ex = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extend_with_halo(x_ri, tail_ri, mesh=dec.mesh,
                         block_len=x_ri.shape[2], halo=dec.halo)
        torch.cuda.synchronize()
        ex.append((time.perf_counter() - t0) * 1e3)
    step_wall = sum(wall) / reps
    return {"step_ms": sum(ev) / reps, "step_wall_ms": step_wall,
            "exchange_ms": sum(ex) / reps,
            "exchange_share": sum(ex) / reps / step_wall,
            "rounds": (-(-dec.halo // x_ri.shape[2])
                       if dec.n_time > 1 else 0),
            "channel_windows_s": RING_CH * n / step_wall * 1e3,
            "turns": {"step_ms": ev, "step_wall_ms": wall,
                      "exchange_ms": ex}}


def mesh_world_of_one(card, z, starts, single):
    """(a) ShardedStreamDecoder on a 1x1 mesh over NCCL in this process."""
    import tempfile

    import torch
    import torch.distributed as dist

    from uwspr_tpu_torch.parallel.distributed import global_mesh, initialize
    from uwspr_tpu_torch.parallel.mesh import ShardedStreamDecoder
    from uwspr_tpu_torch.pipeline.stream import BatchedStreamDecoder
    wins = MESH_WINS["1x1"]
    n_win = len(windower_starts())
    with tempfile.TemporaryDirectory() as tmp:
        initialize("nccl", init_method=f"file://{tmp}/store", world_size=1,
                   rank=0)
        try:
            mesh = global_mesh(1, 1, "cuda")
            dec = ShardedStreamDecoder(base_config(), mesh,
                                       n_channels=RING_CH,
                                       wins_per_shard=wins)
            with kernel_calls() as calls:
                reset_all_counters()
                found, lines = mesh_feed(dec, z)
                torch.cuda.synchronize()
                launches, plain = read_counters()
            log(f"[mesh] 1x1 (nccl, wins_per_shard={wins}): launches "
                f"{launches}; plain calls {plain}")
            require(launches["select_best"] > 0
                    and launches["fano_decode"] > 0
                    and all(v == 0 for v in plain.values()),
                    f"mesh 1x1: launches {launches}, plain {plain}")
            require(dec.stats.windows == RING_CH * n_win,
                    f"mesh 1x1: {dec.stats.windows} channel-windows")
            cut = check_mesh_spots(found, starts, single, "mesh 1x1")
            replay_path(calls, "mesh 1x1")
            log(f"[mesh] 1x1: {len(lines)} spots in {dec.stats.windows} "
                f"channel-windows ({dec.stats.steps} steps), equal to "
                f"BatchedStreamDecoder's and StreamDecoder's on every window "
                f"that holds a whole frame or none; {len(cut)} windows that "
                f"cut a frame differ: {cut}")
            x0 = z[:, :dec.step_len]
            tail0 = z[:, dec.step_len:dec.step_len + dec.halo]
            step = mesh_step_timing(dec, x0, tail0)
            state = {}

            def mesh_setup():
                state["m"] = ShardedStreamDecoder(
                    base_config(), mesh, n_channels=RING_CH,
                    wins_per_shard=wins)

            def batched_setup():
                state["b"] = BatchedStreamDecoder(
                    base_config(), n_channels=RING_CH, batch_windows=128,
                    device="cuda")

            def batched_run():
                for k in range(RING_HOPS):
                    state["b"].push(hop_block(z, k))
                state["b"].flush()
                return 1
            def mesh_run():
                mesh_feed(state["m"], z)
                return 1
            turns = time_runtime_turns([("mesh", mesh_setup, mesh_run),
                                        ("batched", batched_setup,
                                         batched_run)])
        finally:
            dist.destroy_process_group()
    cw = RING_CH * n_win
    run = {k: {"run_ms": v[0], "run_wall_ms": v[1],
               "channel_windows_s": cw / v[1] * 1e3,
               "turns_ms": v[2], "turns_wall_ms": v[3]}
           for k, v in turns.items()}
    log(f"[timing] {card}: mesh 1x1 (nccl) step of {RING_CH} x {wins} "
        f"windows: {step['step_ms']:.3f} ms (events), "
        f"{step['step_wall_ms']:.3f} ms wall (turns "
        f"{fmt_turns(step['turns'])}); the halo (a concatenation at "
        f"n_time = 1) {step['exchange_ms']:.4f} ms, "
        f"{100 * step['exchange_share']:.3f} % of a step")
    log(f"[timing] {card}: the stream ({RING_CH} x {RING_HOPS} hops, {cw} "
        f"channel-windows) in turns mesh, batched, batched, mesh: mesh 1x1 "
        f"{run['mesh']['run_wall_ms']:.1f} ms wall "
        f"({run['mesh']['channel_windows_s']:.1f} channel-windows/s), "
        f"BatchedStreamDecoder(batch_windows=128) "
        f"{run['batched']['run_wall_ms']:.1f} ms wall "
        f"({run['batched']['channel_windows_s']:.1f} channel-windows/s); "
        f"events mesh {run['mesh']['run_ms']:.1f}, batched "
        f"{run['batched']['run_ms']:.1f} ms")
    return launches, lines, {"step": step, "stream": run, "cut": len(cut)}


def launcher(n, *argv, env=None):
    """python -m torch.distributed.run --standalone --nproc-per-node n
    *argv from the repo's root, started, with its output piped."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               **(env or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), *map(str, argv)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env)


def finish(proc, what):
    """(stdout, stderr) of a launcher process, which must exit 0 within
    MESH_TIMEOUT_S; killed otherwise."""
    try:
        out, err = proc.communicate(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: timed out after {MESH_TIMEOUT_S} s")
    require(proc.returncode == 0, f"{what} exited {proc.returncode}:\n"
            f"{out[-3000:]}\n{err[-3000:]}")
    return out, err


def wait_for(path: pathlib.Path, proc, what):
    """Until ``path`` exists; returns early when ``proc`` exited (finish()
    then reports why), fails after MESH_TIMEOUT_S."""
    t0 = time.perf_counter()
    while not path.exists() and proc.poll() is None:
        require(time.perf_counter() - t0 < MESH_TIMEOUT_S,
                f"{what}: no {path.name} after {MESH_TIMEOUT_S} s")
        time.sleep(0.2)


def mesh_gloo_world(card, out, ranks, starts, single):
    """(b) the results of four ranks on this card over gloo (mesh_rank):
    the launcher's output and every rank's gathered results."""
    for line in out.splitlines():
        log(line)
    n_win = len(windower_starts())
    first = ranks[0]
    for r in ranks:
        what = f"mesh 2x2 rank {r['rank']}"
        require(r["launches"]["select_best"] > 0
                and r["launches"]["fano_decode"] > 0
                and all(v == 0 for v in r["plain"].values()),
                f"{what}: launches {r['launches']}, plain {r['plain']}")
        require(r["hybrid_launches"]["select_best"] > 0
                and all(v == 0 for v in r["hybrid_plain"].values()),
                f"{what} hybrid: launches {r['hybrid_launches']}, plain "
                f"{r['hybrid_plain']}")
        require(r["bitwise"], f"{what}: packed output differs from "
                f"decode_windows_ri on its own windows")
        require(r["lines"] == first["lines"],
                f"{what}: another spot list than rank 0's")
        require(r["windows"] == RING_CH * n_win,
                f"{what}: {r['windows']} channel-windows")
        REPLAYED[what] = r["replay"]
    found = {}
    for c, w, m, _ in first["lines"]:
        found.setdefault((w, c), []).append(m)
    cut = check_mesh_spots(found, starts, single, "mesh 2x2")
    key = [(c, w, m) for c, w, m, _ in first["lines"]]
    require(key == [(c, w, m) for c, w, m, _ in first["hybrid_lines"]],
            "mesh 2x2: the hybrid engine's spots differ from the device "
            "engine's")
    t = first["timing"]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in first["launches"]}
    hybrid = {k: sum(r["hybrid_launches"][k] for r in ranks)
              for k in first["hybrid_launches"]}
    log(f"[mesh] 2x2 (gloo, 4 ranks on cuda:0, wins_per_shard="
        f"{MESH_WINS['2x2']}; a rank's parts {first['seconds']} s): every "
        f"rank launched the "
        f"selection and Fano kernels and no plain version (launches summed "
        f"{launches}; hybrid {hybrid}), replayed its own calls bit-exact, "
        f"returned the same {len(key)} spots, equal to the single-device "
        f"runtimes on every window that holds a whole frame or none "
        f"({len(cut)} cut windows differ: {cut}), and its packed output "
        f"equals decode_windows_ri on its own windows; the hybrid engine "
        f"gives the "
        f"device engine's spots")
    log(f"[timing] {card}: mesh 2x2 (gloo) step of {RING_CH} x "
        f"{2 * MESH_WINS['2x2']} windows: {t['step_ms']:.3f} ms (events), "
        f"{t['step_wall_ms']:.3f} ms wall; halo exchange ({t['rounds']} "
        f"rounds through pinned host memory) {t['exchange_ms']:.3f} ms, "
        f"{100 * t['exchange_share']:.2f} % of a step; "
        f"{t['channel_windows_s']:.1f} channel-windows/s. Four ranks share "
        f"one card: this measures the cost of the exchange, not scaling")
    return launches, hybrid, {"step": t, "cut": len(cut),
                              "rank_seconds": first["seconds"],
                              "per_rank_timing": [r["timing"]
                                                  for r in ranks]}


def mesh_rank(out_dir):
    """One rank of (b), under the launcher: first the step timing, with
    nothing else on the card (rank 0 then writes out_dir/timed, on which
    the parent starts (c) and (d)); then the device engine with its kernel
    calls recorded and replayed, its packed output against
    decode_windows_ri on its own windows, and the hybrid engine. Rank 0
    gathers every rank's results into out_dir/mesh_2x2.json."""
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    import torch
    import torch.distributed as dist

    from uwspr_tpu_torch.parallel.distributed import global_mesh, initialize
    from uwspr_tpu_torch.parallel.mesh import ShardedStreamDecoder
    from uwspr_tpu_torch.utils import cuda_build
    initialize("gloo")
    try:
        mesh = global_mesh(2, 2, "cuda")
        cuda_build.load_library()
        rank = dist.get_rank()
        c, t = mesh.get_coordinate()
        what = f"mesh 2x2 rank {rank}"
        wins = MESH_WINS["2x2"]
        z, _ = make_stream()
        res = {"rank": rank, "coordinate": [c, t],
               "card": torch.cuda.current_device()}
        seconds = {"start": time.perf_counter() - t0}

        def stream_decoder(engine="device"):
            return ShardedStreamDecoder(base_config(), mesh,
                                        n_channels=RING_CH,
                                        wins_per_shard=wins, engine=engine)

        def lap(name):
            seconds[name] = time.perf_counter() - t0 - sum(seconds.values())
        dec = stream_decoder()
        x0 = z[:, :dec.step_len]
        tail0 = z[:, dec.step_len:dec.step_len + dec.halo]
        res["timing"] = mesh_step_timing(dec, x0, tail0)
        dist.barrier()
        if rank == 0:
            (pathlib.Path(out_dir) / "timed").touch()
        lap("timing")
        dec = stream_decoder()
        with kernel_calls() as calls:
            reset_all_counters()
            _, res["lines"] = mesh_feed(dec, z)
            torch.cuda.synchronize()
            res["launches"], res["plain"] = read_counters()
        res["windows"], res["steps"] = dec.stats.windows, dec.stats.steps
        lap("device")
        replay_path(calls, what)
        res["replay"] = REPLAYED[what]
        lap("replay")
        packed, _ = dec.dec.decode(x0, tail0)
        ch_l = RING_CH // 2
        own = np.stack([z[c * ch_l:(c + 1) * ch_l, s:s + FL]
                        for s in ((t * wins + w) * HOP
                                  for w in range(wins))], axis=1)
        want = dec.dec.decoder.decode_windows_ri(
            torch.from_numpy(to_ri(own.reshape(-1, FL))).cuda())
        res["bitwise"] = bool(torch.equal(packed.reshape(want.shape), want))
        lap("bitwise")
        reset_all_counters()
        _, res["hybrid_lines"] = mesh_feed(stream_decoder("hybrid"), z)
        torch.cuda.synchronize()
        res["hybrid_launches"], res["hybrid_plain"] = read_counters()
        lap("hybrid")
        res["seconds"] = {k: round(v, 2) for k, v in seconds.items()}
        ranks = [None] * dist.get_world_size() if rank == 0 else None
        dist.gather_object(res, ranks, dst=0)
        if rank == 0:
            (pathlib.Path(out_dir) / "mesh_2x2.json").write_text(
                json.dumps(ranks))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_refusal():
    """(d) under the launcher with two ranks: NCCL on this one card."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from uwspr_tpu_torch.parallel.distributed import (SharedDeviceError,
                                                      global_mesh,
                                                      initialize)
    initialize("nccl")
    try:
        global_mesh(1, 2, "cuda")
        print(f"rank {dist.get_rank()}: not refused", flush=True)
    except SharedDeviceError as e:
        print(f"REFUSED rank {dist.get_rank()}: {e}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_cli(card):
    """(c) serve --mesh 2x2 over gloo under the launcher and --mesh 1x1
    over NCCL in this process print the spot lines of serve --runtime
    python on the same synthetic source; (d) runs beside it."""
    common = ["serve", "--channels", MESH_CLI_CH, "--snr", SNR_DB]
    t0 = time.perf_counter()
    grid = launcher(4, "-m", "uwspr_tpu_torch.cli", *common, "--mesh", "2x2",
                    "--dist-backend", "gloo")
    refusal = launcher(2, ROOT / "chip_smoke.py", "mesh-refusal")
    try:
        one, one_err, one_launches, _ = cli_path(
            [*common, "--mesh", "1x1", "--dist-backend", "nccl"],
            ("select_best", "fano_decode"), "serve --mesh 1x1 (nccl)")
        single, single_err, _, _ = cli_path(
            [*common, "--runtime", "python"], ("select_best", "fano_decode"),
            "serve --runtime python")
        out, err = finish(grid, "serve --mesh 2x2 (gloo) under the launcher")
        grid_wall = time.perf_counter() - t0
        rout, rerr = finish(refusal, "the NCCL refusal")
    finally:
        for p in (grid, refusal):
            if p.poll() is None:
                p.kill()
                p.communicate()

    def spots(text):
        return [ln for ln in text.splitlines() if ln.startswith("ch")]

    def untagged(lines):            # "ch3 w5: ..." -> "ch3: ..."
        return sorted(ln.split(" ", 1)[0] + ":" + ln.split(":", 1)[1]
                      for ln in lines)
    grid_spots, one_spots = spots(out), spots(one)
    closing = [ln for ln in err.splitlines() if ln.startswith("# mesh 2x2")]
    log(f"[mesh] cli: serve --mesh 2x2 --dist-backend gloo under the launcher "
        f"({grid_wall:.1f} s): {len(grid_spots)} spots; {closing}")
    # a step emits channel by channel, and the two meshes step over other
    # window counts: the same lines, in another order
    require(sorted(grid_spots) == sorted(one_spots),
            f"cli --mesh 2x2 printed {grid_spots}, --mesh 1x1 {one_spots}")
    require(untagged(grid_spots) == sorted(spots(single)),
            f"cli --mesh printed {untagged(grid_spots)}, --runtime python "
            f"{sorted(spots(single))}")
    require(grid_spots and all(f": {EXPECTED} (" in ln for ln in grid_spots),
            "cli --mesh: a spot that is not the sent message")
    require(len(closing) == 1 and "(device)" in closing[0],
            f"cli --mesh 2x2 closing line {closing}")
    refused = [ln for ln in rout.splitlines() if ln.startswith("REFUSED")]
    require(len(refused) == 2 and all("gloo" in ln for ln in refused),
            f"NCCL on one card with two ranks was not refused: {rout}"
            f"{rerr[-2000:]}")
    log(f"[mesh] cli: --mesh 2x2 and --mesh 1x1 print the same "
        f"{len(grid_spots)} spot lines, those of serve --runtime python; "
        f"(d) {refused}")
    return one_launches, {"spots": len(grid_spots), "closing": closing,
                          "launcher_wall_s": grid_wall, "refusal": refused}


def phase_mesh(card, single):
    """The multi-device layer on the card (see the module doc, phase 16).
    (b)'s ranks time their steps first; (c) and (d) start once they have,
    and run while (b) finishes its checks. Returns (results, {path:
    launches})."""
    import tempfile
    t0 = time.perf_counter()
    z, starts = make_stream()
    one_launches, _, one = mesh_world_of_one(card, z, starts, single)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        ranks = launcher(4, ROOT / "chip_smoke.py", "mesh-rank", tmp)
        try:
            wait_for(tmp / "timed", ranks, "mesh 2x2 (gloo)")
            cli_launches, cli = mesh_cli(card)
            out, _ = finish(ranks, "mesh 2x2 (gloo)")
        finally:
            if ranks.poll() is None:
                ranks.kill()
                ranks.communicate()
        results = json.loads((tmp / "mesh_2x2.json").read_text())
    grid_launches, hybrid_launches, grid = mesh_gloo_world(
        card, out, results, starts, single)
    seconds = time.perf_counter() - t0
    log(f"[mesh] phase 16 in {seconds:.1f} s")
    return ({"1x1": one, "2x2": grid, "cli": cli, "seconds": seconds},
            {"mesh_1x1": one_launches, "mesh_2x2": grid_launches,
             "mesh_2x2_hybrid": hybrid_launches,
             "cli_mesh_1x1": cli_launches})


# ---------------------------------------------------------------- phase 17

HARNESS_SWEEP_SNRS = (-29, -30)     # the knee of SWEEP_r05.json's curves
HARNESS_OSD_SNR = -30.0
HARNESS_MULTIPASS_DB = -12.0
HARNESS_MULTIPASS_S = 20.0          # the multipass trials' time budget


def harness_path(kernels, what, fn):
    """fn() with every kernel count set to 0 just before it and read just
    after: the path's kernels launched, no plain version called; then every
    kernel call of the run replayed against its plain version on the same
    inputs (replay_path). Returns (fn's result, launches, seconds,
    the time taken by the recording's host copies included)."""
    import torch
    with kernel_calls() as calls:
        reset_all_counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = read_counters()
    log(f"[harness] {what}: launches {launches}; plain calls {plain}; "
        f"{seconds:.2f} s")
    require(all(launches[k] > 0 for k in kernels),
            f"harness {what}: a kernel of the path was not launched: "
            f"{launches}")
    require(all(v == 0 for v in plain.values()),
            f"harness {what}: a plain version ran on the path: {plain}")
    replay_path(calls, f"harness {what}")
    return out, launches, seconds


def harness_bench(card, tmp):
    """(a) python -m uwspr_tpu_torch.harness.bench as a process of its own
    (-X importtime lists its modules): its last stdout line parses, with a
    value above 0; its record says 128/128 and gives the launches, read by
    the wrappers' counters in that process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "uwspr_tpu_torch.harness.bench", "--out", str(tmp)],
        capture_output=True, text=True, cwd=tmp, env=env, timeout=300)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"harness.bench exited {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    rec = json.loads((tmp / "bench.json").read_text())
    mods = [ln.split("|")[2].strip() for ln in proc.stderr.splitlines()
            if ln.startswith("import time:") and ln.count("|") == 2][1:]
    leaked = [m for m in mods if m.split(".")[0].startswith("jax")
              or (m.split(".")[0].startswith("uwspr")
                  and m.split(".")[0] != "uwspr_tpu_torch")]
    # the harness runs as __main__; its imports include harness.common
    require(not leaked and "uwspr_tpu_torch.harness.common" in mods,
            f"harness.bench imported {leaked}")
    require(set(line) == {"metric", "value", "unit", "vs_baseline"}
            and line["metric"] == "window_samples_per_s_per_chip"
            and line["value"] > 0 and rec["decoded"] == "128/128"
            and rec["card"] == card and rec["pass"],
            f"harness.bench printed {line}, record {rec['decoded']}")
    launches = rec["kernel_launches"]
    require(launches["select_best"] > 0 and launches["fano_decode"] > 0
            and not any(rec["plain_calls"].values()),
            f"harness.bench launches {launches}, plain {rec['plain_calls']}")
    log(f"[harness] {card}: harness.bench in its own process: {line}; "
        f"{rec['decoded']} at {rec['ms_per_window']:.4f} ms/window; "
        f"launches {launches}; {len(mods)} modules, none jax* or "
        f"uwspr_tpu*; wall {wall:.2f} s")
    # the same decoder on the same scene in this process, so that its
    # kernel calls can be replayed against their plain versions
    import torch

    from uwspr_tpu_torch.harness import bench, scenes
    k = bench.knobs({})
    dec = bench.make_decoder(k, torch.device("cuda"))
    windows, expected = scenes.bench_windows(k["windows"], k["snr_db"])
    ri_c = torch.from_numpy(scenes.to_ri(windows)).cuda()
    packed, _, _ = path_run(dec, ri_c, ("select_best", "fano_decode"),
                            "harness bench")
    ok = bench.decoded(dec, packed, expected)
    require(ok == k["windows"], f"harness bench in this process: {ok}/"
            f"{k['windows']} decoded")
    return {"line": line, "ms_per_window": rec["ms_per_window"],
            "wall_s": wall}, launches


def harness_sweeps():
    """(b) the sweep's -29 and -30 dB points, 50 trials, with the device and
    hybrid engines, the earlier points drawn and skipped."""
    from uwspr_tpu_torch.harness import common, sweeps
    configs = sweeps.curve_configs(sweeps.TRIALS)
    ref = common.load_record(sweeps.REFERENCE)["curves"]
    out, launches = {}, {}
    for name, kernels in (("device_serving", ("select_best", "fano_decode")),
                          ("hybrid_serving", ("select_best",))):
        engine, cfg = configs[name]
        (res, _), launches[name], secs = harness_path(
            kernels, f"sweep {name} {HARNESS_SWEEP_SNRS} dB",
            lambda: sweeps.run_curve(engine, cfg, HARNESS_SWEEP_SNRS,
                                     sweeps.TRIALS, device="cuda"))
        rates = {p: sum(o) / sweeps.TRIALS for p, o in res.items()}
        vs = common.vs_reference(rates, ref[name]["decode_rate"], name,
                                 sweeps.TRIALS)
        log(f"[harness] sweep {name}: {rates} against "
            f"{ {p: ref[name]['decode_rate'][p] for p in rates} } "
            f"(sum |diff| {vs['sum_abs_diff']} trials) in {secs:.1f} s")
        require(vs["pass"], f"harness sweep {name} off the record: {vs}")
        out[name] = {"outcomes": res, "rates": rates, "seconds": secs}
    dev, hyb = (out[k]["outcomes"] for k in ("device_serving",
                                             "hybrid_serving"))
    require(dev == hyb, f"harness sweep: device {dev} != hybrid {hyb}")
    return out, launches


def harness_osd():
    """(c) the device OSD sweep at -30 dB, 25 trials, at the record's
    configuration (order 4)."""
    from uwspr_tpu_torch.harness import common, osd_sweeps
    base, deep = osd_sweeps.decoders("device", osd_sweeps.DEPTHS["device"],
                                     osd_sweeps.TRIALS, device="cuda")
    out, launches, secs = harness_path(
        ("select_best", "fano_decode"), f"OSD device sweep "
        f"{HARNESS_OSD_SNR} dB", lambda: osd_sweeps.run_point(
            "device", base, deep, HARNESS_OSD_SNR, osd_sweeps.TRIALS))
    r = osd_sweeps.row(HARNESS_OSD_SNR, out, secs)
    rec = {"reference": osd_sweeps.REFERENCES["device"],
           "trials": osd_sweeps.TRIALS, "results": [r]}
    osd_sweeps.checks(rec)
    log(f"[harness] OSD device sweep {HARNESS_OSD_SNR} dB: fano "
        f"{r['fano_rate']}, osd {r['osd_rate']}, false "
        f"{r['false_valid_rate']}; against the record "
        f"{ {k: v['points'] for k, v in rec['vs_reference'].items()} }")
    require(all(rec["exact"].values()) and all(
        v["pass"] for v in rec["vs_reference"].values()),
        f"harness OSD device sweep: {rec['exact']} {rec['vs_reference']}")
    return {k: r[k] for k in ("fano_rate", "osd_rate", "false_valid_rate",
                              "seconds")}, launches


def harness_noise_only():
    """(d) the matrix row noise_only_serving: 128 noise windows, no spot."""
    from uwspr_tpu_torch.harness import matrix
    row, launches, _ = harness_path(
        ("select_best",), "matrix noise_only_serving",
        lambda: matrix.row_noise_only("cuda"))
    # the row's times hold the recording's host copies: not kept here
    log(f"[harness] matrix noise_only_serving: {row['spots_emitted']} "
        f"spots")
    require(row["exact"]["no_spot"], f"harness noise-only: {row}")
    return {"spots_emitted": row["spots_emitted"]}, launches


def harness_multipass():
    """(e) the multipass row at -12 dB, host engine, on the trials that fit
    HARNESS_MULTIPASS_S: the strong frame decodes in each; the weak frame's
    misses within the record's plus the tolerance."""
    from uwspr_tpu_torch.harness import common, multipass
    dec = multipass.make_decoder("cuda")
    t0 = time.perf_counter()

    def trials():
        t = []
        while len(t) < multipass.TRIALS and (
                time.perf_counter() - t0 < HARNESS_MULTIPASS_S):
            t.append(multipass.trial(dec, HARNESS_MULTIPASS_DB, len(t)))
        return t
    out, launches, secs = harness_path(
        ("probe_powers", "select_best"),
        f"multipass {HARNESS_MULTIPASS_DB} dB", trials)
    ref = next(r for r in common.load_record(multipass.REFERENCE)["results"]
               if r["weak_rel_db"] == HARNESS_MULTIPASS_DB)
    n = len(out)
    strong, single, multi = (sum(o[i] for o in out) for i in range(3))
    ref_miss = round((1 - ref["weak_rate_multipass"]) * multipass.TRIALS)
    ref_single = round(ref["weak_rate_single_pass"] * multipass.TRIALS)
    log(f"[harness] multipass {HARNESS_MULTIPASS_DB} dB, trials 0..{n - 1}"
        f": strong {strong}/{n}, weak in pass 0 {single}/{n}, after the "
        f"second pass {multi}/{n} (record over 25: "
        f"{ref['weak_rate_single_pass']}, {ref['weak_rate_multipass']}) in "
        f"{secs:.1f} s")
    require(strong == n and n - multi <= ref_miss + common.POINT_TOL
            and single <= ref_single + common.POINT_TOL,
            f"harness multipass: {out}")
    return {"trials": n, "strong": strong, "single": single, "multi": multi,
            "seconds": secs}, launches


def phase_harness(card):
    """The result harnesses (uwspr_tpu_torch/harness/; see the module doc,
    phase 17). Returns (results, {path: launches})."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        bench, bench_launches = harness_bench(card, pathlib.Path(d))
    sweep, sweep_launches = harness_sweeps()
    osd, osd_launches = harness_osd()
    noise, noise_launches = harness_noise_only()
    multi, multi_launches = harness_multipass()
    seconds = time.perf_counter() - t0
    log(f"[harness] phase 17 in {seconds:.1f} s")
    return ({"bench": bench, "sweeps": sweep, "osd_device": osd,
             "noise_only": noise, "multipass": multi, "seconds": seconds},
            {"harness_bench": bench_launches,
             "harness_sweep_device": sweep_launches["device_serving"],
             "harness_sweep_hybrid": sweep_launches["hybrid_serving"],
             "harness_osd_device": osd_launches,
             "harness_noise_only": noise_launches,
             "harness_multipass": multi_launches})


# ---------------------------------------------------------------- phase 18

def scaling_rank(out_dir):
    """One rank of phase 18's world, under the launcher."""
    sys.path.insert(0, str(ROOT))
    from uwspr_tpu_torch.harness import scaling
    return scaling.rank_main(out_dir, "cuda")


def scaling_paths(records):
    """Phase 18's four kernel paths: {path: its recorded runs combined
    (launches and plain calls summed, replays merged)}. The controls'
    recorded decodes; the inventory rows' decodes and steps on every
    rank; each dry run on every rank."""
    sc = records["scaling"]
    return {"scaling_controls": sc["controls"],
            "scaling_inventory": sc["kernels"]["inventory"],
            "scaling_pod": records["dryrun_pod"]["kernels"],
            "scaling_multichip": records["multichip"]["kernels"]}


def phase_scaling(card):
    """The multi-chip evidence (see the module doc, phase 18). Returns
    (results, {path: launches})."""
    import tempfile

    import torch

    from uwspr_tpu_torch.harness import common, scaling
    t0 = time.perf_counter()
    records = scaling.run(torch.device("cuda"),
                          [str(ROOT / "chip_smoke.py"), "scaling-rank"])
    seconds = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        failed = [name for name, rec in records.items()
                  if common.finish(rec, tmp, name)]
    sc, pod, multi = (records[k] for k in ("scaling", "dryrun_pod",
                                           "multichip"))
    require(not failed and all(r["card"] == card
                               for r in records.values()),
            f"scaling: records {failed} failed their checks (see above)")
    for c in sc["controls"]["rows"]:
        log(f"[scaling] {card}: control {c['scene']} x{c['channels']} "
            f"wins {c['wins_per_shard']}: {c['spots']}/"
            f"{c['frames_embedded']} spots, a step {c['step_s'] * 1e3:.3f} "
            f"ms wall, {c['step_event_s'] * 1e3:.3f} ms events, "
            f"{c['ms_per_window']:.4f} ms/window, peak {c['peak_mib']:.0f} "
            f"MiB")
    log(f"[scaling] headline compute point {sc['headline']}")
    key80 = f"latency_step_s_for_bound_{scaling.TARGET_EFFICIENCY:g}"
    for r in sc["rows"]:
        d, b = r["decode"], r["bound"]
        log(f"[scaling] {r['config']}: {d['collective_rounds']} rounds, "
            f"ppermute {d['ppermute_bytes_per_device_per_step']} B, "
            f"all_reduce {d['allreduce_bytes_per_device_per_step']} B; the "
            f"step adds an all_gather of "
            f"{r['step']['allgather_bytes_per_device_per_step']} B at the "
            f"toy config, "
            f"{r['step_served']['allgather_bytes_per_device_per_step']} B "
            f"at PipelineConfig() (the step's bound); bound (decode, step) "
            f"NVLink "
            f"{b['decode']['intra_node_nvlink4']['efficiency_bound']:.4f}, "
            f"{b['step']['intra_node_nvlink4']['efficiency_bound']:.4f}; "
            f"NDR {b['decode']['inter_node_ndr400']['efficiency_bound']:.4f}"
            f", {b['step']['inter_node_ndr400']['efficiency_bound']:.4f}; "
            f"NVLink decode at 0.8 for a step of "
            f"{r['nvlink_latency_curve']['decode'][key80] * 1e6:.1f} us")
    for r in sc["pod_4096ch"]["rows"]:
        log(f"[scaling] pod_4096ch {r['hosts']}x{r['chips_per_host']}: "
            f"{r['channels_per_chip']} channels a chip, bound (NDR) "
            f"{r['bound_inter_node_ndr400']['efficiency_bound']:.4f}, "
            f"real-time headroom {r['realtime_headroom']:.1f}")
    log(f"[scaling] dry runs ({scaling.NOTE_SHARED}): pod {pod['spots']}/"
        f"{pod['frames_embedded']} frames, steps "
        f"{[round(s, 3) for s in pod['step_seconds_by_rank']]} s; "
        f"multichip {multi['messages']} in {multi['windows']} windows, "
        f"steps {[round(s, 3) for s in multi['step_seconds_by_rank']]} s")
    paths = scaling_paths(records)
    for path, k in paths.items():
        launches, rep = k["launches"], k["replay"]
        require(launches["select_best"] > 0 and launches["fano_decode"] > 0
                and not any(k["plain"].values()) and rep["ok"],
                f"{path}: launches {launches}, plain {k['plain']}, replay "
                f"failures {rep['failures'][:5]}")
        REPLAYED[path.replace("_", " ", 1)] = rep
        log(f"[scaling] {path}: launches {launches}; replayed "
            f"{rep['select_calls']} select_best calls "
            f"({rep['select_lanes']} lanes) bitwise, {rep['fano_calls']} "
            f"fano_decode calls ({rep['fano_active_lanes']} active lanes, "
            f"{rep['fano_timeouts']} full-budget timeouts) bit-exact")
    log(f"[scaling] phase 18 in {seconds:.1f} s")
    results = {
        "seconds": seconds, "headline": sc["headline"],
        "controls": [{k: c[k] for k in (
            "scene", "channels", "wins_per_shard", "spots", "step_s",
            "step_event_s", "ms_per_window", "peak_mib")}
            for c in sc["controls"]["rows"]],
        "rows": [{"config": r["config"],
                  "collective_rounds": r["decode"]["collective_rounds"],
                  "ppermute_bytes": r["decode"][
                      "ppermute_bytes_per_device_per_step"],
                  "allgather_bytes": r["step_served"][
                      "allgather_bytes_per_device_per_step"],
                  "nvlink_latency_step_s_for_decode_0.8": r[
                      "nvlink_latency_curve"]["decode"][key80],
                  "bound": {k: {rate: v["efficiency_bound"]
                                for rate, v in r["bound"][k].items()}
                            for k in ("decode", "step")}}
                 for r in sc["rows"]],
        "pod_4096ch": [{"chips": r["chips"],
                        "bound_ndr": r["bound_inter_node_ndr400"][
                            "efficiency_bound"]}
                       for r in sc["pod_4096ch"]["rows"]],
        "dryrun_pod": {"spots": pod["spots"],
                       "step_s": pod["step_seconds_by_rank"]},
        "multichip": {"messages": multi["messages"],
                      "step_s": multi["step_seconds_by_rank"]}}
    return results, {path: k["launches"] for path, k in paths.items()}


# ---------------------------------------------------------------- phase 14

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet;
# the card's own limit is printed beside every time): HBM bytes/s, dense
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12
# One Fano forward look is a chain of dependent steps: at least one
# shared-memory round trip (the metric-table lookup), about 30 SM clocks.
FANO_STEP_CLOCKS = 30
# a spin of about 25 ms at 2 GHz that holds the card while the host
# enqueues the timed calls, so that they run back to back on the card
SPIN_CYCLES = 50_000_000


def bound(nbytes: float, flops: float, flop_s: float, op_kind: str):
    """(bound_ms, bound_by, bound_kind): the larger of the bytes over the
    HBM rate and the operations over their peak rate."""
    tb = nbytes / HBM_BYTES_S * 1e3
    to = flops / flop_s * 1e3
    return (tb, "bytes", "HBM") if tb >= to else (to, "operations", op_kind)


def time_turns(fns, reps):
    """Mean ms per call of each (name, fn), CUDA events, in turns
    A B C .. C B A after one warm-up call of each; returns ({name: ms},
    {name: [ms of each turn]}, {name: warm-up result}). Each turn starts
    behind a spin kernel, so a call whose host work is shorter than its
    device work is timed on the card alone (wrapper kernels included), and
    one that waits on the host is timed with that wait."""
    import torch
    outs = {name: fn() for name, fn in fns}
    torch.cuda.synchronize()

    def timed(fn, n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n
    turns = {name: [] for name, _ in fns}
    for name, fn in list(fns) + list(reversed(fns)):
        turns[name].append(timed(fn, reps[name]))
    return ({k: sum(v) / len(v) for k, v in turns.items()}, turns, outs)


def fmt_turns(turns):
    return "; ".join(f"{k} {', '.join(f'{x:.4f}' for x in v)}"
                     for k, v in turns.items())


def entry(name, source, replaces, shape, ms, plain_ms, bnd, library,
          library_ms, err):
    bms, by, kind = bnd
    return {"name": name, "route": "cuda",
            "source": f"uwspr_tpu_torch/csrc/{source}",
            "replaces": replaces, "shape": shape, "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "bound_kind": kind,
            "bound_share": bms / ms, "library": library,
            "library_ms": library_ms}


def host_grid(hdec, ri):
    """The host engine's (200, 5, 26, M) selection grid of the scene's first
    window, as CoarseSearch builds it before its select_best call."""
    import torch

    from uwspr_tpu_torch.coarse.search import (coarse_score_grid,
                                               detect_peaks,
                                               smoothed_snr_spectrum)
    from uwspr_tpu_torch.device import exact_f32
    cs = hdec.coarse
    cfg = cs.cfg
    with torch.no_grad(), exact_f32():
        ps = cs.power_spectrum(ri[0, 0] + 1j * ri[0, 1])
        sm = smoothed_snr_spectrum(ps, hpbm=cfg.hpbm, m=cfg.fft_size // 2)
        _, if0, _ = detect_peaks(sm.cpu().numpy(), cfg)
        grid = coarse_score_grid(ps[None], torch.from_numpy(if0)[None].cuda(),
                                 cs._offsets, cs._sign, impl="einsum")[0]
    return grid.contiguous(), cs._is_nl


def timing_select(dec, scene, hdec, ri, card, wide):
    import torch

    from uwspr_tpu_torch.ops import select as sel
    thr = float(dec.config.coarse.threshold)
    out = {}
    for name, (grid, is_nl) in (("device", (scene, dec.state["is_nl"])),
                                ("host", host_grid(hdec, ri)),
                                ("wideband", (wide["grid"], wide["is_nl"]))):
        ms, turns, outs = time_turns(
            [("plain", lambda: sel.select_best_plain(grid, is_nl,
                                                     threshold=thr)),
             ("kernel", lambda: sel.select_best(grid, is_nl, threshold=thr))],
            {"plain": 5, "kernel": 50})
        (bp, ip), (bk, ik) = outs["plain"], outs["kernel"]
        require(torch.equal(bk.view(torch.int32), bp.view(torch.int32))
                and torch.equal(ik, ip),
                f"select timing inputs ({name}): kernel differs from plain")
        L = grid.shape[0]
        nbytes = grid.numel() * 4 + is_nl.numel() + L * 8
        e = entry("select_best", "select_best.cu",
                  "uwspr_tpu/ops/select_pallas.py:121", list(grid.shape),
                  ms["kernel"], ms["plain"],
                  bound(nbytes, grid.numel(), F32_FLOP_S, "f32"),
                  None, None, float((bk - bp).abs().nan_to_num().max()))
        log(f"[timing] {card}: select_best {name} {tuple(grid.shape)}: "
            f"kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
            f"library none (an order-dependent walk); bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_kind']}), "
            f"{100 * e['bound_share']:.1f} % of it (turns "
            f"{fmt_turns(turns)}); kernel == plain")
        out[name] = e
    return out


def timing_fano(dec, ri_c, card, sm_mhz):
    import torch

    from uwspr_tpu_torch.fec import fano
    # the slice's phase-1 Fano chunk: jiggle-0 lanes, gated first, 256 wide
    with torch.no_grad():
        pre = dec.prefano(ri_c)
    gate0 = pre["gate"][:, :, 0].reshape(-1)
    deint0 = pre["deint"][:, :, 0].reshape(-1, 162)
    FL = min(dec.config.demod.fano_compact_lanes, gate0.shape[0])
    order = torch.argsort((~gate0).to(torch.int8), stable=True)[:FL]
    sym, act = deint0[order].contiguous(), gate0[order].contiguous()
    met = dec.state["mettab"]
    mc = dec.config.demod.maxcycles
    ms, turns, outs = time_turns(
        [("plain", lambda: fano.fano_decode_batch_plain(sym, met, act,
                                                        maxcycles=mc)),
         ("kernel", lambda: fano.fano_decode_batch(sym, met, act,
                                                   maxcycles=mc))],
        {"plain": 2, "kernel": 50})
    err = fano_equal(outs["kernel"], outs["plain"],
                     f"kernel vs plain on the phase-1 chunk maxcycles={mc}")
    cyc = outs["kernel"]["cycles"][act].to(torch.int64)
    csum, cmax = int(cyc.sum()), int(cyc.max())
    bms = cmax * FANO_STEP_CLOCKS / (sm_mhz * 1e6) * 1e3
    e = entry("fano_decode", "fano.cu", "uwspr_tpu/fec/fano_pallas.py:243",
              [FL, 162], ms["kernel"], ms["plain"],
              (bms, "operations", "latency"), None, None, err)
    e.update(cycles_sum=csum, cycles_max=cmax)
    log(f"[timing] {card}: fano_decode on the phase-1 chunk ({FL} lanes, "
        f"{int(act.sum())} gated, maxcycles={mc}; cycles sum {csum}, max "
        f"{cmax}): kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms,"
        f" library none (a sequential search); bound {bms:.4f} ms (the "
        f"longest lane's {cmax} forward looks x {FANO_STEP_CLOCKS} clocks at"
        f" {sm_mhz} MHz), {100 * e['bound_share']:.1f} % of it (turns "
        f"{fmt_turns(turns)}); kernel == plain, bit-exact")
    # deep-SNR load at the full budget: lanes that never decode
    rng = np.random.default_rng(23)
    blocks = {"all-timeout block": fano_lanes(rng, 128, None),
              "mixed chunk": np.concatenate([fano_lanes(rng, 192, 10.0),
                                             fano_lanes(rng, 64, None)])}
    other = {}
    for name, lanes in blocks.items():
        sym = torch.from_numpy(lanes).cuda()
        ms, turns, outs = time_turns(
            [("kernel", lambda: fano.fano_decode_batch(sym, met,
                                                       maxcycles=mc))],
            {"kernel": 3})
        err = max(err, fano_equal(outs["kernel"], native_decode(lanes, mc),
                                  f"kernel vs native on the {name}"))
        cyc = outs["kernel"]["cycles"].to(torch.int64)
        csum, cmax = int(cyc.sum()), int(cyc.max())
        bms = cmax * FANO_STEP_CLOCKS / (sm_mhz * 1e6) * 1e3
        other[name] = {"shape": list(lanes.shape), "ms": ms["kernel"],
                       "plain_ms": None, "bound_ms": bms,
                       "library_ms": None, "cycles_sum": csum,
                       "cycles_max": cmax}
        log(f"[timing] {card}: fano_decode on the {name} ({len(lanes)} "
            f"lanes, maxcycles={mc}; cycles sum {csum}, max {cmax}): kernel "
            f"{ms['kernel']:.4f} ms, plain not timed (hours); bound "
            f"{bms:.4f} ms, {100 * bms / ms['kernel']:.1f} % of it (turns "
            f"{fmt_turns(turns)}); kernel == native fano_native.cc, "
            f"bit-exact")
    e["max_abs_err"] = err
    e["other_shapes"] = other
    return e


def probe_library_inputs(z_ri, lags, freqs, dsym):
    """The operands of probe_powers_plain's complex product (the derotated
    windows and the lag-masked tone banks), built once: the library
    yardstick is that one torch.bmm."""
    import torch

    from uwspr_tpu_torch.ops import probe
    N = z_ri.shape[1]
    C, F = freqs.shape
    L = lags.shape[1]
    W = 1024
    base, b = probe.lag_offsets(lags, N)
    z = torch.complex(z_ri[0], z_ri[1])
    pos = base[:, None] + torch.arange(162 * 256 + W, device=z.device) - \
        probe.PAD
    A = torch.where((pos >= 1) & (pos < N), z[pos.clamp(0, N - 1)], 0)
    jpf = torch.arange(W, dtype=torch.float32, device=z.device)
    phase = torch.tensor(probe.PHASE, device=z.device)
    wd = (phase * dsym)[..., None] * jpf
    zd = A.unfold(-1, W, 256)[:, :162] * torch.complex(torch.cos(wd),
                                                       torch.sin(wd))
    ft = freqs[..., None] + torch.from_numpy(probe.TONES_HZ).to(z.device)
    wb = (phase * ft)[..., None] * jpf
    bank = torch.complex(torch.cos(wb), torch.sin(wb)).reshape(C, 1, 4 * F,
                                                               W)
    mask = ((jpf >= b[..., None]) & (jpf < b[..., None] + 256)).float()
    bankt = (bank * mask[:, :, None, :]).reshape(C, L * 4 * F, W)
    return zd.contiguous(), bankt.transpose(1, 2).contiguous()


def timing_probe(card, z_ri, cases):
    import torch

    from uwspr_tpu_torch.device import exact_f32
    from uwspr_tpu_torch.ops import probe
    N = z_ri.shape[1]
    out = {}
    for name, (lags, freqs, dsym, _) in cases.items():
        C, F = freqs.shape
        L = lags.shape[1]
        zd, bankt = probe_library_inputs(z_ri, lags, freqs, dsym)
        with torch.no_grad(), exact_f32():
            ms, turns, outs = time_turns(
                [("plain", lambda: probe.probe_powers_plain(
                    z_ri, lags, freqs, dsym, n_lags=L)),
                 ("kernel", lambda: probe.probe_powers(
                     z_ri, lags, freqs, dsym, n_lags=L)),
                 ("library", lambda: torch.bmm(zd, bankt))],
                {"plain": 5, "kernel": 20, "library": 10})
        err = probe_error(outs["kernel"], outs["plain"], f"timing {name}")
        macs = C * F * L * 162 * 4 * 256           # complex multiply-adds
        nbytes = (2 * N + C * L + C * F + C * 162) * 4 + macs // 256 * 4
        e = entry("probe_powers", "probe_powers.cu",
                  "uwspr_tpu/ops/probe_pallas.py:123", [C, F, L, 162, 4],
                  ms["kernel"], ms["plain"],
                  bound(nbytes, 8 * macs, F32_FLOP_S, "f32 FMA"),
                  "torch.bmm (complex64, the plain version's product)",
                  ms["library"], err)
        log(f"[timing] {card}: probe_powers {name} {tuple(e['shape'])}: "
            f"kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
            f"torch.bmm {ms['library']:.4f} ms; bound {e['bound_ms']:.4f} ms"
            f" ({e['bound_kind']}), {100 * e['bound_share']:.1f} % of it "
            f"(turns {fmt_turns(turns)})")
        out[name] = e
    return out


def timing_stft(card, z_main, kw, stft_inputs, wide):
    import torch

    from uwspr_tpu_torch.device import exact_f32
    from uwspr_tpu_torch.ops import stft
    out = {}
    size, hop, n = kw["size"], kw["hop"], kw["n_ffts"]
    cases = {name: (z_main,) + stft_inputs[name]
             for name in ("column window", "full width")}
    cases["wideband full width"] = (wide["z"],) + wide["stft"]
    for name, (z, col, consts) in cases.items():
        B, fl = z.shape
        w = consts["window"]

        def run(impl):
            return stft.stft_power_core(z, impl=impl, col_window=col,
                                        consts=consts, **kw)

        def library():
            s = torch.stft(z, size, hop_length=hop, window=w, center=False,
                           return_complex=True)
            ps = torch.fft.fftshift(s.real ** 2 + s.imag ** 2, dim=-2)
            ps = ps.transpose(-1, -2)
            return ps if col is None else ps[..., col[0]:col[1]]
        with torch.no_grad(), exact_f32():
            ms, turns, outs = time_turns(
                [("plain", lambda: run("matmul_bf16")),
                 ("kernel", lambda: run("pallas")), ("library", library)],
                {"plain": 10, "kernel": 50, "library": 20})
        err = stft_error(outs["kernel"], outs["plain"], f"timing {name}")
        ncols = outs["kernel"].shape[-1]
        nbytes = B * fl * 8 + B * n * ncols * 4
        flops = 2.0 * B * n * (2 * size) * (2 * ncols)
        e = entry("stft_power", "stft_power.cu",
                  "uwspr_tpu/ops/stft_pallas.py:80", [B, n, ncols],
                  ms["kernel"], ms["plain"],
                  bound(nbytes, flops, BF16_FLOP_S, "tensor core"),
                  "torch.stft (f32, all 512 columns) + |.|^2 + fftshift",
                  ms["library"], err)
        log(f"[timing] {card}: stft_power {name} {tuple(e['shape'])}: "
            f"kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
            f"torch.stft {ms['library']:.4f} ms; bound {e['bound_ms']:.4f} "
            f"ms ({e['bound_kind']}), {100 * e['bound_share']:.1f} % of it "
            f"(turns {fmt_turns(turns)})")
        out[name] = e
    return out


def main() -> int:
    card, sm_mhz = phase_device()
    sys.path.insert(0, str(ROOT))
    phase_build()
    import torch

    from uwspr_tpu_torch.config import PipelineConfig, with_serving_defaults
    from uwspr_tpu_torch.pipeline.decoder import WindowDecoder
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), N_WINDOWS),
                        device="cuda")
    hdec = WindowDecoder(PipelineConfig(), device="cuda")
    ri = make_windows(N_WINDOWS)
    ri_c = torch.from_numpy(ri).cuda()
    scene, sel_err = phase_select(dec, ri_c)
    fano_err = phase_fano()
    probe_err, z_ri, cases = phase_probe(hdec, ri)
    stft_err, z, kw, stft_inputs = phase_stft(dec, ri_c)
    launches = phase_slice(card, dec, ri, ri_c)
    host_launches, _ = phase_host_slice(card, hdec, ri)
    pallas_launches = phase_pallas_slice(card, dec, ri_c)
    ring_launches, htod, stream, ring, single = phase_runtimes(card)
    wide = phase_wideband(card)
    osd = phase_osd(card)
    multi = phase_multipass(card)
    cli, cli_launches = phase_cli(card)
    mesh, mesh_launches = phase_mesh(card, single)
    harness, harness_launches = phase_harness(card)
    scale, scaling_launches = phase_scaling(card)

    sels = timing_select(dec, scene, hdec, ri, card, wide)
    fan = timing_fano(dec, ri_c, card, sm_mhz)
    probes = timing_probe(card, z_ri, cases)
    stfts = timing_stft(card, z, kw, stft_inputs, wide)
    runtimes = timing_runtimes(card, stream, ring, htod)
    sel = sels["device"]
    sel["other_shapes"] = {k: {f: sels[k][f] for f in (
        "shape", "ms", "plain_ms", "bound_ms", "library_ms")}
        for k in ("host", "wideband")}
    prb = probes["soft symbols (L=17, F=1)"]
    stf = stfts["column window"]
    prb["other_shapes"] = {k: {f: v[f] for f in ("shape", "ms", "plain_ms",
                                                  "bound_ms", "library_ms")}
                           for k, v in probes.items() if v is not prb}
    stf["other_shapes"] = {k: {f: v[f] for f in ("shape", "ms", "plain_ms",
                                                  "bound_ms", "library_ms")}
                           for k, v in stfts.items() if v is not stf}
    paths = {"device": launches, "host": host_launches,
             "pallas": pallas_launches, "ring": ring_launches,
             "wideband": wide["launches"],
             "wideband_pallas": wide["pallas_launches"],
             "osd": osd["launches"],
             "multipass_device": multi["device"]["launches"],
             "multipass_hybrid": multi["hybrid"]["launches"],
             **cli_launches, **mesh_launches, **harness_launches,
             **scaling_launches}
    for e, n, err in ((sel, launches["select_best"], sel_err),
                      (fan, launches["fano_decode"], fano_err),
                      (prb, host_launches["probe_powers"], probe_err),
                      (stf, pallas_launches["stft_power"], stft_err)):
        e["launches"] = n
        e["ring_launches"] = ring_launches[e["name"]]
        e["path_launches"] = {k: v[e["name"]] for k, v in paths.items()}
        e["max_abs_err"] = max(e["max_abs_err"], err)
    fan["max_abs_err"] = max([fan["max_abs_err"]] + [
        r["fano_max_abs_err"] for r in REPLAYED.values()])
    fan["path_replays"] = {k: {f: r[f] for f in (
        "fano_calls", "fano_active_lanes", "fano_timeouts")}
        for k, r in REPLAYED.items()}
    sel["path_replays"] = {k: {f: r[f] for f in (
        "select_calls", "select_lanes")} for k, r in REPLAYED.items()}
    prb["max_abs_err"] = max([prb["max_abs_err"]] + [
        r["probe_max_abs_err"] for r in REPLAYED.values()])
    prb["path_replays"] = {k: {f: r[f] for f in (
        "probe_calls", "probe_candidates")} for k, r in REPLAYED.items()
        if r["probe_calls"]}
    print(json.dumps({"runtimes": runtimes, "htod_bytes_per_hop": htod,
                      "wideband": {k: wide[k] for k in (
                          "ms", "wall_ms", "peak_mib", "decoded")},
                      "osd": {k: v for k, v in osd.items()
                              if k != "launches"},
                      "multipass": {k: {f: v[f] for f in (
                          "passes2_ms", "passes1_ms")}
                          for k, v in multi.items()}}), flush=True)
    print(json.dumps({"cli": cli}), flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
    print(json.dumps({"harness": harness}), flush=True)
    print(json.dumps({"scaling": scale}), flush=True)
    print(json.dumps({"kernels": [sel, fan, prb, stf]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["mesh-rank"]:        # a rank of phase 16 (b)
        sys.exit(mesh_rank(sys.argv[2]))
    if sys.argv[1:] == ["mesh-refusal"]:      # a rank of phase 16 (d)
        sys.exit(mesh_refusal())
    if sys.argv[1:2] == ["scaling-rank"]:     # a rank of phase 18 (b)
        sys.exit(scaling_rank(sys.argv[2]))
    sys.exit(main())
