#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's serving decode path once on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; exits non-zero when torch.cuda.is_available() is False;
2. build: compiles uwspr_tpu_torch/csrc/*.cu with nvcc (and the JAX
   package's native C++ Fano decoder with g++, as an oracle);
3. selection kernel against its plain version: real-shaped
   (1664, 5, 26, 126) grids from the scene's coarse stage and from random
   data with NaNs and negatives, the adversarial cases of
   tests/test_select_pallas.py and an all-linear bank; best bitwise equal,
   index equal;
4. Fano kernel against its plain version at small budgets (clean, noisy,
   all-timeout and inactive lanes, a lane count off the block size) and
   against the native C++ decoder at the full 10,000-cycle budget,
   including a block of 128 lanes that all time out; bit-exact;
5. the slice: DeviceDecoder(with_serving_defaults(PipelineConfig(), 128),
   device="cuda") on bench.py's scene (seed 0, 128 windows of
   "VE3EMB FN25 30" at -18 dB): 128/128 decoded, 8 noise-only windows give
   no message, both kernels launched and neither plain version called,
   and a 2-window input agrees with the port's CPU run;
6. timing: each kernel against its plain version at the slice's shapes
   (the scene's selection grid and its phase-1 Fano chunk: 256 lanes at
   maxcycles 10,000), with CUDA events, in turns plain, kernel, kernel,
   plain; the two are also held equal on those inputs (bit-exact).

Prints a JSON line of per-kernel results before the last line, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
N_WINDOWS = 128
SNR_DB = -18.0
EXPECTED = "VE3EMB FN25 30"


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"tf32: cuda.matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32} (the decoder pins both off)")
    return card


# ---------------------------------------------------------------- phase 2

def build_native_oracle(build_dir: pathlib.Path):
    """The JAX package's native C++ Fano decoder, compiled with g++ from the
    checkout's fano_native.cc into the build directory and loaded (never a
    library found beside the source, which may be built for another CPU)."""
    import ctypes
    src = ROOT / "uwspr_tpu" / "fec" / "native" / "fano_native.cc"
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = build_dir / f"libfano_native_oracle_{h}.so"
    if not lib.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", str(src),
               "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib)
    native = ctypes.CDLL(str(lib))
    native.uwspr_fano_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    native.uwspr_fano_decode_batch.restype = None
    return native


def phase_build():
    from uwspr_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_library()
    info = cuda_build.build_info
    log(f"[build] nvcc {' '.join(cuda_build.NVCC_FLAGS)} "
        f"{[str(p.relative_to(ROOT)) for p in cuda_build.kernel_sources()]}"
        f" -> {pathlib.Path(info['library']).relative_to(ROOT)} in "
        f"{info['seconds']:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    native = build_native_oracle(cuda_build.BUILD_DIR)
    log(f"[build] native Fano oracle built fresh from "
        f"uwspr_tpu/fec/native/fano_native.cc: {native._name}")
    return native


# ---------------------------------------------------------------- scene

def make_windows(n: int, seed: int = 0):
    """bench.py's workload (bench.py:39-51): n windows of one frame at
    SNR_DB with random frequency offsets and starts."""
    from uwspr_tpu.io.channel import awgn
    from uwspr_tpu.protocol.modulate import synthesize_frame
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
    from uwspr_tpu.io.channel import noise_sigma
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
    return scene, max_err


# ---------------------------------------------------------------- phase 4

def fano_lanes(rng, n, sigma, scale=50.0):
    """n soft-symbol lanes: encoded random payloads plus gaussian noise
    (tests/test_fano_pallas.py:20-31); sigma None gives uniform noise."""
    from uwspr_tpu.protocol.fec_encode import encode_bits
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


def native_decode(native, symbols, maxcycles):
    from uwspr_tpu.protocol.constants import FANO_METTAB
    n = symbols.shape[0]
    symbols = np.ascontiguousarray(symbols, np.uint8)
    met = np.ascontiguousarray(FANO_METTAB, np.int32)
    data = np.zeros((n, 10), np.uint8)
    succ = np.zeros(n, np.int32)
    metric = np.zeros(n, np.int32)
    cycles = np.zeros(n, np.uint32)
    maxnp = np.zeros(n, np.uint32)
    native.uwspr_fano_decode_batch(
        symbols.ctypes.data, n, 81, met.ctypes.data, 60, maxcycles,
        data.ctypes.data, succ.ctypes.data, metric.ctypes.data,
        cycles.ctypes.data, maxnp.ctypes.data)
    return {"success": succ != 0, "data": data, "metric": metric,
            "cycles": cycles.astype(np.int32),
            "maxnp": maxnp.astype(np.int32)}


def fano_equal(a: dict, b: dict, what: str) -> float:
    """Require every result field equal; return the largest absolute
    difference over the integer fields (0 when bit-exact)."""
    err = 0.0
    for key in ("success", "data", "metric", "cycles", "maxnp"):
        x = np.asarray(a[key].cpu() if hasattr(a[key], "cpu") else a[key])
        y = np.asarray(b[key].cpu() if hasattr(b[key], "cpu") else b[key])
        require(x.shape == y.shape, f"fano {what}: {key} shape differs")
        err = max(err, float(np.abs(x.astype(np.int64)
                                    - y.astype(np.int64)).max(initial=0)))
        require(np.array_equal(x, y), f"fano {what}: {key} differs")
    return err


def phase_fano(native):
    import torch

    from uwspr_tpu.protocol.constants import FANO_METTAB
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
    n = native_decode(native, full, 10000)
    err = max(err, fano_equal(k, n, "kernel vs native maxcycles=10000"))
    timeouts = int((n["cycles"] == 810002).sum())
    require(timeouts >= 128, f"expected >= 128 timeout lanes, got {timeouts}")
    log(f"[fano] kernel == native fano_native.cc at maxcycles=10000, 256 "
        f"lanes ({timeouts} full-budget timeouts incl. a 128-lane block): "
        f"bit-exact; kernel {tk * 1e3:.1f} ms wall")
    return err


# ---------------------------------------------------------------- phase 5

def phase_slice(card, dec, ri, ri_c):
    import torch

    from uwspr_tpu.config import (DemodConfig, PipelineConfig,
                                  with_serving_defaults)
    from uwspr_tpu_torch.fec import fano
    from uwspr_tpu_torch.ops import select as sel
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder

    t0 = time.perf_counter()
    out = dec.decode_windows_ri(ri_c)
    torch.cuda.synchronize()
    log(f"[slice] warm-up decode of {N_WINDOWS} windows: "
        f"{time.perf_counter() - t0:.3f} s")
    reps = 5
    torch.cuda.reset_peak_memory_stats()
    sel.reset_counters()
    fano.reset_counters()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = dec.decode_windows_ri(ri_c)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    launches = {"select_best": sel.KERNEL_LAUNCHES,
                "fano_decode": fano.KERNEL_LAUNCHES}
    plain = {"select_best": sel.PLAIN_CALLS, "fano_decode": fano.PLAIN_CALLS}
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] launches during {reps} decodes: {launches}; plain calls: "
        f"{plain}")
    require(all(v > 0 for v in launches.values()),
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


# ---------------------------------------------------------------- phase 6

def time_pair(plain_fn, kernel_fn, n_plain, n_kernel):
    """Mean ms per call of each, CUDA events, turns plain/kernel/kernel/
    plain after one warm-up call of each; also returns the warm-up calls'
    results (plain, kernel) for comparison."""
    import torch
    outs = (plain_fn(), kernel_fn())
    torch.cuda.synchronize()

    def timed(fn, n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n
    p1 = timed(plain_fn, n_plain)
    k1 = timed(kernel_fn, n_kernel)
    k2 = timed(kernel_fn, n_kernel)
    p2 = timed(plain_fn, n_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2), outs


def phase_timing(dec, ri_c, scene, card):
    import torch

    from uwspr_tpu_torch.fec import fano
    from uwspr_tpu_torch.ops import select as sel
    is_nl = dec.state["is_nl"]
    thr = float(dec.config.coarse.threshold)
    sk, sp, turns, ((bp, ip), (bk, ik)) = time_pair(
        lambda: sel.select_best_plain(scene, is_nl, threshold=thr),
        lambda: sel.select_best(scene, is_nl, threshold=thr), 5, 50)
    require(torch.equal(bk.view(torch.int32), bp.view(torch.int32))
            and torch.equal(ik, ip),
            "select timing inputs: kernel differs from plain")
    sel_err = float((bk - bp).abs().nan_to_num().max())
    log(f"[timing] {card}: select_best on {tuple(scene.shape)}: kernel "
        f"{sk:.4f} ms, plain {sp:.4f} ms (turns p/k/k/p "
        f"{', '.join(f'{x:.4f}' for x in turns)}); kernel == plain")
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
    fk, fp, turns, (po, ko) = time_pair(
        lambda: fano.fano_decode_batch_plain(sym, met, act, maxcycles=mc),
        lambda: fano.fano_decode_batch(sym, met, act, maxcycles=mc), 2, 50)
    fano_err = fano_equal(ko, po, f"kernel vs plain on the phase-1 chunk "
                          f"maxcycles={mc}")
    log(f"[timing] {card}: fano_decode on the phase-1 chunk ({FL} lanes, "
        f"{int(act.sum())} gated, maxcycles={mc}): kernel {fk:.4f} ms, "
        f"plain {fp:.4f} ms (turns p/k/k/p "
        f"{', '.join(f'{x:.4f}' for x in turns)}); kernel == plain, "
        f"bit-exact")
    return ({"select_best": (sk, sp), "fano_decode": (fk, fp)},
            {"select_best": sel_err, "fano_decode": fano_err})


def main() -> int:
    card = phase_device()
    sys.path.insert(0, str(ROOT))
    native = phase_build()
    import torch

    from uwspr_tpu.config import PipelineConfig, with_serving_defaults
    from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
    dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), N_WINDOWS),
                        device="cuda")
    ri = make_windows(N_WINDOWS)
    ri_c = torch.from_numpy(ri).cuda()
    scene, sel_err = phase_select(dec, ri_c)
    fano_err = phase_fano(native)
    launches = phase_slice(card, dec, ri, ri_c)
    times, errs = phase_timing(dec, ri_c, scene, card)
    sel_err = max(sel_err, errs["select_best"])
    fano_err = max(fano_err, errs["fano_decode"])
    kernels = [
        {"name": "select_best", "route": "cuda",
         "source": "uwspr_tpu_torch/csrc/select_best.cu",
         "replaces": "uwspr_tpu/ops/select_pallas.py:121",
         "launches": launches["select_best"], "max_abs_err": sel_err,
         "ms": times["select_best"][0], "plain_ms": times["select_best"][1]},
        {"name": "fano_decode", "route": "cuda",
         "source": "uwspr_tpu_torch/csrc/fano.cu",
         "replaces": "uwspr_tpu/fec/fano_pallas.py:243",
         "launches": launches["fano_decode"], "max_abs_err": fano_err,
         "ms": times["fano_decode"][0], "plain_ms": times["fano_decode"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
