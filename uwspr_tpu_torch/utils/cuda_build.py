"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own nvcc call, all started
together, and the objects are linked into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

The library lands in ``$UWSPR_TORCH_BUILD_DIR``, by default
``build/uwspr_tpu_torch/`` at the repository root, and its name carries a
digest of the sources, the flags and ``nvcc --version``, so an edited source
or another toolkit is rebuilt at first use and an unchanged one is loaded as
it is. There is no ``--use_fast_math``: the selection kernel relies on
subnormals and IEEE compares, the probe kernel on sincosf's full range
reduction, the STFT kernel on round-to-nearest products, the OSD kernel
on IEEE quality and margin divisions, the sync-grid kernel on IEEE
square roots and divisions, and the lane-probe kernel on cosf/sinf as
torch.cos/torch.sin compute them and on IEEE square roots. The first
kernel call in a process builds and loads; nothing is built at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = pathlib.Path(os.environ.get(
    "UWSPR_TORCH_BUILD_DIR", PACKAGE_DIR.parent / "build" / "uwspr_tpu_torch"))
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_C = ctypes
# C entry points of csrc/*.cu and their ctypes signatures. Every pointer and
# the stream are c_void_p: a bare Python int would be passed as a 32-bit int.
_SIGNATURES = {
    "uwspr_select_best": [_C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int,
                          _C.c_int, _C.c_double, _C.c_int, _C.c_void_p,
                          _C.c_void_p, _C.c_void_p],
    "uwspr_fano_decode": [_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
                          _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p,
                          _C.c_void_p, _C.c_void_p, _C.c_void_p,
                          _C.c_void_p],
    "uwspr_fano_decode_jiggles": [_C.c_void_p, _C.c_void_p, _C.c_void_p,
                                  _C.c_void_p, _C.c_int, _C.c_int, _C.c_int,
                                  _C.c_int,
                                  _C.c_void_p, _C.c_void_p, _C.c_void_p,
                                  _C.c_void_p, _C.c_void_p, _C.c_void_p,
                                  _C.c_void_p, _C.c_void_p],
    "uwspr_osd_decode": [_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
                         _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_void_p,
                         _C.c_void_p, _C.c_void_p],
    "uwspr_probe_powers_smem": [_C.c_int, _C.c_int],
    "uwspr_probe_powers": [_C.c_void_p, _C.c_int, _C.c_void_p, _C.c_void_p,
                           _C.c_void_p, _C.c_int, _C.c_int, _C.c_int,
                           _C.c_int, _C.c_int, _C.c_float, _C.c_void_p,
                           _C.c_void_p],
    "uwspr_stft_power_smem": [_C.c_int, _C.c_int, _C.c_int],
    "uwspr_stft_power": [_C.c_void_p, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
                         _C.c_int, _C.c_void_p, _C.c_void_p, _C.c_int,
                         _C.c_int, _C.c_int, _C.c_void_p, _C.c_void_p],
    "uwspr_probe_lanes_tiling": [_C.c_int, _C.c_int, _C.c_int, _C.c_int,
                                 _C.c_int, _C.c_void_p],
    "uwspr_probe_lanes": [_C.c_void_p, _C.c_int, _C.c_void_p, _C.c_void_p,
                          _C.c_int, _C.c_int, _C.c_void_p, _C.c_int,
                          _C.c_int, _C.c_float, _C.c_void_p, _C.c_int,
                          _C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p,
                          _C.c_void_p],
    "uwspr_sync_grid_smem": [_C.c_int, _C.c_int],
    "uwspr_sync_grid": [_C.c_void_p, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
                        _C.c_int, _C.c_void_p, _C.c_int, _C.c_void_p,
                        _C.c_int, _C.c_void_p, _C.c_int, _C.c_void_p,
                        _C.c_void_p],
    "uwspr_mark": [_C.c_int, _C.c_void_p],
    "uwspr_subtract_lanes_smem": [_C.c_int],
    "uwspr_subtract_lanes": [_C.c_void_p, _C.c_int, _C.c_int, _C.c_int,
                             _C.c_void_p, _C.c_void_p, _C.c_void_p,
                             _C.c_void_p, _C.c_void_p, _C.c_void_p,
                             _C.c_void_p, _C.c_void_p, _C.c_double,
                             _C.c_int, _C.c_int, _C.c_int, _C.c_void_p,
                             _C.c_void_p, _C.c_void_p],
}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None
# what the last build in this process did: library path, seconds, nvcc log
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of uwspr_tpu_torch can only be built where the "
            "CUDA toolkit is installed")
    return found


def kernel_sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(nvcc: str) -> str:
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(version.encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first failure; return
    their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def build_library() -> pathlib.Path:
    """Compile csrc/*.cu unless a library of the same sources exists."""
    nvcc = _nvcc()
    lib = BUILD_DIR / f"libuwspr_tpu_torch_{_digest(nvcc)}.so"
    if lib.exists():
        build_info.update(library=str(lib), seconds=0.0, log="(cached)")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in kernel_sources()]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(kernel_sources(), objs)])
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    build_info.update(library=str(lib), seconds=seconds, log=log)
    return lib


def kernel_resources(log: str) -> dict[str, dict]:
    """ptxas -v output -> {entry function: {"registers", "smem_bytes",
    "spill_bytes"}} (static shared memory; dynamic shared memory is set at
    launch)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "smem_bytes": 0,
                         "spill_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def sass_counts(library: str | os.PathLike,
                prefix: str) -> dict[str, dict[str, int]]:
    """{kernel symbol: {opcode: count}} of the SASS instructions in
    ``library`` whose opcode starts with ``prefix``, read with cuobjdump."""
    cuobjdump = pathlib.Path(_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True)
    return parse_sass(proc.stdout, prefix)


def parse_sass(sass: str, prefix: str) -> dict[str, dict[str, int]]:
    """The counting of sass_counts on cuobjdump -sass text."""
    out, name = {}, None
    pat = re.compile(rf"\*/\s+(?:@!?U?P\w+\s+)?({re.escape(prefix)}[\w.]*)")
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = pat.search(line) if name is not None else None
        if m:
            out[name][m.group(1)] = out[name].get(m.group(1), 0) + 1
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once per process."""
    global _library
    with _lock:
        if _library is None:
            handle = ctypes.CDLL(str(build_library()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = handle
        return _library


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


__all__ = ["ARCH_FLAGS", "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build_info",
           "build_library", "check_launch", "kernel_resources",
           "kernel_sources", "load_library", "parse_sass", "sass_counts"]
