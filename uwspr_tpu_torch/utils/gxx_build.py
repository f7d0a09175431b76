"""Build the port's host C++ sources with g++ and load them with ctypes.

Each source (``fec/fano_native.cc``, ``pipeline/native/stream_native.cc``)
is compiled on its own into a shared library with a plain C interface:

    g++ -O3 -fopenmp -shared -fPIC <source> -o <lib>

The library lands in the port's build directory (``cuda_build.BUILD_DIR``),
never beside the source, under a name that carries a digest of the source
and the flags, so an edited source is rebuilt at first use. Nothing falls
back: a failed build raises. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Callable

from uwspr_tpu_torch.utils.cuda_build import BUILD_DIR

GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def load_gxx_library(source: pathlib.Path,
                     configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """``source`` compiled with g++ into BUILD_DIR (once per source and
    flags) and loaded once per process; ``configure(lib)`` sets the
    argtypes and restypes at the first load."""
    key = str(source)
    with _lock:
        if key in _loaded:
            return _loaded[key]
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        h.update(source.read_bytes())
        lib = BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, str(source), "-o", str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, lib)
        handle = ctypes.CDLL(str(lib))
        configure(handle)
        _loaded[key] = handle
        return handle


__all__ = ["GXX_FLAGS", "load_gxx_library"]
