"""Fano backends of the host engine: ``PipelineConfig.fano_backend`` ->
decoder.

    "native"  the multithreaded C++ decoder ``fec/fano_native.cc`` (the
              port's own copy of uwspr_tpu/fec/native/fano_native.cc),
              compiled with g++ into the port's build directory and loaded
              with ctypes;
    "jax"     the port's batched decoder ``fec.fano.fano_decode_batch`` on
              the decoder's device: the CUDA kernel on a card, the plain
              lockstep version on the CPU;
    "ref"     the pure-Python reference ``fec.fano_ref``.

All three are bit-exact with each other. Only active lanes are decoded;
inactive lanes report zeros, as the JAX dispatcher's native and ref
backends do (uwspr_tpu/fec/__init__.py). Unlike that dispatcher, nothing
falls back: a failed build raises, and an unknown backend is a ValueError.
The native library is built from the source by ``utils.gxx_build`` into the
port's build directory.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np
import torch

from uwspr_tpu_torch.fec.fano import fano_decode_batch
from uwspr_tpu_torch.fec.fano_ref import fano_decode
from uwspr_tpu_torch.protocol.constants import FANO_METTAB, N_CODED_BITS
from uwspr_tpu_torch.utils.gxx_build import load_gxx_library

NATIVE_SOURCE = pathlib.Path(__file__).resolve().parent / "fano_native.cc"


def _configure(lib: ctypes.CDLL) -> None:
    lib.uwspr_fano_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.uwspr_fano_decode_batch.restype = None


def load_native_fano() -> ctypes.CDLL:
    """fano_native.cc built with g++ and loaded once per process."""
    return load_gxx_library(NATIVE_SOURCE, _configure)


def _native_decode(symbols, mettab, delta, maxcycles, device):
    n = symbols.shape[0]
    symbols = np.ascontiguousarray(symbols, np.uint8)
    met = np.ascontiguousarray(mettab, np.int32)
    data = np.zeros((n, N_CODED_BITS >> 3), np.uint8)
    succ = np.zeros(n, np.int32)
    metric = np.zeros(n, np.int32)
    cycles = np.zeros(n, np.uint32)
    maxnp = np.zeros(n, np.uint32)
    load_native_fano().uwspr_fano_decode_batch(
        symbols.ctypes.data, n, N_CODED_BITS, met.ctypes.data, delta,
        maxcycles, data.ctypes.data, succ.ctypes.data, metric.ctypes.data,
        cycles.ctypes.data, maxnp.ctypes.data)
    return succ != 0, data, metric, cycles, maxnp


def _port_decode(symbols, mettab, delta, maxcycles, device):
    out = fano_decode_batch(torch.from_numpy(symbols).to(device),
                            torch.from_numpy(np.asarray(mettab)).to(device),
                            delta=delta, maxcycles=maxcycles)
    host = {k: v.cpu().numpy() for k, v in out.items()}
    return (host["success"], host["data"], host["metric"],
            host["cycles"].astype(np.uint32), host["maxnp"].astype(np.uint32))


def _ref_decode(symbols, mettab, delta, maxcycles, device):
    rs = [fano_decode(s, mettab, delta=delta, maxcycles=maxcycles)
          for s in symbols]
    return (np.array([r.success for r in rs], bool),
            np.array([r.data for r in rs], np.uint8).reshape(
                len(rs), N_CODED_BITS >> 3),
            np.array([r.metric for r in rs], np.int32),
            np.array([r.cycles for r in rs], np.uint32),
            np.array([r.maxnp for r in rs], np.uint32))


# PipelineConfig.fano_backend -> decoder; the one list of valid backends.
BACKENDS = {"native": _native_decode, "jax": _port_decode, "ref": _ref_decode}


def check_backend(backend: str) -> None:
    """ValueError unless ``backend`` is a key of BACKENDS."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown fano backend {backend!r}")


def fano_decode_batch_host(symbols: np.ndarray,
                           active: np.ndarray | None = None, *,
                           backend: str, device: str | torch.device,
                           mettab: np.ndarray = FANO_METTAB, delta: int = 60,
                           maxcycles: int = 10000):
    """Decode (L, 162) u8 soft symbols with ``backend`` ("native", "jax" on
    ``device``, or "ref"). Returns numpy (success (L,) bool, data (L, 10)
    u8, metric (L,) int32, cycles (L,) uint32, maxnp (L,) uint32)."""
    check_backend(backend)
    symbols = np.asarray(symbols, np.uint8).reshape(-1, 2 * N_CODED_BITS)
    L = symbols.shape[0]
    act = np.ones(L, bool) if active is None else np.asarray(active, bool)
    out = (np.zeros(L, bool), np.zeros((L, N_CODED_BITS >> 3), np.uint8),
           np.zeros(L, np.int32), np.zeros(L, np.uint32),
           np.zeros(L, np.uint32))
    idx = np.flatnonzero(act)
    if len(idx):
        parts = BACKENDS[backend](symbols[idx], mettab, delta, maxcycles,
                                  device)
        for full, part in zip(out, parts):
            full[idx] = part
    return out


__all__ = ["BACKENDS", "NATIVE_SOURCE", "check_backend",
           "fano_decode_batch_host", "load_native_fano"]
