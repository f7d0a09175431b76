"""The decoder's constant state, carried between the JAX package and the port.

The decoder has no learned weights. Its parameters are the constants that
uwspr_tpu's ``DeviceDecoder.__init__`` builds (jit_decoder.py:113-137),
named here after those attributes without the leading underscore:

    offsets      (M, 162) int32  per-symbol bin offsets of the drift models
    is_nl        (M,)     bool   nonlinear (SLM) model flags, linear first
    model_drift  (M,)     f32    linear drift per model (0 for SLM)
    model_slm    (M, 4)   f32    SLM (V1, V2, p1, p2) per model (0 for linear)
    sign         (162,)   f32    sync sign 2*SYNC_VECTOR - 1
    sync_bit     (162,)   bool   SYNC_VECTOR as bool
    mettab       (2, 256) int32  Fano metric table
    perm         (162,)   int    interleave permutation
    jiggles      (J,)     int32  retry lag offsets
    osd_G        (162, 50) int32 OSD generator matrix (0/1), only when
                                 on-device OSD is on (``state_keys(config)``)

These are the numpy arrays, typed as the JAX decoder holds them.
``state_numpy(config)`` builds them the way the JAX decoder does;
``state_from_numpy(d, device, keys=state_keys(config))`` turns such a dict
(for example one read off a JAX ``DeviceDecoder``) into the port's tensors
on ``device``, with the torch dtype of ``STATE_SPEC``: osd_G becomes
float32 0/1 there, the operand of ``fec/osd_torch.py``'s f32 GF(2)
products.

The host engine (``pipeline/decoder.py::WindowDecoder``) carries the
drift-bank part only, ``HOST_STATE_KEYS``: ``host_state_numpy(config)``
builds it, ``host_state_of(coarse, fine)`` reads it off a ``CoarseSearch``
(its ``.models``) and a ``FineSync`` (``jiggle_offsets()``) of either
package, and ``host_bank(d)`` validates it and splits it into the
``DriftModelBank`` and the jiggle offsets.
"""

from __future__ import annotations

import numpy as np
import torch

from uwspr_tpu_torch.coarse.search import DriftModelBank, build_drift_models
from uwspr_tpu_torch.config import PipelineConfig
from uwspr_tpu_torch.demod.finesync import jiggle_offsets
from uwspr_tpu_torch.device import resolve_device
from uwspr_tpu_torch.fec.osd import generator_matrix
from uwspr_tpu_torch.protocol.constants import (
    FANO_METTAB,
    INTERLEAVE_PERM,
    SYNC_VECTOR,
)

# name -> (numpy dtype kind the value must have, torch dtype on the device)
STATE_SPEC = {
    "offsets": ("i", torch.int64),
    "is_nl": ("b", torch.bool),
    "model_drift": ("f", torch.float32),
    "model_slm": ("f", torch.float32),
    "sign": ("f", torch.float32),
    "sync_bit": ("b", torch.bool),
    "mettab": ("i", torch.int32),
    "perm": ("i", torch.int64),
    "jiggles": ("i", torch.int64),
    "osd_G": ("i", torch.float32),
}
HOST_STATE_KEYS = ("offsets", "is_nl", "model_drift", "model_slm", "jiggles")


def state_keys(config: PipelineConfig | None = None) -> tuple[str, ...]:
    """The state a DeviceDecoder of ``config`` carries: osd_G only when
    on-device OSD is on, osd_depth > 0 and osd_max_lanes > 0
    (jit_decoder.py:127-134)."""
    d = (config or PipelineConfig()).demod
    osd = d.osd_depth > 0 and d.osd_max_lanes > 0
    return tuple(k for k in STATE_SPEC if k != "osd_G" or osd)


def state_numpy(config: PipelineConfig) -> dict[str, np.ndarray]:
    """The constants of jit_decoder.py:113-137 for ``config``."""
    models = build_drift_models(config.coarse)
    dcfg = config.demod
    osd = ({"osd_G": np.asarray(generator_matrix(), np.int32)}
           if "osd_G" in state_keys(config) else {})
    return {
        "offsets": np.asarray(models.offsets),
        "is_nl": np.asarray(models.is_nonlinear),
        "model_drift": np.asarray(models.drift),
        "model_slm": np.asarray(models.slm_params),
        "sign": 2.0 * SYNC_VECTOR.astype(np.float32) - 1.0,
        "sync_bit": SYNC_VECTOR.astype(bool),
        "mettab": np.asarray(FANO_METTAB),
        "perm": np.asarray(INTERLEAVE_PERM),
        "jiggles": jiggle_offsets(dcfg.n_jiggles, dcfg.iifac),
        **osd,
    }


def state_from_numpy(d: dict[str, np.ndarray], device: str | torch.device,
                     keys: tuple[str, ...] | None = None
                     ) -> dict[str, torch.Tensor]:
    """Validate a state dict of numpy arrays holding exactly ``keys`` (by
    default ``state_keys()``: a decoder without on-device OSD) and move it
    to ``device``."""
    dev = resolve_device(device)
    keys = state_keys() if keys is None else keys
    missing = set(keys) - set(d)
    extra = set(d) - set(keys)
    if missing or extra:
        raise ValueError(f"decoder state: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    out = {}
    for name in keys:
        kind, tdtype = STATE_SPEC[name]
        a = np.asarray(d[name])
        if a.dtype.kind not in (kind, "u" if kind == "i" else kind):
            raise ValueError(f"decoder state {name}: dtype {a.dtype} is not "
                             f"of kind {kind!r}")
        out[name] = torch.as_tensor(np.ascontiguousarray(a)).to(
            device=dev, dtype=tdtype)
    M = out["offsets"].shape[0]
    shapes = {"offsets": (M, 162), "is_nl": (M,), "model_drift": (M,),
              "model_slm": (M, 4), "sign": (162,), "sync_bit": (162,),
              "mettab": (2, 256), "perm": (162,), "osd_G": (162, 50)}
    for name, shape in shapes.items():
        if name in out and tuple(out[name].shape) != shape:
            raise ValueError(f"decoder state {name}: shape "
                             f"{tuple(out[name].shape)}, expected {shape}")
    if out["jiggles"].dim() != 1:
        raise ValueError("decoder state jiggles must be 1-D")
    return out


def host_state_numpy(config: PipelineConfig) -> dict[str, np.ndarray]:
    """The host engine's part of state_numpy(config)."""
    full = state_numpy(config)
    return {k: full[k] for k in HOST_STATE_KEYS}


def host_state_of(coarse, fine) -> dict[str, np.ndarray]:
    """The host engine's state read off a CoarseSearch (``.models``, the
    drift-model bank) and a FineSync (``jiggle_offsets()``), from the JAX
    package or the port."""
    m = coarse.models
    return {"offsets": np.asarray(m.offsets),
            "is_nl": np.asarray(m.is_nonlinear),
            "model_drift": np.asarray(m.drift),
            "model_slm": np.asarray(m.slm_params),
            "jiggles": np.asarray(fine.jiggle_offsets())}


def host_bank(d: dict[str, np.ndarray]
              ) -> tuple[DriftModelBank, np.ndarray]:
    """Validate a host-engine state dict -> (drift-model bank, jiggle
    offsets (J,) int32)."""
    t = state_from_numpy(d, "cpu", keys=HOST_STATE_KEYS)
    bank = DriftModelBank(offsets=t["offsets"].numpy().astype(np.int32),
                          is_nonlinear=t["is_nl"].numpy(),
                          drift=t["model_drift"].numpy(),
                          slm_params=t["model_slm"].numpy())
    return bank, t["jiggles"].numpy().astype(np.int32)


__all__ = ["HOST_STATE_KEYS", "STATE_SPEC", "host_bank", "host_state_numpy",
           "host_state_of", "state_from_numpy", "state_keys", "state_numpy"]
