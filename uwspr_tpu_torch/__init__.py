"""uwspr_tpu_torch — the PyTorch + CUDA port of uwspr_tpu's serving decode.

The JAX package ``uwspr_tpu`` stays the reference; this package mirrors its
layout module for module. The port imports ``torch`` and never ``jax``. It
reuses the reference's JAX-free host layers as they are: ``uwspr_tpu.config``,
``uwspr_tpu.protocol``, ``uwspr_tpu.io.channel`` and the numpy half of
``uwspr_tpu.models.slm``.

Entry point: ``uwspr_tpu_torch.pipeline.device_decoder.DeviceDecoder``.
Every tensor lives on the device the caller names; nothing falls back from
CUDA to the CPU. The two sequential walks of the decode, drift-model
selection and the Fano decoder, are CUDA kernels written by hand
(``csrc/``), each with a plain PyTorch version beside it that is used for
CPU tensors.
"""

__version__ = "0.1.0"
