"""uwspr_tpu_torch — the PyTorch + CUDA port of uwspr_tpu's decode engines.

The JAX package ``uwspr_tpu`` stays the reference; this package mirrors its
layout module for module. The port imports ``torch`` and never ``jax``. It
reuses the reference's JAX-free host layers as they are: ``uwspr_tpu.config``,
``uwspr_tpu.protocol``, ``uwspr_tpu.io.c2file``, ``uwspr_tpu.io.channel``,
``uwspr_tpu.fec.osd``, ``uwspr_tpu.fec.fano_ref``, ``uwspr_tpu.utils.timers``
and the numpy half of ``uwspr_tpu.models.slm``.

Entry points: ``pipeline.device_decoder.DeviceDecoder`` (the batched
serving path) and ``pipeline.decoder.WindowDecoder`` (the host engine).
Every tensor lives on the device the caller names; nothing falls back from
CUDA to the CPU. Each TPU kernel of the reference has a CUDA kernel written
by hand (``csrc/``): drift-model selection, the Fano decoder, probe tone
powers and the fused STFT power. Each has a plain PyTorch version beside it
that is used for CPU tensors.
"""

__version__ = "0.1.0"
