"""uwspr_tpu_torch — the PyTorch + CUDA port of uwspr_tpu's decode engines.

The JAX package ``uwspr_tpu`` stays the reference; this package mirrors its
layout module for module. The port imports ``torch`` and never ``jax``, and
nothing of ``uwspr_tpu``: it holds its own copies of the reference's JAX-free
layers (``config``, ``protocol``, ``io.c2file``, ``io.channel``, ``fec.osd``,
``fec.fano_ref``, the native Fano source ``fec/fano_native.cc``,
``utils.timers`` and the numpy half of ``models.slm``), which the tests hold
equal to the originals.

Entry points: ``pipeline.device_decoder.DeviceDecoder`` (the batched
serving path) and ``pipeline.decoder.WindowDecoder`` (the host engine).
Every tensor lives on the device the caller names; nothing falls back from
CUDA to the CPU. Each TPU kernel of the reference has a CUDA kernel written
by hand (``csrc/``): drift-model selection, the Fano decoder, probe tone
powers and the fused STFT power. Each has a plain PyTorch version beside it
that is used for CPU tensors.
"""

__version__ = "0.1.0"
