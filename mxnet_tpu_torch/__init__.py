"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu`` for one NVIDIA
H100 (Hopper, sm_90a).

``mxnet_tpu`` (JAX + Pallas) stays in the repository as the reference;
this package mirrors its module names and is held against it by the
``tests/test_torch_*.py`` parity tests.  It imports ``torch`` and never
``jax`` nor anything of ``mxnet_tpu``.

Ported so far:

* the generation-serving path — ``Server.register(..., generate=True)``
  -> ``GenerationEngine`` -> ``GenerationPredictor`` ->
  ``TransformerLM.prefill`` / ``decode_step``;
* TransformerLM training — ``TransformerLM.loss`` -> ``backward()`` ->
  ``optimizer.Adam.update_multi_precision`` (bf16 weights over f32
  masters);

with hand-written CUDA kernels for flash-attention forward and backward,
paged decode attention and the fused Adam step (``ops/cuda_kernels.py``,
sources in ``csrc/``).

Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``device="cpu"`` / ``mx.cpu()``); without a GPU they raise.

Import as ``import mxnet_tpu_torch as mx``.
"""
from __future__ import annotations

__version__ = "0.1.0"

from . import config, telemetry
from .base import KernelUnsupportedError, MXNetError, MXNetErrorNoDevice
from .context import Context, cpu, gpu, num_gpus
from . import kernels, quantization, models, convert, deploy, serving
from . import generation, optimizer

__all__ = ["MXNetError", "MXNetErrorNoDevice", "KernelUnsupportedError",
           "Context", "cpu", "gpu", "num_gpus", "config", "telemetry",
           "kernels", "quantization", "models", "convert", "deploy",
           "serving", "generation", "optimizer"]
