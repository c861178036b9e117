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
* Gluon training through ``parallel.SPMDTrainer`` — ``mx.nd`` and the op
  registry, ``gluon`` Blocks, Parameters, layers, losses and the ResNet
  model zoo, ``initializer``, ``parallel.functionalize``, and SGD with
  momentum over f32 masters (the ResNet-50 benchmark step);
* the imperative Gluon loop — the NDArray autograd tape (``attach_grad``,
  ``autograd.record``, ``backward``, ``autograd.grad``, ``Function``),
  ``gluon.Trainer`` over ``kvstore`` and the optimizer's ``Updater``,
  ``lr_scheduler``, ``metric``, ``io.NDArrayIter`` and ``callback``, and
  the registered kernel ops ``mx.nd.pallas_softmax``,
  ``pallas_scale_bias_relu`` and ``pallas_flash_attention``;
* the symbolic path — ``mx.sym`` graphs, their ``Executor`` (with the
  fused train step) and ``mx.mod.Module`` (``fit``, ``train_step``,
  ``score``, ``predict``, checkpoints through ``mx.model`` and
  ``nd.save`` / ``nd.load``), and ``mx.engine``;
* ``mx.rtc`` — user CUDA source compiled at run time by NVRTC
  (``CudaModule``), launched from ``mx.nd``, ``mx.sym`` and a Module
  through ``register_op``;
* BERT pretraining — ``models.BERT`` (the masked-LM and next-sentence
  heads over ``TransformerLM.run_stack``, non-causal attention) and
  ``mx.runtime`` (``Features``, ``scan_stack`` and its remat knobs);

with hand-written CUDA kernels for flash-attention forward and backward,
paged decode attention, the fused Adam step, the multi-tensor fused SGD
step, the row softmax (forward and backward) and the fused
scale-bias-ReLU (``ops/cuda_kernels.py``, sources in ``csrc/``), and the
user kernels ``mx.rtc`` compiles.

Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``device="cpu"`` / ``mx.cpu()``); without a GPU they raise.

Import as ``import mxnet_tpu_torch as mx``.
"""
from __future__ import annotations

__version__ = "0.1.0"

from . import config, telemetry
from .base import KernelUnsupportedError, MXNetError, MXNetErrorNoDevice
from .context import Context, cpu, gpu, num_gpus, current_context
from . import random, ndarray, autograd, initializer
from . import ndarray as nd
from . import initializer as init
from . import kernels, quantization, models, convert, deploy, serving
from . import generation, optimizer, lr_scheduler, kvstore, gluon, parallel
from . import metric, io, callback, engine, rtc, symbol, model, module
from . import executor, executor_manager, runtime
from . import symbol as sym
from . import module as mod
from . import kvstore as kv
from .ndarray.ndarray import NDArray

__all__ = ["MXNetError", "MXNetErrorNoDevice", "KernelUnsupportedError",
           "Context", "cpu", "gpu", "num_gpus", "current_context", "config",
           "telemetry", "random", "ndarray", "nd", "NDArray", "autograd",
           "initializer", "init", "kernels", "quantization", "models",
           "convert", "deploy", "serving", "generation", "optimizer",
           "lr_scheduler", "kvstore", "kv", "gluon", "parallel", "metric",
           "io", "callback", "engine", "rtc", "symbol", "sym", "model",
           "module", "mod", "executor", "executor_manager", "runtime"]
