"""``mx.rtc`` — user CUDA kernels compiled at run time (counterpart of
``mxnet_tpu.rtc``, K7).

Reference: ``include/mxnet/rtc.h:39-61`` ``CudaModule`` and
``python/mxnet/rtc.py``: users hand the framework CUDA source at run time,
NVRTC compiles it, and its kernels launch on the framework's stream when
the built-in kernels fall short.  The JAX package re-designed this API
for Pallas (``PallasModule``); on the H100 it is the reference's own
again:

* :class:`CudaModule` compiles ``source`` with NVRTC for ``sm_90a`` into a
  cubin and loads it per device with the driver API (``ops/_cudart.py``).
  ``exports`` are C++ name expressions (template instantiations) whose
  lowered names are looked up at compile time; ``extern "C"`` kernels need
  none.
* :meth:`CudaModule.get_kernel` takes the reference's C-like signature
  (``"const float *x, float *y, int n"``, names optional): ``*`` marks a
  tensor, ``const`` an input.  Types: ``float``, ``double``, ``__half``,
  ``__nv_bfloat16``, ``int8_t``, ``uint8_t``, ``int32_t`` / ``int``,
  ``int64_t``.
* :meth:`CudaKernel.launch` checks each tensor's dtype, device and
  contiguity against the signature, marshals scalars as the signature's C
  type, and launches with ``cuLaunchKernel`` on PyTorch's current stream
  without synchronising.
* :func:`register_op` puts a kernel into the op registry, so that
  ``mx.nd.<op>`` and ``mx.sym.<op>`` reach it.

There is no CPU route: no plain version of user source exists and none
is invented, so a CPU tensor or a CPU ``ctx`` raises.  Each launch adds
one to ``cuda_kernels.LAUNCHES["rtc"]`` and to :data:`LAUNCHES` under the
kernel's name.
"""
from __future__ import annotations

import collections
import ctypes
import re
import threading
import time

import numpy as _np
import torch

from .base import torch_dtype
from .context import Context, current_context, resolve_device
from .ops import _cudart
from .ops import cuda_kernels as _ck

__all__ = ["CudaModule", "CudaKernel", "register_op", "parse_signature",
           "marshal", "Arg", "LAUNCHES", "reset_launches"]

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES = collections.Counter()

#: C type -> (tensor dtype, ctypes type of a scalar argument)
_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "__nv_bfloat16": (torch.bfloat16, ctypes.c_uint16),
    "int8_t": (torch.int8, ctypes.c_int8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
}
_INT_RANGE = {"int8_t": (-2 ** 7, 2 ** 7 - 1), "uint8_t": (0, 2 ** 8 - 1),
              "int32_t": (-2 ** 31, 2 ** 31 - 1),
              "int": (-2 ** 31, 2 ** 31 - 1),
              "int64_t": (-2 ** 63, 2 ** 63 - 1)}

#: one parsed signature entry
Arg = collections.namedtuple("Arg", ["name", "ctype", "is_tensor",
                                     "is_const"])

_ARG_RE = re.compile(r"^\s*(const\s+)?([A-Za-z_]\w*)\s*(\*)?\s*"
                     r"([A-Za-z_]\w*)?\s*$")


def reset_launches():
    LAUNCHES.clear()


def parse_signature(signature):
    """The reference's kernel signature (``"const float *x, float *y, int
    n"``; names optional) as a list of :class:`Arg`."""
    if not signature.strip():
        return []
    args = []
    for i, item in enumerate(signature.split(",")):
        m = _ARG_RE.match(item)
        if m is None:
            raise ValueError("cannot parse argument %d (%r) of signature %r"
                             % (i, item.strip(), signature))
        const, ctype, star, name = m.groups()
        if ctype not in _TYPES:
            raise ValueError("argument %d of signature %r: unknown type %r "
                             "(have %s)" % (i, signature, ctype,
                                            ", ".join(_TYPES)))
        args.append(Arg(name or "arg%d" % i, ctype, star is not None,
                        const is not None))
    return args


def _bits16(value, dtype):
    """The 16-bit pattern of ``value`` rounded to f16 or bf16."""
    t = torch.tensor(float(value), dtype=dtype)
    return int(t.view(torch.int16)) & 0xFFFF


def _scalar(arg, value):
    """A ctypes value holding ``value`` as ``arg``'s C type."""
    if isinstance(value, (torch.Tensor, _np.ndarray)) or \
            hasattr(value, "_data"):
        raise TypeError("argument %r is a scalar %s: pass a Python number"
                        % (arg.name, arg.ctype))
    ctype = _TYPES[arg.ctype][1]
    if arg.ctype == "__half":
        return ctype(_bits16(value, torch.float16))
    if arg.ctype == "__nv_bfloat16":
        return ctype(_bits16(value, torch.bfloat16))
    if arg.ctype in _INT_RANGE:
        lo, hi = _INT_RANGE[arg.ctype]
        if int(value) != value or not lo <= value <= hi:
            raise ValueError("argument %r: %r is not an %s"
                             % (arg.name, value, arg.ctype))
        return ctype(int(value))
    return ctype(float(value))


def _tensor(arg, value, device):
    """``value``'s tensor, checked against ``arg`` and the launch
    device."""
    t = getattr(value, "_data", value)
    if not isinstance(t, torch.Tensor):
        raise TypeError("argument %r is a %s pointer: pass an NDArray or a "
                        "torch.Tensor, got %s"
                        % (arg.name, arg.ctype, type(value).__name__))
    want = _TYPES[arg.ctype][0]
    if t.dtype != want:
        raise TypeError("argument %r: the signature says %s (%s), the "
                        "tensor is %s" % (arg.name, arg.ctype, want, t.dtype))
    if t.device != device:
        raise ValueError(
            "argument %r lies on %s, the launch is on %s: rtc kernels run "
            "only on a CUDA device (there is no CPU version of user source)"
            % (arg.name, t.device, device))
    if not t.is_contiguous():
        raise ValueError("argument %r is not contiguous" % (arg.name,))
    return t


def marshal(args, values, device):
    """The ``kernelParams`` array for ``values`` under signature ``args``:
    a pointer to each argument's value (device pointers as 64-bit
    ``c_void_p``, scalars as their C type).  Returns ``(params,
    holders)``; keep ``holders`` alive until the launch returns."""
    if len(values) != len(args):
        raise ValueError("the signature has %d arguments, got %d"
                         % (len(args), len(values)))
    holders = []
    for arg, v in zip(args, values):
        if arg.is_tensor:
            holders.append(ctypes.c_void_p(_tensor(arg, v, device)
                                           .data_ptr()))
        else:
            holders.append(_scalar(arg, v))
    params = (ctypes.c_void_p * len(holders))(
        *[ctypes.addressof(h) for h in holders])
    return params, holders


def _launch_device(ctx):
    """The CUDA device a launch runs on: ``ctx`` (a Context, a
    ``torch.device`` or a device string; the current context when None).
    A CPU one raises."""
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context) and ctx.device_type != "gpu":
        raise ValueError("rtc kernels run only on a CUDA device, got ctx %r "
                         "(there is no CPU version of user source)" % (ctx,))
    device = resolve_device(ctx)
    if device.type != "cuda":
        raise ValueError("rtc kernels run only on a CUDA device, got %s "
                         "(there is no CPU version of user source)" % device)
    return device


def _dims(dims):
    dims = (dims,) if isinstance(dims, int) else tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError("grid and block dims are 1 to 3 positive ints, got "
                         "%r" % (dims,))
    return dims + (1,) * (3 - len(dims))


class CudaModule:
    """User CUDA source compiled by NVRTC (reference ``CudaModule``).
    ``compile_ms`` is the NVRTC time, ``log`` its log."""

    def __init__(self, source, options=(), exports=()):
        self.exports = tuple(exports)
        t0 = time.perf_counter()
        self._image, self._lowered, self.log = _cudart.compile_program(
            source, "mxnet_rtc.cu", tuple(options), self.exports)
        self.compile_ms = (time.perf_counter() - t0) * 1e3
        self._lock = threading.Lock()
        self._modules = {}     # guarded-by: _lock — ordinal -> CUmodule
        self._functions = {}   # guarded-by: _lock — (ordinal, lowered)
        #                        -> [CUfunction, dynamic shared bytes allowed]

    def _function(self, name, ordinal, shared_mem=0):
        """The loaded kernel ``name`` on device ``ordinal``, allowed
        ``shared_mem`` bytes of dynamic shared memory."""
        lowered = self._lowered.get(name, name)
        with self._lock:
            entry = self._functions.get((ordinal, lowered))
            if entry is None:
                mod = self._modules.get(ordinal)
                if mod is None:
                    mod = self._modules[ordinal] = _cudart.load_module(
                        self._image, ordinal)
                fn = _cudart.get_function(mod, lowered)
                if fn is None:
                    raise KeyError(
                        "no kernel %r in module (an extern \"C\" kernel's "
                        "name, or one of exports %s)" % (name,
                                                         list(self.exports)))
                entry = self._functions[(ordinal, lowered)] = [fn, 48 * 1024]
            if shared_mem > entry[1]:
                _cudart.set_max_dynamic_shared(entry[0], shared_mem)
                entry[1] = shared_mem
            return entry[0]

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name or an export) with
        its ``signature``; an unknown name raises ``KeyError``."""
        args = parse_signature(signature)
        self._function(name, _cudart.current_device())
        return CudaKernel(self, name, args)


class CudaKernel:
    """A launchable kernel of a :class:`CudaModule` (reference
    ``CudaKernel``)."""

    def __init__(self, module, name, args):
        self._module = module
        self.name = name
        self.args = args

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx``'s CUDA device with ``args`` (NDArrays or
        tensors for pointers, Python numbers for scalars), ``grid_dims``
        and ``block_dims`` of 1 to 3 ints and ``shared_mem`` bytes of
        dynamic shared memory, on PyTorch's current stream."""
        device = _launch_device(ctx)
        # ``holders`` keeps the argument values alive through the launch
        params, holders = marshal(self.args, list(args), device)
        fn = self._module._function(self.name, device.index, int(shared_mem))
        _cudart.launch(fn, device.index, _dims(grid_dims), _dims(block_dims),
                       shared_mem, _cudart.current_stream(device), params)
        _ck.LAUNCHES["rtc"] += 1
        LAUNCHES[self.name] += 1


def _out_specs(spec):
    """``(shape, dtype)`` or a list of them -> (list, single?)."""
    if isinstance(spec, list):
        return spec, False
    return [spec], True


def register_op(op_name, kernel, out_shape, grid_dims, block_dims,
                shared_mem=0, scalars=None, differentiable=False):
    """Register ``kernel`` as op ``op_name`` (reference ``rtc.py:118``), so
    that ``mx.nd.<op_name>`` and ``mx.sym.<op_name>`` reach it.

    The kernel's signature lists the inputs (``const T*``), then the
    outputs (``T*``), then the scalars ``scalars(*inputs)`` returns.
    ``out_shape(*inputs)`` gives ``(shape, dtype)`` for the output, or a
    list of them; the outputs are allocated with ``torch.empty`` on the
    inputs' device.  ``grid_dims``, ``block_dims`` and ``shared_mem`` may
    be callables of the inputs.  The op launches on its inputs' device,
    so a CPU input raises; on ``meta`` tensors it only gives the output
    shapes (symbolic shape inference).  A non-differentiable op records
    nothing on the autograd tape; the kernel has no backward either way.
    Returns ``kernel``."""
    from .ops.registry import register

    def resolve(v, inputs):
        return v(*inputs) if callable(v) else v

    def op_fn(*inputs, **_):
        specs, single = _out_specs(out_shape(*inputs))
        device = inputs[0].device
        outs = [torch.empty(tuple(s), dtype=torch_dtype(d), device=device)
                for s, d in specs]
        if device.type != "meta":
            extra = list(scalars(*inputs)) if scalars is not None else []
            kernel.launch([x.contiguous() for x in inputs] + outs + extra,
                          device, resolve(grid_dims, inputs),
                          resolve(block_dims, inputs),
                          resolve(shared_mem, inputs))
        return outs[0] if single else tuple(outs)

    op_fn.__name__ = op_name
    register(op_name, differentiable=differentiable)(op_fn)
    return kernel
