"""NDArray: the imperative tensor handle (counterpart of
``mxnet_tpu.ndarray.ndarray``).

An NDArray is a thin mutable handle onto a ``torch.Tensor`` (``_data``).
Arithmetic and the methods below dispatch through the op registry, so an
expression on NDArrays runs the same registered ops as ``mx.nd.<Op>``.
``attach_grad`` marks an array as a leaf of the autograd tape
(``_tape.py``): under ``autograd.record()`` the ops on it record, and
``backward()`` fills its ``grad`` buffer.  ``_on_tape`` says whether an
array is a marked leaf or the output of a recorded op; ``_recorded``
whether it is the output of a differentiable op run under
``autograd.record()`` on arrays none of which was on the tape (it has no
history, and ``backward()`` from it changes no grad, as the reference's
does); ``_grad_req`` is None for an array that was never marked.

As in the reference, ``dtype`` is a numpy dtype (bfloat16 is
``ml_dtypes.bfloat16``; without ``ml_dtypes`` numpy has none, and
``torch.bfloat16`` stands in), 64-bit sources and dtypes become 32-bit
unless ``mx.config.enable_x64()`` (``base.canonical_dtype``), the
comparison operators return arrays of 0/1, and the in-place operators
and ``x[key] = value`` replace this array's value (``_data``), so every
reference to the NDArray sees the change while other arrays that shared
its old tensor keep theirs.  Inside ``autograd.record()`` an array on the
tape cannot be written in place.  Sparse storage (``stype`` is always
``"default"``), DLPack export and the numpy dispatch protocol are not
ported.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import _tape
from ..base import bfloat16_numpy, canonical_dtype, numpy_dtype
from ..resilience import atomic_write
from ..context import Context, cpu, gpu, resolve_device

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "linspace", "waitall", "concat", "stack", "split", "where",
           "save", "load"]


def _wrap(data):
    arr = NDArray.__new__(NDArray)
    arr._data = data
    arr._grad = None
    arr._grad_req = None
    arr._on_tape = False
    arr._recorded = False
    return arr


def with_context(arr, ctx):
    """``arr`` recording ``ctx`` as its Context when ``ctx`` is one."""
    if isinstance(ctx, Context):
        arr._ctx = ctx
    return arr


def _invoke(name, *args, **attrs):
    from ..ops.registry import invoke
    return invoke(name, *args, **attrs)


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "_on_tape", "_recorded",
                 "_ctx", "__weakref__")

    # numpy defers to NDArray in mixed expressions
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        self._data = _as_tensor(data, ctx, dtype)
        self._grad = None
        self._grad_req = None
        self._on_tape = False
        self._recorded = False

    # ------------------------------------------------------------------ meta
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        """The Context the array was made or placed on (``cpu(1)`` and
        ``cpu(0)`` are one torch device, so an array records it), else
        its device's."""
        dev = self._data.device
        ctx = getattr(self, "_ctx", None)
        if ctx is not None and (ctx.device_type == "gpu") == (
                dev.type == "cuda"):
            return ctx
        return gpu(dev.index or 0) if dev.type == "cuda" else cpu()

    ctx = context

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (self.asnumpy(),
                                         "x".join(map(str, self.shape)),
                                         self.context)

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self._data)

    def __float__(self):
        return float(self._data)

    def __int__(self):
        return int(self._data)

    # ------------------------------------------------------ host interchange
    def asnumpy(self):
        """The value as a numpy array of the same dtype; bf16 comes back as
        ``ml_dtypes.bfloat16``, or widened (exactly) to float32 where
        ``ml_dtypes`` does not import."""
        t = self._data.detach().cpu()
        if t.dtype == torch.bfloat16:
            bf16 = bfloat16_numpy()
            if bf16 is None:
                return t.float().numpy()
            return t.view(torch.int16).numpy().view(bf16)
        return t.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def copy(self):
        """A copy; the copy of an array on the tape is off it, as the
        reference's."""
        t = self._data.detach() if self._on_tape else self._data
        return _wrap(t.clone())

    # -------------------------------------------------------------- autograd
    @property
    def grad(self):
        """The gradient buffer ``attach_grad`` allocated (None before)."""
        return self._grad

    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a zero gradient buffer and mark this array as a leaf of
        the tape (reference ``MXAutogradMarkVariables``)."""
        grad = _wrap(torch.zeros_like(self._data.detach())) \
            if grad_req != "null" else None
        _tape.mark_variable(self, grad, grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array into the marked leaves it was computed
        from; ``out_grad`` is its own gradient (ones by default)."""
        _tape.backward([self], [out_grad], retain_graph, train_mode)

    def detach(self):
        """The same values, off the tape: history stops here."""
        return _wrap(self._data.detach())

    def wait_to_read(self):
        """Block until the work producing this array is done (reference
        ``NDArray::WaitToRead``)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def as_in_context(self, ctx):
        """This array on ``ctx``: itself when it is there already, else a
        copy (recorded, so gradients flow back, under ``record()``)."""
        device = resolve_device(ctx)
        if device == self._data.device:
            if not isinstance(ctx, Context) or ctx == self.context:
                return self
            # another context of the same device: the same tensor, its
            # own Context
            out = _wrap(self._data)
            out._on_tape, out._recorded = self._on_tape, self._recorded
            return with_context(out, ctx)
        return with_context(_invoke("_copy_to_device", self, device=device),
                            ctx)

    def _set_data(self, new_data):
        self._data = new_data

    def _check_mutable(self):
        if _tape.is_recording() and self._on_tape:
            raise RuntimeError(
                "in-place write to an NDArray that is part of a recorded "
                "computation graph is forbidden inside autograd.record() "
                "(reference: Imperative::RecordOp CHECK)")

    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data
        return _invoke("_slice_index", self, key=key)

    def __setitem__(self, key, value):
        """Write ``value`` (a scalar, an NDArray or an array-like,
        broadcast to the selection) at ``key``; a negative-step slice
        writes in its own order."""
        from ..ops.tensor import positive_steps
        self._check_mutable()
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(value, NDArray):
            value = value._data.detach()
        data = self._data.detach()
        pos, flips = positive_steps(key, data.shape)
        if isinstance(value, _np.ndarray) and value.dtype.name == "bfloat16":
            value = _bf16_tensor(value)
        value = torch.as_tensor(value).to(device=data.device,
                                          dtype=data.dtype)
        if _whole(pos):
            self._data = value.broadcast_to(data.shape).clone()
            return
        new = data.clone()
        value = value.broadcast_to(new[pos].shape)
        new[pos] = value.flip(flips) if flips else value
        self._data = new

    # ------------------------------------------------------------ arithmetic
    def _binop(self, name, other, reverse=False):
        a, b = (other, self) if reverse else (self, other)
        return _invoke(name, a, b)

    def __add__(self, o): return self._binop("broadcast_add", o)
    def __radd__(self, o): return self._binop("broadcast_add", o, True)
    def __sub__(self, o): return self._binop("broadcast_sub", o)
    def __rsub__(self, o): return self._binop("broadcast_sub", o, True)
    def __mul__(self, o): return self._binop("broadcast_mul", o)
    def __rmul__(self, o): return self._binop("broadcast_mul", o, True)
    def __truediv__(self, o): return self._binop("broadcast_div", o)
    def __rtruediv__(self, o): return self._binop("broadcast_div", o, True)
    def __pow__(self, o): return self._binop("broadcast_power", o)
    def __rpow__(self, o): return self._binop("broadcast_power", o, True)
    def __mod__(self, o): return self._binop("broadcast_mod", o)
    def __rmod__(self, o): return self._binop("broadcast_mod", o, True)
    def __matmul__(self, o): return self._binop("batch_dot_auto", o)
    def __neg__(self): return _invoke("negative", self)
    def __abs__(self): return _invoke("abs", self)

    def __eq__(self, o): return self._binop("broadcast_equal", o)
    def __ne__(self, o): return self._binop("broadcast_not_equal", o)
    def __gt__(self, o): return self._binop("broadcast_greater", o)
    def __ge__(self, o): return self._binop("broadcast_greater_equal", o)
    def __lt__(self, o): return self._binop("broadcast_lesser", o)
    def __le__(self, o): return self._binop("broadcast_lesser_equal", o)

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------- in place
    def _inplace(self, name, o):
        """``self = self <op> o`` on this handle, off the tape."""
        self._check_mutable()
        other = o.detach() if isinstance(o, NDArray) else o
        self._data = _invoke(name, self.detach(), other)._data
        return self

    def __iadd__(self, o): return self._inplace("broadcast_add", o)
    def __isub__(self, o): return self._inplace("broadcast_sub", o)
    def __imul__(self, o): return self._inplace("broadcast_mul", o)
    def __itruediv__(self, o): return self._inplace("broadcast_div", o)

    # ------------------------------------------------------------ transforms
    def reshape(self, *shape, **kwargs):
        """MXNet reshape: a 0 copies the input's dim, -1 is inferred."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if kwargs.get("shape") is not None:
            shape = tuple(kwargs["shape"])
        shape = tuple(self.shape[i] if s == 0 else s
                      for i, s in enumerate(shape))
        return _invoke("reshape", self, shape=shape)

    def astype(self, dtype, copy=True):
        return _invoke("cast", self, dtype=canonical_dtype(dtype))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke("transpose", self, axes=axes or None)

    def flatten(self):
        return _invoke("flatten", self)

    def abs(self):
        return _invoke("abs", self)

    def sign(self):
        return _invoke("sign", self)

    def exp(self):
        return _invoke("exp", self)

    def log(self):
        return _invoke("log", self)

    def sqrt(self):
        return _invoke("sqrt", self)

    def square(self):
        return _invoke("square", self)

    def relu(self):
        return _invoke("relu", self)

    def sigmoid(self):
        return _invoke("sigmoid", self)

    def tanh(self):
        return _invoke("tanh", self)

    def expand_dims(self, axis):
        return _invoke("expand_dims", self, axis=axis)

    def squeeze(self, axis=None):
        return _invoke("squeeze", self, axis=axis)

    def sum(self, axis=None, keepdims=False):
        return _invoke("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return _invoke("mean", self, axis=axis, keepdims=keepdims)

    def _reduce(self, name, axis=None, keepdims=False, **attrs):
        axis = tuple(axis) if isinstance(axis, list) else axis
        return _invoke(name, self, axis=axis, keepdims=keepdims, **attrs)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._reduce("norm", axis, keepdims, ord=ord)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return _invoke("argsort", self, axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return _invoke("sort", self, axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _invoke("topk", self, axis=axis, k=k, ret_typ=ret_typ,
                       is_ascend=is_ascend)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _invoke("dot", self, other, transpose_a=transpose_a,
                       transpose_b=transpose_b)

    @property
    def T(self):
        return self.transpose()

    def swapaxes(self, dim1, dim2):
        return _invoke("swapaxes", self, dim1=dim1, dim2=dim2)

    def reshape_like(self, other):
        return _invoke("reshape", self, shape=other.shape)

    def broadcast_to(self, shape):
        return _invoke("broadcast_to", self, shape=tuple(shape))

    def broadcast_like(self, other):
        return _invoke("broadcast_to", self, shape=other.shape)

    def tile(self, reps):
        reps = tuple(reps) if isinstance(reps, (tuple, list)) else (reps,)
        return _invoke("tile", self, reps=reps)

    def repeat(self, repeats, axis=None):
        return _invoke("repeat", self, repeats=repeats, axis=axis)

    def pad(self, mode="constant", pad_width=None, constant_value=0):
        return _invoke("pad", self, mode=mode, pad_width=tuple(pad_width),
                       constant_value=constant_value)

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _invoke("take", self, indices, axis=axis, mode=mode)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return _invoke("one_hot", self, depth=depth, on_value=on_value,
                       off_value=off_value)

    def clip(self, a_min=None, a_max=None):
        return _invoke("clip", self, a_min=a_min, a_max=a_max)

    def softmax(self, axis=-1):
        return _invoke("softmax", self, axis=axis)

    def log_softmax(self, axis=-1):
        return _invoke("log_softmax", self, axis=axis)

    # ------------------------------------------------------ storage, placement
    @property
    def stype(self):
        return "default"

    def tostype(self, stype):
        """Dense only: sparse storage comes with slice 16."""
        if stype != "default":
            raise NotImplementedError(
                "tostype(%r): sparse storage is not ported yet (slice 16)"
                % (stype,))
        return self

    def tolist(self):
        return self.asnumpy().tolist()

    def wait_to_write(self):
        """Block until the work writing this array is done."""
        return self.wait_to_read()

    def copyto(self, other):
        """A copy on a context (recorded, so gradients flow back, under
        ``record()``), or this array's value written into the NDArray
        ``other`` (in its dtype, on its device), which is returned."""
        if isinstance(other, Context):
            if _tape.is_recording():
                return with_context(_invoke("_copy_to_device", self,
                                            device=resolve_device(other)),
                                    other)
            t = self._data.detach() if self._on_tape else self._data
            return with_context(_wrap(t.to(resolve_device(other), copy=True)),
                                other)
        if isinstance(other, NDArray):
            other._check_mutable()
            other._data = self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype,
                copy=True)
            return other
        raise TypeError("copyto does not support type %s" % type(other))

    def as_in_ctx(self, ctx):
        return self.as_in_context(ctx)



def _whole(key):
    """Whether index ``key`` is ``[:]``, the whole array."""
    if isinstance(key, tuple) and len(key) == 1:
        key = key[0]
    return isinstance(key, slice) and key == slice(None)


# ------------------------------------------------------------- creation
def _bf16_tensor(a):
    """A numpy array of bf16 bit patterns (``ml_dtypes.bfloat16``, or the
    2-byte void that ``numpy.save`` writes for it) as a bf16 tensor."""
    return torch.from_numpy(
        _np.ascontiguousarray(a).view(_np.int16).copy()).view(torch.bfloat16)


def _as_tensor(source, ctx=None, dtype=None):
    """``source`` as a tensor on ``ctx`` (the current context by default:
    ``cuda:0`` unless the caller asks for the CPU), 64-bit dtypes
    canonicalized to 32-bit as the reference's ``dtype_np`` does."""
    if isinstance(source, NDArray):
        source = source._data
    if dtype is None:
        # MXNet: an array source keeps its dtype, a list or scalar is f32
        if isinstance(source, (torch.Tensor, _np.ndarray)):
            dtype = source.dtype
        else:
            dtype = torch.float32
    if isinstance(source, _np.ndarray) and source.dtype.name == "bfloat16":
        source = _bf16_tensor(source)
    t = torch.as_tensor(source)
    return t.to(device=resolve_device(ctx), dtype=canonical_dtype(dtype))


def array(source_array, ctx=None, dtype=None):
    return with_context(_wrap(_as_tensor(source_array, ctx, dtype)), ctx)


def full(shape, val, ctx=None, dtype=None, **_):
    if isinstance(shape, int):
        shape = (shape,)
    return with_context(_wrap(torch.full(
        tuple(shape), val, dtype=canonical_dtype(dtype),
        device=resolve_device(ctx))), ctx)


def zeros(shape, ctx=None, dtype=None, **_):
    return full(shape, 0, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **_):
    return full(shape, 1, ctx, dtype)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return _invoke("_arange", start=start, stop=stop, step=step,
                   repeat=repeat, ctx=ctx, dtype=dtype)


def eye(N, M=0, k=0, ctx=None, dtype=None):
    return _invoke("_eye", N=N, M=M, k=k, ctx=ctx, dtype=dtype)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    return _invoke("_linspace", start=start, stop=stop, num=num,
                   endpoint=endpoint, ctx=ctx, dtype=dtype)


def stack(*data, axis=0):
    return _invoke("stack", *data, axis=axis)


def split(data, num_outputs, axis=1, squeeze_axis=False):
    return _invoke("split", data, num_outputs=num_outputs, axis=axis,
                   squeeze_axis=squeeze_axis)


def where(condition, x, y):
    return _invoke("where", condition, x, y)


def waitall():
    """Wait for all queued device work (``Engine::WaitForAll``)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def concat(*data, dim=1):
    return _invoke("concat", *data, dim=dim)



def _saved(arr):
    """What the npz container holds for ``arr``: its numpy value; bf16 as
    its 16-bit patterns in a 2-byte void, which is what ``numpy.save``
    writes for the reference's ``ml_dtypes.bfloat16`` arrays."""
    t = arr._data.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_np.dtype("V2"))
    return t.numpy()


def _loaded(a):
    """An array read from the container: a 2-byte void is bf16."""
    if a.dtype == _np.dtype("V2"):
        return array(_bf16_tensor(a))
    return array(a)


def save(fname, data):
    """Save an NDArray, a list or a dict of them in the reference's npz
    container (``mxnet_tpu/ndarray/ndarray.py:647``), written atomically.
    Every dtype is stored as it is; bf16 as the reference's file holds it
    (see :func:`_saved`)."""
    if isinstance(data, NDArray):
        names, payload = ["__mx_single__"], [data]
    elif isinstance(data, (list, tuple)):
        payload = list(data)
        names = ["__mx_list_%d__" % i for i in range(len(payload))]
    elif isinstance(data, dict):
        names = sorted(data)
        payload = [data[n] for n in names]
    else:
        raise TypeError("save expects NDArray, list or dict")
    arrays = {n: _saved(p) for n, p in zip(names, payload)}
    with atomic_write(fname, "wb") as f:
        _np.savez(f, **arrays)


def load(fname):
    """Load what :func:`save` (or the reference's ``nd.save``) wrote, or
    an Apache-MXNet ``.params`` file (``compat.load_mxnet_params``): an
    NDArray, a list or a dict, on the current context."""
    from ..compat import is_mxnet_params, load_mxnet_params
    with open(fname, "rb") as f:
        head = f.read(8)
    if is_mxnet_params(head):
        with open(fname, "rb") as f:
            raw = load_mxnet_params(f.read())
        if isinstance(raw, list):
            return [array(v) for v in raw]
        return {n: array(v) for n, v in raw.items()}
    with _np.load(fname, allow_pickle=False) as zf:
        names = list(zf.keys())
        if names == ["__mx_single__"]:
            return _loaded(zf["__mx_single__"])
        if names and all(n.startswith("__mx_list_") for n in names):
            return [_loaded(zf["__mx_list_%d__" % i])
                    for i in range(len(names))]
        return {n: _loaded(zf[n]) for n in names}
