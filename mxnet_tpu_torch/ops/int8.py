"""The int8 product route: ``x @ wᵀ`` and N-C-first convolution over int8
operands with exact int32 accumulation (what the reference computes with
``lax.dot_general`` / ``conv_general_dilated`` at
``preferred_element_type=int32`` in ``mxnet_tpu.quantization`` and the
quantized ops of ``mxnet_tpu.ops.contrib``).

On CUDA tensors both products go through ``torch._int_mm`` (cuBLASLt's
int8 GEMM with int32 accumulation).  Its shape rules: more than 16 rows,
and the inner and output dims multiples of 8.  The route pads the rows
and the inner dim with zeros (exact in integers) and slices the result.
The convolution lays its patches out first (im2col, through a strided
view of the zero-padded int8 input, one GEMM a group): no PyTorch op
convolves int8 on CUDA.  A call the route cannot take raises
:class:`~mxnet_tpu_torch.base.KernelUnsupportedError`; there is no float
path.

On CPU tensors the same patch layout feeds the plain version, an int32
``torch.mm`` (exact, whatever the summation order).

``PRODUCTS["int8_mm"]`` counts the ``_int_mm`` GEMMs on the card (one a
product; a grouped convolution is one product), ``PRODUCTS["plain"]``
the plain products on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import KernelUnsupportedError

__all__ = ["int8_matmul", "int8_conv", "int8_matmul_plain",
           "int8_conv_plain", "PRODUCTS", "reset_products"]

PRODUCTS = {"int8_mm": 0, "plain": 0}

#: ``torch._int_mm``'s rules: rows > 16, inner and output dims % 8
_MIN_ROWS = 17
_ALIGN = 8


def reset_products():
    for k in PRODUCTS:
        PRODUCTS[k] = 0


def _ceil_to(n, m):
    return -(-n // m) * m


def _check_int8(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.int8:
            raise KernelUnsupportedError(
                "%s takes int8 operands, got %s" % (name, t.dtype))
        if t.device != dev:
            raise KernelUnsupportedError(
                "%s: operands on %s and %s" % (name, dev, t.device))


def _mm_cuda(a, w):
    """``a [M, K] @ w [N, K]ᵀ`` through ``torch._int_mm``, zero-padded to
    its shape rules; returns int32 ``[M, N]``.  cuBLASLt takes the int8
    operands as a row-major ``a`` and a column-major ``wᵀ`` only (a
    patch view may come column-major: it is copied)."""
    a, w = a.contiguous(), w.contiguous()
    M, K = a.shape
    N = w.shape[0]
    Kp, Np, Mp = _ceil_to(K, _ALIGN), _ceil_to(N, _ALIGN), max(M, _MIN_ROWS)
    if Kp != K or Mp != M:
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if Kp != K or Np != N:
        w = F.pad(w, (0, Kp - K, 0, Np - N))
    try:
        out = torch._int_mm(a, w.t())
    except RuntimeError as exc:
        raise KernelUnsupportedError(
            "torch._int_mm refused [%d, %d] x [%d, %d]: %s"
            % (Mp, Kp, Kp, Np, exc)) from exc
    PRODUCTS["int8_mm"] += 1
    return out[:M, :N]


def int8_matmul_plain(xq, wq):
    """The plain version: int32 ``xq @ wqᵀ`` on the CPU."""
    PRODUCTS["plain"] += 1
    return torch.mm(xq.to(torch.int32), wq.to(torch.int32).t())


def int8_matmul(xq, wq):
    """``xq [M, K] int8 @ wq [N, K] int8 ᵀ -> int32 [M, N]``, exact."""
    _check_int8("int8_matmul", xq, wq)
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise KernelUnsupportedError(
            "int8_matmul takes [M, K] and [N, K], got %s and %s"
            % (tuple(xq.shape), tuple(wq.shape)))
    if xq.device.type == "cuda":
        return _mm_cuda(xq, wq)
    if xq.device.type != "cpu":
        raise KernelUnsupportedError(
            "int8_matmul: no route on %s" % (xq.device,))
    return int8_matmul_plain(xq, wq)


def _tup(v, n, default):
    if v is None:
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(i) for i in v)
    return t if len(t) == n else t + (t[-1],) * (n - len(t))


def _patches(xq, kernel, stride, pad, dilate):
    """The im2col view of N-C-first ``xq``: ``[N, *out, C, *kernel]``,
    a strided view of the zero-padded input (no copy yet)."""
    nd = xq.dim() - 2
    if any(p > 0 for p in pad):
        pads = []
        for p in reversed(pad):
            pads += [p, p]
        xq = F.pad(xq, pads)
    xq = xq.contiguous()
    spatial = xq.shape[2:]
    out = tuple((spatial[i] - dilate[i] * (kernel[i] - 1) - 1)
                // stride[i] + 1 for i in range(nd))
    if any(o < 1 for o in out):
        raise KernelUnsupportedError(
            "int8_conv: kernel %s does not fit the padded input %s"
            % (kernel, tuple(spatial)))
    st = xq.stride()
    size = (xq.shape[0],) + out + (xq.shape[1],) + tuple(kernel)
    strides = ((st[0],) + tuple(st[2 + i] * stride[i] for i in range(nd))
               + (st[1],) + tuple(st[2 + i] * dilate[i] for i in range(nd)))
    return xq.as_strided(size, strides), out


def _conv(xq, wq, stride, pad, dilate, groups, mm):
    nd = xq.dim() - 2
    if wq.dim() != nd + 2 or nd not in (1, 2, 3):
        raise KernelUnsupportedError(
            "int8_conv takes N-C-first data and O-I-first weights of 1-3 "
            "spatial dims, got %s and %s"
            % (tuple(xq.shape), tuple(wq.shape)))
    n, c = xq.shape[:2]
    o, cg = wq.shape[:2]
    if groups < 1 or c != cg * groups or o % groups:
        raise KernelUnsupportedError(
            "int8_conv: %d input channels, weight %s and num_group=%d "
            "disagree" % (c, tuple(wq.shape), groups))
    kernel = tuple(wq.shape[2:])
    view, out = _patches(xq, kernel, _tup(stride, nd, 1),
                         _tup(pad, nd, 0), _tup(dilate, nd, 1))
    rows = n
    for s in out:
        rows *= s
    og = o // groups
    accs = []
    for g in range(groups):
        p = view[(slice(None),) * (nd + 1) + (slice(g * cg, (g + 1) * cg),)]
        accs.append(mm(p.reshape(rows, -1),
                       wq[g * og:(g + 1) * og].reshape(og, -1)))
    acc = accs[0] if groups == 1 else torch.cat(accs, dim=1)
    # [N, *out, O] -> N-C-first (a view: the channel is the fastest axis)
    return acc.reshape((n,) + out + (o,)).movedim(-1, 1)


def int8_conv_plain(xq, wq, stride=1, pad=0, dilate=1, groups=1):
    """The plain version: the same patches, int32 products on the CPU."""
    return _conv(xq, wq, stride, pad, dilate, groups, int8_matmul_plain)


def int8_conv(xq, wq, stride=1, pad=0, dilate=1, groups=1):
    """N-C-first int8 convolution with exact int32 accumulation:
    ``xq [N, C, *spatial]``, ``wq [O, C / groups, *kernel]`` -> int32
    ``[N, O, *out]`` (channel-fastest strides)."""
    _check_int8("int8_conv", xq, wq)
    if xq.device.type == "cuda":
        return _conv(xq, wq, stride, pad, dilate, groups, _mm_cuda)
    if xq.device.type != "cpu":
        raise KernelUnsupportedError(
            "int8_conv: no route on %s" % (xq.device,))
    return int8_conv_plain(xq, wq, stride, pad, dilate, groups)
