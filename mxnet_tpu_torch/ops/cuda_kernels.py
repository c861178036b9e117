"""Hand-written CUDA kernels and their plain PyTorch versions
(counterpart of ``mxnet_tpu.ops.pallas_kernels``).

Kernels, sources under ``mxnet_tpu_torch/csrc``:

* ``flash_attention`` — flash-attention forward (``csrc/flash_fwd.cu``
  for bf16, ``csrc/flash_f32.cu`` for f32), the port of
  ``_flash_fwd_kernel``; returns ``(o, lse)``.
* ``flash_attention_bwd`` — its backward, two kernels in
  ``csrc/flash_bwd.cu`` (bf16) or ``csrc/flash_f32.cu`` (f32): dq over q
  tiles (port of ``_flash_bwd_dq_kernel``) and dk/dv over kv tiles (port
  of ``_flash_bwd_dkv_kernel``).
* ``paged_attention_pool`` — single-query paged decode attention read
  through the page table straight from the page pool, split over the
  keys (``csrc/paged_attn.cu``), the port of ``_paged_attn_kernel``: a
  bf16 query over bf16 or int8 K/V, an f32 query over f32 or int8 K/V
  (:data:`PAGED_HEAD_DIMS`); ``paged_attention`` is the same kernel over
  a page-gathered context under a mask (the reference's entry).
* ``fused_adam_step_multi`` — the Adam update with its bf16 or f16 cast
  (or none, for an f32 cast) over a whole list of tensors in one launch
  (``csrc/adam_step.cu``), the port of ``_adam_epilogue_kernel``;
  ``fused_adam_step`` is its one-tensor form.
* ``fused_sgd_step_multi`` — the SGD(+momentum) update with its cast over
  a whole list of tensors in one launch (``csrc/sgd_step.cu``), the port
  of ``_sgd_epilogue_kernel`` / ``_sgd_nomom_epilogue_kernel``;
  ``fused_sgd_step`` is its one-tensor form.
* ``row_softmax`` / ``row_softmax_bwd`` — softmax over the last axis of
  ``[n, d]`` with its saved row max and sum, and its backward from them
  (``csrc/row_softmax.cu``), the port of ``_row_softmax_kernel`` /
  ``_row_softmax_bwd_kernel``.
* ``scale_bias_relu`` — ``relu(x * scale + bias)`` with per-column scale
  and bias (``csrc/scale_bias_relu.cu``), the port of
  ``_scale_bias_relu_kernel``.
* ``box_nms_sorted`` — the greedy NMS scan over score-sorted boxes
  (``csrc/box_nms.cu``: a suppression bit mask, then a walk of it).  It
  replaces no Pallas kernel: the reference's NMS (``_nms_one``) is plain
  XLA ops over a dense N x N matrix, which does not fit the card at
  SSD-512's 65,280 anchors.

Each wrapper takes its kernel only for CUDA tensors: a CPU tensor runs
the plain version beside it (``*_plain``), which repeats the Pallas
body's arithmetic in PyTorch ops and is what the tests hold against the
JAX package.  Any other tensor goes to the kernel: the wrapper launches
it, or raises :class:`~mxnet_tpu_torch.base.KernelUnsupportedError`
naming what the kernel cannot take (``*_unsupported_reason``, the one
feasibility check per kernel).  There is no fallback inside a wrapper.
Routing policy (when to call the wrapper at all) lives in
``mxnet_tpu_torch.kernels``.

Launch counts: ``LAUNCHES[name]`` goes up by one at each kernel launch
and nowhere else (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``,
their f32 forms ``flash_fwd_f32``, ``flash_bwd_dq_f32``,
``flash_bwd_dkv_f32``; the paged kernel by entry, query and pages:
``paged_decode_pool_bf16``, ``paged_decode_pool_int8`` (bf16 query),
``paged_decode_pool_f32``, ``paged_decode_pool_int8_f32q`` (f32 query)
and their gathered-entry twins ``paged_decode_bf16``,
``paged_decode_int8``, ``paged_decode_f32``, ``paged_decode_int8_f32q``;
``adam_step``,
``sgd_step``, ``row_softmax_fwd``, ``row_softmax_bwd``,
``scale_bias_relu``, ``box_nms`` (one a mask and walk pair)), and
``rtc`` at each launch of a user kernel that ``mx.rtc`` compiled
(``rtc.LAUNCHES`` counts those per kernel name).
"""
from __future__ import annotations

import ctypes
import math
import threading

import numpy as _np
import torch

from ..base import KernelUnsupportedError
from . import _build

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "paged_attention", "paged_attention_plain",
           "paged_attention_pool", "paged_attention_pool_plain",
           "paged_pool_unsupported_reason", "gather_pages", "paged_splits",
           "fused_adam_step", "fused_adam_step_plain",
           "fused_adam_step_multi", "fused_adam_step_multi_plain",
           "flash_unsupported_reason",
           "flash_bwd_unsupported_reason", "paged_unsupported_reason",
           "adam_unsupported_reason", "fused_sgd_step", "fused_sgd_step_plain",
           "fused_sgd_step_multi", "fused_sgd_step_multi_plain",
           "sgd_unsupported_reason", "LaunchTable", "TableLayout",
           "SGD_LAYOUT", "ADAM_LAYOUT", "sqrt_rn", "div_rn",
           "row_softmax", "row_softmax_plain", "row_softmax_bwd",
           "row_softmax_bwd_plain", "row_softmax_unsupported_reason",
           "row_softmax_bwd_unsupported_reason", "scale_bias_relu",
           "scale_bias_relu_plain", "scale_bias_relu_unsupported_reason",
           "box_nms_sorted", "box_nms_sorted_plain",
           "box_nms_unsupported_reason", "LAUNCHES", "reset_launches",
           "FLASH_HEAD_DIMS", "PAGED_HEAD_DIMS", "NEG"]

#: masked-score floor of the plain versions (parallel.ring_attention)
NEG = -1e30
#: the head dims the flash kernels are instantiated for, per input dtype
#: (bf16: flash_fwd.cu and flash_bwd.cu; f32: flash_f32.cu, a template
#: parameter); another needs its own instantiation, checked on the card
FLASH_HEAD_DIMS = {torch.bfloat16: (64,), torch.float32: (16, 32, 64)}
#: the head dims the paged decode kernel (paged_attn.cu) is instantiated
#: for, per query dtype (the pages are the query's dtype, or int8)
PAGED_HEAD_DIMS = {torch.bfloat16: (64,), torch.float32: (16, 64)}

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_f32": 0, "flash_bwd_dq_f32": 0,
            "flash_bwd_dkv_f32": 0,
            "paged_decode_bf16": 0, "paged_decode_int8": 0,
            "paged_decode_f32": 0, "paged_decode_int8_f32q": 0,
            "paged_decode_pool_bf16": 0, "paged_decode_pool_int8": 0,
            "paged_decode_pool_f32": 0, "paged_decode_pool_int8_f32q": 0,
            "adam_step": 0,
            "sgd_step": 0, "row_softmax_fwd": 0, "row_softmax_bwd": 0,
            "scale_bias_relu": 0, "box_nms": 0, "rtc": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_fwd": {
        "mx_flash_fwd_bf16": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                               _P], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_bwd": {
        "mx_flash_bwd_dq_bf16": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _F, _P], _I),
        "mx_flash_bwd_dkv_bf16": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _F, _P], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_f32": {
        "mx_flash_fwd_f32": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                              _P], _I),
        "mx_flash_bwd_dq_f32": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _F, _P], _I),
        "mx_flash_bwd_dkv_f32": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _F, _P], _I),
        "mx_flash_f32_blocks_per_sm": ([_I, _I], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "paged_attn": {
        "mx_paged_decode": ([_P] * 11 + [_I] * 8 + [ctypes.c_longlong] * 6
                            + [_I, _I, _F, _P], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "adam_step": {
        "mx_adam_step_multi": ([_P, _I, _I, ctypes.c_longlong, _F, _F, _F, _F,
                                _F, _P], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "sgd_step": {
        "mx_sgd_step_multi": ([_P, _I, _I, ctypes.c_longlong, _F, _I, _P],
                              _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "row_softmax": {
        "mx_row_softmax_fwd": ([_P, _P, _P, _P, ctypes.c_int64,
                                ctypes.c_int64, _I, _P], _I),
        "mx_row_softmax_bwd": ([_P, _P, _P, _P, _P, ctypes.c_int64,
                                ctypes.c_int64, _I, _P], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "scale_bias_relu": {
        "mx_scale_bias_relu": ([_P, _P, _P, _P, ctypes.c_int64,
                                ctypes.c_int64, _I, _P], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "box_nms": {
        "mx_box_nms": ([_P] * 7 + [ctypes.c_longlong, _P, _I, _I, _I, _F,
                                   _I, _P], _I),
        "mx_box_nms_scratch_bytes": ([_I, _I, _I], ctypes.c_longlong),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
}
#: the dtype codes of the kernels that take f32, bf16 and f16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.int8: "int8"}


def _short(dtype):
    return _SHORT.get(dtype, str(dtype))


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d (%s)"
                           % (what, err, lib.mx_error_string(err).decode()))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_reason(*tensors):
    """Why these tensors cannot be handed to a kernel launch, or None."""
    if not all(t.is_cuda for t in tensors):
        return "not all on a CUDA device (%s)" % sorted(
            {str(t.device) for t in tensors})
    if len({t.device for t in tensors}) != 1:
        return "on different CUDA devices"
    if not all(t.is_contiguous() for t in tensors):
        return "not all contiguous"
    return None


# ------------------------------------------------------- flash attention
def flash_unsupported_reason(q, k, v, causal):
    """Why the flash kernel cannot take this call, or None.  Shapes and
    dtypes only, so it answers for ``meta`` tensors too."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return "rank != 4 (got q%d k%d v%d)" % (q.dim(), k.dim(), v.dim())
    if k.shape != v.shape:
        return "k/v shapes differ: %s vs %s" % (tuple(k.shape),
                                                tuple(v.shape))
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        return "q/kv shape mismatch: %s vs %s" % (tuple(q.shape),
                                                  tuple(k.shape))
    if causal and q.shape[2] != k.shape[2]:
        return "causal needs Sq == Skv, got %d vs %d" % (q.shape[2],
                                                         k.shape[2])
    if not (q.dtype == k.dtype == v.dtype and q.dtype in FLASH_HEAD_DIMS):
        return "kernel takes f32 or bf16, got %s" % sorted(
            {str(t.dtype) for t in (q, k, v)})
    dims = FLASH_HEAD_DIMS[q.dtype]
    if q.shape[3] not in dims:
        return "head dim %d not in %s for %s" % (
            q.shape[3], "/".join(map(str, dims)), str(q.dtype)[6:])
    if q.shape[0] * q.shape[1] > 65535:
        return "B*H %d > 65535" % (q.shape[0] * q.shape[1])
    if q.numel() == 0 or k.numel() == 0:
        return "empty: B*H, Sq and Skv must be positive"
    return None


def flash_attention_plain(q, k, v, causal=False, scale=None):
    """The Pallas body's arithmetic in PyTorch ops: f32 scores, ``-1e30``
    causal mask, f32 softmax statistics, P rounded to the input dtype
    before an f32-accumulated P.V.  Returns ``(o [B,H,Sq,D] q.dtype,
    lse [B*H, Sq] f32)``."""
    B, H, S, D = q.shape
    Skv = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(kp <= qp, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    acc = torch.matmul(e.to(v.dtype).float(), v.float())
    o = (acc / l).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B * H, S)
    return o, lse


def _flash_lib(dtype, bf16_lib):
    """``(library, entry suffix, launch-count suffix)`` of the flash
    kernels for ``dtype``: ``bf16_lib`` (``flash_fwd`` or ``flash_bwd``)
    for bf16, ``flash_f32`` (``csrc/flash_f32.cu``) for f32."""
    if dtype == torch.float32:
        return "flash_f32", "f32", "_f32"
    return bf16_lib, "bf16", ""


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash-attention forward: ``(o, lse)`` as :func:`flash_attention_plain`
    computes them.  CPU tensors run the plain version; CUDA tensors launch
    ``csrc/flash_fwd.cu`` (bf16, head dim 64) or ``csrc/flash_f32.cu``
    (f32, head dim 16, 32 or 64; contiguous, at 16-byte aligned addresses)
    or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    reason = (flash_unsupported_reason(q, k, v, causal)
              or _launch_reason(q, k, v))
    if reason is None and any(t.data_ptr() % 16 for t in (q, k, v)):
        # the bf16 kernel reads through TMA tensor maps, the f32 one in
        # 16-byte loads
        reason = "a data pointer is not 16-byte aligned"
    if reason is not None:
        raise KernelUnsupportedError(
            "flash kernel cannot take this call: " + reason)
    B, H, S, D = q.shape
    Skv = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    name, form, count = _flash_lib(q.dtype, "flash_fwd")
    lib = _build.load(name, _SIGNATURES[name])
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    err = getattr(lib, "mx_flash_fwd_" + form)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B * H, S, Skv, D, int(bool(causal)), scale,
        _stream(q))
    _check(lib, err, "flash_fwd" + count)
    LAUNCHES["flash_fwd" + count] += 1
    return o, lse


# ---------------------------------------------- flash attention backward
def flash_bwd_unsupported_reason(q, k, v, o, lse, do, causal):
    """Why the flash backward kernels cannot take this call, or None: the
    forward's conditions, plus ``o``/``do`` shaped and typed as ``q`` and
    an f32 ``lse [B*H, Sq]``.  Shapes and dtypes only."""
    reason = flash_unsupported_reason(q, k, v, causal)
    if reason is not None:
        return reason
    if o.shape != q.shape or do.shape != q.shape:
        return "o/dO shapes %s/%s != q %s" % (tuple(o.shape), tuple(do.shape),
                                              tuple(q.shape))
    if o.dtype != q.dtype or do.dtype != q.dtype:
        return "o/dO must be %s, got %s/%s" % (q.dtype, o.dtype, do.dtype)
    want = (q.shape[0] * q.shape[1], q.shape[2])
    if tuple(lse.shape) != want or lse.dtype != torch.float32:
        return "lse must be f32 %s, got %s %s" % (want, lse.dtype,
                                                  tuple(lse.shape))
    return None


def flash_delta(o, do):
    """``delta = rowsum(dO * O)`` in f32, ``[B*H, Sq]`` — computed outside
    the kernels with plain ops, as ``_flash_backward`` does."""
    B, H, S, _ = o.shape
    return (do.float() * o.float()).sum(dim=-1).reshape(B * H, S)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None,
                              delta=None):
    """The two Pallas backward bodies' arithmetic in PyTorch ops, all f32:
    ``p = exp(s*scale - lse)`` under the ``-1e30`` causal mask,
    ``dv = p^T dO``, ``ds = p * (dO v^T - delta) * scale``, ``dq = ds k``,
    ``dk = ds^T q``.  Returns ``(dq, dk, dv)`` in the input dtypes."""
    B, H, S, D = q.shape
    Skv = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if delta is None:
        delta = flash_delta(o, do)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(kp <= qp, s, torch.full_like(s, NEG))
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.reshape(B, H, S, 1)) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None,
                        delta=None):
    """Flash-attention backward: ``(dq, dk, dv)`` as
    :func:`flash_attention_bwd_plain` computes them from the forward's
    ``o`` and ``lse``.  ``delta`` (:func:`flash_delta`) is computed here
    when not given.  CPU tensors run the plain version; CUDA tensors
    launch the two kernels of ``csrc/flash_bwd.cu`` (bf16) or
    ``csrc/flash_f32.cu`` (f32): dq, then dk/dv; contiguous, at 16-byte
    aligned addresses, at a head dim of :data:`FLASH_HEAD_DIMS`; or
    raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale, delta=delta)
    reason = flash_bwd_unsupported_reason(q, k, v, o, lse, do, causal)
    if reason is None and delta is not None and (
            delta.shape != lse.shape or delta.dtype != torch.float32):
        reason = "delta must be f32 %s" % (tuple(lse.shape),)
    if reason is None:
        if delta is None:
            delta = flash_delta(o, do)
        reason = _launch_reason(q, k, v, o, lse, do, delta)
    if reason is None and any(t.data_ptr() % 16
                              for t in (q, k, v, do, lse, delta)):
        # the bf16 kernels read through TMA tensor maps, the f32 ones in
        # 16-byte loads
        reason = "a data pointer is not 16-byte aligned"
    if reason is not None:
        raise KernelUnsupportedError(
            "flash backward kernels cannot take this call: " + reason)
    args = (q, k, v, do, lse, delta, causal, scale)
    return _launch_bwd_dq(*args), *_launch_bwd_dkv(*args)


def _bwd_args(q, k, v, do, lse, delta, causal, scale):
    B, H, S, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (B * H, S, k.shape[2], D, int(bool(causal)), scale, _stream(q))
    name, form, count = _flash_lib(q.dtype, "flash_bwd")
    return _build.load(name, _SIGNATURES[name]), form, count, ptrs, dims


def _launch_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """Launch K2dq alone on checked inputs (:func:`flash_attention_bwd`
    checks them); returns dq."""
    lib, form, count, ptrs, dims = _bwd_args(q, k, v, do, lse, delta,
                                             causal, scale)
    dq = torch.empty_like(q)
    _check(lib, getattr(lib, "mx_flash_bwd_dq_" + form)(
        *ptrs, dq.data_ptr(), *dims), "flash_bwd_dq" + count)
    LAUNCHES["flash_bwd_dq" + count] += 1
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """Launch K2dkv alone on checked inputs; returns ``(dk, dv)``."""
    lib, form, count, ptrs, dims = _bwd_args(q, k, v, do, lse, delta,
                                             causal, scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _check(lib, getattr(lib, "mx_flash_bwd_dkv_" + form)(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *dims), "flash_bwd_dkv" + count)
    LAUNCHES["flash_bwd_dkv" + count] += 1
    return dk, dv


# ------------------------------------------------------- paged attention
def _paged_domain_reason(q, k, v, quant):
    """The dtypes and head dims the paged kernel is built for (both
    entries' checks): a bf16 query over bf16 pages, an f32 query over f32
    pages, or either over int8 pages with f32 scales, at a head dim of
    :data:`PAGED_HEAD_DIMS` for the query's dtype."""
    if q.dtype not in PAGED_HEAD_DIMS:
        return "kernel takes a bf16 or f32 query, got %s" % _short(q.dtype)
    if quant and (k.dtype != torch.int8 or v.dtype != torch.int8):
        return "kernel takes int8 pages with f32 scales, got %s" % (
            _short(k.dtype))
    if not quant and (k.dtype != q.dtype or v.dtype != q.dtype):
        return "kernel takes %s pages (or int8 with f32 scales) for %s " \
               "queries, got %s" % (_short(q.dtype), _short(q.dtype),
                                    _short(k.dtype))
    dims = PAGED_HEAD_DIMS[q.dtype]
    if q.shape[3] not in dims:
        return "head dim %d not in %s for %s" % (
            q.shape[3], "/".join(map(str, dims)), str(q.dtype)[6:])
    return None


def _paged_launch_key(q, quant, pool):
    """The ``LAUNCHES`` name of one paged launch: the entry (pool or
    gathered), then the pages' dtype, ``_f32q`` for int8 pages under an
    f32 query."""
    name = "paged_decode_pool_" if pool else "paged_decode_"
    if q.dtype == torch.float32:
        return name + ("int8_f32q" if quant else "f32")
    return name + ("int8" if quant else "bf16")


def paged_unsupported_reason(q, k, v, valid, k_scale=None, v_scale=None):
    """Why the paged decode kernel cannot take this call, or None.  Int8
    pages come with ``k_scale``/``v_scale``.  Shapes and dtypes only, so
    it answers for ``meta`` tensors too."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return "rank != 4 (got q%d k%d v%d)" % (q.dim(), k.dim(), v.dim())
    B, H, Sq, D = q.shape
    if Sq != 1:
        return "needs one query row per sequence, got Sq=%d" % Sq
    K = k.shape[2]
    if tuple(k.shape) != (B, H, K, D) or v.shape != k.shape:
        return "k/v must be [B,H,K,D]=%s, got %s and %s" % (
            (B, H, K, D), tuple(k.shape), tuple(v.shape))
    if tuple(valid.shape) != (B, K):
        return "valid mask shape %s != (B, K)=%s" % (tuple(valid.shape),
                                                     (B, K))
    if valid.dtype != torch.bool:
        return "valid mask must be bool, got %s" % valid.dtype
    quant = k_scale is not None
    reason = _paged_domain_reason(q, k, v, quant)
    if reason is not None:
        return reason
    if quant and (v_scale is None
                  or tuple(k_scale.shape) != (B, H, K)
                  or tuple(v_scale.shape) != (B, H, K)
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        return "int8 pages need f32 k_scale/v_scale [B,H,K]"
    if B * H > 65535 or B * H == 0 or K == 0:
        return "B*H %d not in 1..65535, or K == 0" % (B * H)
    if K >= 2 ** 31:
        return "K %d >= 2^31" % K
    return None


def paged_attention_plain(q, k, v, valid, scale=None, k_scale=None,
                          v_scale=None):
    """The reference's paged lowering in PyTorch ops
    (``kernels._paged_attention_xla``): int8 pages dequantise up front,
    f32 scores, masked slots pin to ``-1e30``, P rounded to ``v.dtype``
    for the P.V product, divide in that dtype, cast to ``q.dtype``."""
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype), v)
    return (o / l.to(o.dtype)).to(q.dtype)


def paged_attention(q, k, v, valid, scale=None, k_scale=None,
                    v_scale=None):
    """Single-query paged decode attention.  ``q [B,H,1,D]`` bf16 or
    f32; ``k``/``v`` ``[B,H,K,D]`` gathered through the page table, in
    q's dtype or int8 with ``k_scale``/``v_scale [B,H,K]`` f32;
    ``valid [B,K]`` bool; the output is in q's dtype.  CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/paged_attn.cu`` (the kernel of :func:`paged_attention_pool`,
    reading the gathered tensor as one page per sequence, under the mask)
    or raise."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k, v, valid, scale=scale,
                                     k_scale=k_scale, v_scale=v_scale)
    quant = k_scale is not None
    tensors = [q, k, v, valid] + ([k_scale, v_scale] if quant else [])
    reason = (paged_unsupported_reason(q, k, v, valid, k_scale, v_scale)
              or _launch_reason(*tensors) or _paged_align_reason(q, k, v))
    if reason is not None:
        raise KernelUnsupportedError(
            "paged kernel cannot take this call: " + reason)
    B, H, _, D = q.shape
    K = k.shape[2]
    # [B, H, K, D] as a pool of B pages of K slots, no table
    o = _launch_paged(q, k, v, k_scale, v_scale, None, None, valid,
                      width=1, psz=K, pool=B,
                      strides=(H * K * D, D, K * D, H * K, 1, K),
                      scale=scale)
    LAUNCHES[_paged_launch_key(q, quant, pool=False)] += 1
    return o


def _paged_align_reason(q, k, v):
    # lanes load 16 bytes of f32 or bf16, 8 of int8
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        return "a data pointer is not 16-byte aligned"
    return None


#: blocks the paged kernel aims for: four of 128 threads on each of the
#: H100's 132 SMs
PAGED_TARGET_BLOCKS = 4 * 132
#: keys a block walks in one step (16 groups x 4 keys): the least split
PAGED_SPLIT_KEYS = 64


def paged_splits(bh, kctx):
    """``(keys_per_split, splits)`` of one paged launch over ``bh``
    (batch x heads) rows of ``kctx`` keys: enough splits that
    ``bh * splits`` blocks reach PAGED_TARGET_BLOCKS where the context
    allows, each split a multiple of PAGED_SPLIT_KEYS keys."""
    most = -(-kctx // PAGED_SPLIT_KEYS)
    want = max(1, min(most, -(-PAGED_TARGET_BLOCKS // bh)))
    per = -(-kctx // want)
    per = -(-per // PAGED_SPLIT_KEYS) * PAGED_SPLIT_KEYS
    return per, -(-kctx // per)


_PAGED_LOCK = threading.Lock()
# guarded-by: _PAGED_LOCK — (device, stream handle) -> int32 zeros
_PAGED_COUNTERS = {}


def _paged_counters(device, stream, n):
    """The (b, h) counts of the last-block merge for launches on
    ``stream`` (a raw CUDA stream handle) of ``device``, at least ``n`` of
    them.  The kernel leaves them at zero.  Each stream has its own, so
    the launches that share a buffer always run in stream order."""
    with _PAGED_LOCK:
        c = _PAGED_COUNTERS.get((device, stream))
        if c is None or c.numel() < n:
            c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
            _PAGED_COUNTERS[(device, stream)] = c
        return c


def _drop_paged_counters(device, stream):
    """Forget the counts of ``stream``: a launch that failed may have
    left some that are not zero."""
    with _PAGED_LOCK:
        _PAGED_COUNTERS.pop((device, stream), None)


def _launch_paged(q, k, v, k_scale, v_scale, table, lengths, valid, width,
                  psz, pool, strides, scale=None):
    """One launch of the paged kernel on checked inputs; ``strides`` are
    ``(page, slot, head)`` of k/v and of the scales, in elements.  The
    output is in q's dtype; with several splits each (b, h) writes
    ``splits`` partials of ``D + 2`` floats to a workspace."""
    B, H, _, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    per, splits = paged_splits(B * H, width * psz)
    stream = _stream(q)
    part = counters = None
    if splits > 1:
        part = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                           device=q.device)
        counters = _paged_counters(q.device, stream, B * H)
    quant = k_scale is not None
    lib = _build.load("paged_attn", _SIGNATURES["paged_attn"])
    o = torch.empty_like(q)

    def ptr(t):
        return t.data_ptr() if t is not None else None
    err = lib.mx_paged_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale),
        ptr(table), ptr(lengths), ptr(valid), o.data_ptr(), ptr(part),
        ptr(counters), B, H, width, psz, pool, D, per, splits, *strides,
        int(quant), _DTYPE_CODE[q.dtype], scale, stream)
    if err != 0 and counters is not None:
        _drop_paged_counters(q.device, stream)
    _check(lib, err, "paged_decode")
    return o


def paged_pool_unsupported_reason(q, k_pool, v_pool, page_table, lengths,
                                  k_scale_pool=None, v_scale_pool=None):
    """Why the paged kernel cannot take this pool-form call, or None:
    ``q [B,H,1,D]`` bf16 (D = 64) or f32 (D = 16, 64); pools
    ``[pool, psz, H, D]`` in q's dtype, or int8 with f32 scale pools
    ``[pool, psz, H]``; ``page_table [B, W]`` and
    ``lengths [B]`` int32; B*H <= 65535 and W*psz < 2^31.  Shapes and
    dtypes only, so it answers for ``meta`` tensors too."""
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4:
        return "rank != 4 (got q%d k%d v%d)" % (q.dim(), k_pool.dim(),
                                                v_pool.dim())
    B, H, Sq, D = q.shape
    if Sq != 1:
        return "needs one query row per sequence, got Sq=%d" % Sq
    P, psz = k_pool.shape[:2]
    if tuple(k_pool.shape) != (P, psz, H, D) or v_pool.shape != k_pool.shape:
        return "pools must be [pool, psz, H, D]=%s, got %s and %s" % (
            (P, psz, H, D), tuple(k_pool.shape), tuple(v_pool.shape))
    if page_table.dim() != 2 or page_table.shape[0] != B:
        return "page table must be [B, W] with B=%d, got %s" % (
            B, tuple(page_table.shape))
    if tuple(lengths.shape) != (B,):
        return "lengths must be [B]=[%d], got %s" % (B, tuple(lengths.shape))
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        return "page table and lengths must be int32, got %s/%s" % (
            page_table.dtype, lengths.dtype)
    quant = k_scale_pool is not None
    reason = _paged_domain_reason(q, k_pool, v_pool, quant)
    if reason is not None:
        return reason
    if quant and (v_scale_pool is None
                  or tuple(k_scale_pool.shape) != (P, psz, H)
                  or tuple(v_scale_pool.shape) != (P, psz, H)
                  or k_scale_pool.dtype != torch.float32
                  or v_scale_pool.dtype != torch.float32):
        return "int8 pages need f32 scale pools [pool, psz, H]"
    if B * H > 65535 or B * H == 0:
        return "B*H %d not in 1..65535" % (B * H)
    if P == 0 or psz == 0 or page_table.shape[1] == 0:
        return "empty pool or page table"
    if page_table.shape[1] * psz >= 2 ** 31:
        return "W*psz %d >= 2^31" % (page_table.shape[1] * psz)
    return None


def gather_pages(pool, page_table):
    """``pool [P, psz, ...]`` gathered through ``page_table [B, W]`` (entries
    clamped into the pool) as ``[B, ..., W*psz, ...]``: K/V
    ``[P, psz, H, D]`` -> ``[B, H, W*psz, D]``, scales ``[P, psz, H]`` ->
    ``[B, H, W*psz]``; contiguous."""
    B, W = page_table.shape
    P, psz = pool.shape[:2]
    g = pool[page_table.long().clamp(0, P - 1)]
    g = g.reshape(B, W * psz, *pool.shape[2:])
    return g.transpose(1, 2).contiguous()


def paged_attention_pool_plain(q, k_pool, v_pool, page_table, lengths,
                               scale=None, k_scale_pool=None,
                               v_scale_pool=None):
    """The pool form's plain version: the pages gathered through the table
    (:func:`gather_pages`, sentinel entries clamped), the mask
    ``position < lengths[b]``, then :func:`paged_attention_plain`."""
    B, W = page_table.shape
    psz = k_pool.shape[1]
    valid = (torch.arange(W * psz, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])
    scales = {}
    if k_scale_pool is not None:
        scales = {"k_scale": gather_pages(k_scale_pool, page_table),
                  "v_scale": gather_pages(v_scale_pool, page_table)}
    return paged_attention_plain(q, gather_pages(k_pool, page_table),
                                 gather_pages(v_pool, page_table), valid,
                                 scale=scale, **scales)


def paged_attention_pool(q, k_pool, v_pool, page_table, lengths, scale=None,
                         k_scale_pool=None, v_scale_pool=None):
    """Single-query paged decode attention read straight from the page
    pool: ``q [B,H,1,D]`` bf16 or f32; ``k_pool``/``v_pool
    [pool, psz, H, D]`` (the model's own per-layer pools, in q's dtype, or
    int8 with ``k_scale_pool`` / ``v_scale_pool [pool, psz, H]`` f32);
    ``page_table [B, W]`` int32; ``lengths [B]`` int32, the valid prefix
    of each sequence (keys ``0 .. lengths[b] - 1``); the output is in q's
    dtype.  CPU tensors run
    :func:`paged_attention_pool_plain`; CUDA tensors launch
    ``csrc/paged_attn.cu`` (one launch, no gather) or raise."""
    if q.device.type == "cpu":
        return paged_attention_pool_plain(
            q, k_pool, v_pool, page_table, lengths, scale=scale,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    quant = k_scale_pool is not None
    tensors = [q, k_pool, v_pool, page_table, lengths] + (
        [k_scale_pool, v_scale_pool] if quant else [])
    reason = (paged_pool_unsupported_reason(q, k_pool, v_pool, page_table,
                                            lengths, k_scale_pool,
                                            v_scale_pool)
              or _launch_reason(*tensors)
              or _paged_align_reason(q, k_pool, v_pool))
    if reason is not None:
        raise KernelUnsupportedError(
            "paged kernel cannot take this call: " + reason)
    P, psz, H, D = k_pool.shape
    o = _launch_paged(q, k_pool, v_pool, k_scale_pool, v_scale_pool,
                      page_table, lengths, None,
                      width=page_table.shape[1], psz=psz, pool=P,
                      strides=(psz * H * D, H * D, D, psz * H, H, 1),
                      scale=scale)
    LAUNCHES[_paged_launch_key(q, quant, pool=True)] += 1
    return o


# ---------------------------------------------------------------- adam
def adam_unsupported_reason(weight, grad, m, v, out_dtype):
    """Why the Adam kernel cannot take this call, or None: f32 master,
    m and v of one shape, a grad of that shape in f32, bf16 or f16, and an
    f32, bf16 or f16 cast.  Shapes and dtypes only."""
    shape = weight.shape
    if any(t.shape != shape for t in (grad, m, v)):
        return "shapes differ: w%s g%s m%s v%s" % tuple(
            tuple(t.shape) for t in (weight, grad, m, v))
    if not (weight.dtype == m.dtype == v.dtype == torch.float32):
        return "master/m/v must be f32, got %s/%s/%s" % (
            weight.dtype, m.dtype, v.dtype)
    if grad.dtype not in _DTYPE_CODE:
        return "grad must be f32, bf16 or f16, got %s" % grad.dtype
    if out_dtype not in _DTYPE_CODE:
        return "the cast must be f32, bf16 or f16, got %s" % out_dtype
    if weight.numel() == 0:
        return "empty tensor"
    return None


def _f32(x):
    """A Python float as the f32 value the kernel receives."""
    return torch.tensor(float(x), dtype=torch.float32)


def _fma(a, b, c):
    """``fma(a, b, c)`` on f32 operands, rounded once, as ``__fmaf_rn``:
    the f64 product of two f32 values is exact; the f64 sum is made
    round-to-odd (TwoSum residual, one step to the odd neighbour) so that
    the final rounding to f32 is the single rounding of the exact sum."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(err)
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def sqrt_rn(x):
    """f32 square root rounded once, as ``__fsqrt_rn`` and IEEE 754: taken
    in f64 and rounded to f32 (f64 carries more than twice f32's bits, so
    the second rounding is exact).  PyTorch's own f32 ``sqrt`` on the CPU
    is not correctly rounded."""
    return torch.sqrt(x.double()).float()


def div_rn(a, b):
    """f32 quotient rounded once, as ``__fdiv_rn`` (through f64, as
    :func:`sqrt_rn`)."""
    return (a.double() / b.double()).float()


def fused_adam_step_plain(weight, grad, m, v, lr_t, wd, beta1, beta2, eps,
                          out_dtype=torch.bfloat16):
    """The Adam epilogue's arithmetic in PyTorch ops, rounding exactly as
    ``csrc/adam_step.cu`` does (and as the jitted reference, whose
    compiler contracts the three multiply-adds)::

        g' = fma(wd, w, g)
        m' = fma(b1, m, (1-b1)*g')
        v' = fma(b2, v, ((1-b2)*g')*g')
        w' = w - (lr_t*m') / (sqrt(v') + eps)

    with the square root and the quotient correctly rounded
    (:func:`sqrt_rn`, :func:`div_rn`).  Every scalar is the f32 value of
    the Python float.  Returns
    ``(w'.to(out_dtype), w', (m', v'))``; with an f32 ``out_dtype`` the
    first is ``w'`` itself."""
    dev = weight.device
    lr_t, wd, b1, b2, eps = (_f32(x).to(dev) for x in (lr_t, wd, beta1,
                                                        beta2, eps))
    omb1 = _f32(1.0 - beta1).to(dev)
    omb2 = _f32(1.0 - beta2).to(dev)
    g = _fma(wd, weight, grad.float())
    nm = _fma(b1, m, omb1 * g)
    nv = _fma(b2, v, (omb2 * g) * g)
    nw = weight - div_rn(lr_t * nm, sqrt_rn(nv) + eps)
    return nw.to(out_dtype), nw, (nm, nv)


def fused_adam_step_multi_plain(weights, grads, ms, vs, lr_ts, wds, beta1,
                                beta2, eps, outs=None):
    """:func:`fused_adam_step_multi` with the plain version, tensor by
    tensor, in place."""
    outs = outs if outs is not None else [None] * len(weights)
    for w, g, m, v, lr_t, wd, o in zip(weights, grads, ms, vs, lr_ts, wds,
                                       outs):
        lp, nw, (nm, nv) = fused_adam_step_plain(
            w, g, m, v, lr_t, wd, beta1, beta2, eps,
            out_dtype=o.dtype if o is not None else torch.float32)
        w.copy_(nw)
        m.copy_(nm)
        v.copy_(nv)
        if o is not None:
            o.copy_(lp)


def fused_adam_step_multi(weights, grads, ms, vs, lr_ts, wds, beta1, beta2,
                          eps, outs=None, table=None):
    """One Adam update over a list of tensors, in place: ``weights`` (f32
    masters), ``ms`` and ``vs`` (f32 moments) receive the new values, and
    ``outs`` (optional, per tensor ``None`` or a bf16 or f16 tensor) the
    cast of the new master; ``None`` is an f32 cast, which is the master
    itself.  A grad may be f32, bf16 or f16.  ``lr_ts`` (the
    bias-corrected learning rates) and ``wds`` are per tensor.  CPU
    tensors run the plain version tensor by tensor; CUDA tensors launch
    ``csrc/adam_step.cu`` once for the whole list, or raise naming the
    first tensor the kernel cannot take.  ``table`` (a
    :class:`LaunchTable`) keeps the device-side table across calls."""
    n = len(weights)
    outs = list(outs) if outs is not None else [None] * n
    if not (len(grads) == len(ms) == len(vs) == len(lr_ts) == len(wds)
            == len(outs) == n) or n == 0:
        raise ValueError("fused_adam_step_multi needs one grad, m, v, lr_t, "
                         "wd and out per weight (got %d weights)" % n)
    if all(w.device.type == "cpu" for w in weights):
        return fused_adam_step_multi_plain(weights, grads, ms, vs, lr_ts,
                                           wds, beta1, beta2, eps, outs)
    # what the kernel takes first (shapes and dtypes), then where the
    # tensors lie
    for check in (_adam_entry_reason, _adam_launch_reason):
        for i, args in enumerate(zip(weights, grads, ms, vs, outs)):
            reason = check(weights[0], *args)
            if reason is not None:
                raise KernelUnsupportedError(
                    "adam kernel cannot take tensor %d of %d: %s"
                    % (i, n, reason))
    table = table if table is not None else LaunchTable()
    dev, blocks = table.fill(ADAM_LAYOUT, (weights, ms, vs, outs), grads,
                             lr_ts, wds)
    _launch_adam(dev, n, blocks, beta1, beta2, eps, weights[0])


def _adam_entry_reason(first, w, g, m, v, o):
    """Why K3 cannot take this entry of a list, or None (shapes and
    dtypes: :func:`adam_unsupported_reason`, and a cast that is a bf16 or
    f16 tensor of the master's shape, or None)."""
    reason = adam_unsupported_reason(
        w, g, m, v, o.dtype if o is not None else torch.float32)
    if reason is None and o is not None and (
            o.shape != w.shape or o.dtype == torch.float32):
        reason = ("a cast must be bf16 or f16 of %s (an f32 cast is the "
                  "master itself: pass None), got %s %s"
                  % (tuple(w.shape), o.dtype, tuple(o.shape)))
    return reason


def _adam_launch_reason(first, w, g, m, v, o):
    """Why this entry's tensors cannot go to the launch of the list, whose
    first master is ``first``, or None."""
    return _launch_reason(first, w, g, m, v, *([o] if o is not None else []))


def _launch_adam(table, n, blocks, beta1, beta2, eps, like):
    """Launch K3 alone over a filled device table (:class:`LaunchTable`
    fills it after :func:`fused_adam_step_multi` has checked every
    tensor), on the stream of ``like``'s device."""
    lib = _build.load("adam_step", _SIGNATURES["adam_step"])
    err = lib.mx_adam_step_multi(
        table.data_ptr(), n, blocks, ADAM_LAYOUT.chunk, float(beta1),
        float(beta2), 1.0 - float(beta1), 1.0 - float(beta2), float(eps),
        _stream(like))
    _check(lib, err, "adam_step")
    LAUNCHES["adam_step"] += 1


def fused_adam_step(weight, grad, m, v, lr_t, wd, beta1, beta2, eps,
                    out_dtype=torch.bfloat16, out=None, table=None):
    """Single-tensor Adam update with the cast epilogue: returns
    ``(lp, new_w, (new_m, new_v))`` like the reference's
    ``fused_adam_step``; a one-entry :func:`fused_adam_step_multi`.
    ``weight`` is the f32 master; ``grad`` f32, bf16 or f16 (widened in
    registers, exactly); the cast is bf16, f16 (rounded once) or f32.
    ``out=(lp, w, m, v)`` names the tensors to write (they may be the
    inputs themselves: the update is elementwise, so writing in place is
    safe and saves the copies); by default new ones are allocated.  With
    ``out_dtype`` f32 the cast is the new master itself: the kernel writes
    the master once and skips the cast store, ``lp`` is returned as
    ``new_w``, and ``out[0]`` must be ``out[1]``.  CPU tensors run the
    plain version; CUDA tensors launch ``csrc/adam_step.cu`` or raise.
    ``table`` as for :func:`fused_adam_step_multi`."""
    cast = out_dtype != torch.float32
    if out is None:
        nw, nm, nv = weight.clone(), m.clone(), v.clone()
        lp = torch.empty_like(weight, dtype=out_dtype) if cast else nw
    else:
        lp, nw, nm, nv = out
        dtypes = (out_dtype, torch.float32, torch.float32, torch.float32)
        reason = None
        if any(o.shape != weight.shape or o.dtype != dt
               for o, dt in zip(out, dtypes)):
            reason = "out tensors must be (%s, f32, f32, f32) of %s" % (
                out_dtype, tuple(weight.shape))
        elif not cast and lp is not nw:
            reason = "an f32 cast is the master itself: out[0] must be out[1]"
        if reason is not None:
            raise KernelUnsupportedError(
                "adam kernel cannot take this call: " + reason)
        for dst, src in ((nw, weight), (nm, m), (nv, v)):
            if dst is not src:
                dst.copy_(src)
    fused_adam_step_multi([nw], [grad], [nm], [nv], [lr_t], [wd], beta1,
                          beta2, eps, outs=[lp if cast else None],
                          table=table)
    return lp, nw, (nm, nv)


# ------------------------------------------------ multi-tensor launches
class TableLayout:
    """What one multi-tensor kernel's launch table holds: its numpy
    ``record`` (the layout of the kernel's C ``Entry``), the elements a
    block takes (``chunk``, a multiple of 4) and the record's pointer
    ``columns`` for the tensors the kernel updates in place, masters
    first and the cast (``out``) last."""

    def __init__(self, name, record, chunk, columns):
        assert record.itemsize == 64 and chunk % 4 == 0
        assert columns[0] == "w" and columns[-1] == "out"
        self.name, self.record, self.chunk = name, record, chunk
        self.columns = columns


# The flag bits of a table entry, the same in K1's and K3's: the grad's
# dtype, the cast's (K3 takes no separate f32 cast), and whether every
# pointer of the tensor is aligned for a 4-lane access (16 bytes of f32,
# 8 of a 2-byte type).
_GRAD_FLAG = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 16}
_OUT_FLAG = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 32}
_VEC = 8

#: K1's table: the layout of ``Entry`` in csrc/sgd_step.cu; a block takes
#: 256 threads x 4 lanes x 8 steps
SGD_LAYOUT = TableLayout("sgd", _np.dtype([
    ("w", "<u8"), ("g", "<u8"), ("m", "<u8"), ("out", "<u8"), ("n", "<i8"),
    ("block0", "<i4"), ("lr", "<f4"), ("wd", "<f4"), ("flags", "<i4"),
    ("pad", "<i8")]), 8192, ("w", "m", "out"))
assert [SGD_LAYOUT.record.fields[k][1] for k in
        ("n", "block0", "lr", "wd", "flags")] == [32, 40, 44, 48, 52]
#: elements per block of the SGD kernel
SGD_CHUNK = SGD_LAYOUT.chunk
#: K3's table: the layout of ``Entry`` in csrc/adam_step.cu (``lr`` holds
#: the tensor's lr_t); a block takes 256 threads x 2 groups of 4 lanes x 4
#: steps
ADAM_LAYOUT = TableLayout("adam", _np.dtype([
    ("w", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"), ("out", "<u8"),
    ("n", "<i8"), ("block0", "<i4"), ("lr", "<f4"), ("wd", "<f4"),
    ("flags", "<i4")]), 8192, ("w", "m", "v", "out"))
assert [ADAM_LAYOUT.record.fields[k][1] for k in
        ("n", "block0", "lr", "wd", "flags")] == [40, 48, 52, 56, 60]


def _vec_aligned(t):
    """Whether ``t``'s data is aligned for a 4-lane access."""
    return t.data_ptr() % (4 * t.element_size()) == 0


class LaunchTable:
    """The device-side table one multi-tensor launch of K1 or K3 walks,
    kept across steps.

    The tensors a launch updates in place (masters, states, casts) keep
    their storage, so their pointers, element counts, cast flags and each
    tensor's first block are written once: the table is rebuilt whenever
    one of those pointers or counts changes, or it serves the other
    kernel (a reallocated tensor never leaves a stale pointer in it).
    The grads are new tensors every step and lr/wd follow the schedule,
    so the grad, lr and wd columns (and the flags, which hold the grad's
    dtype and alignment) are rewritten at every launch, and the table
    goes to the card in one pinned host-to-device copy on the launch's
    stream.  ``rebuilds`` counts the rebuilds."""

    def __init__(self):
        self.rebuilds = 0
        self._key = None
        self._host = None
        self._fixed = None     # flags of the in-place tensors
        self._aligned = None   # in-place tensors all 4-lane aligned
        self._blocks = 0
        self._dev = None

    def _rebuild(self, key, layout, columns):
        weights = columns[0]
        n = len(weights)
        host = _np.zeros(n, dtype=layout.record)
        for name, col in zip(layout.columns, columns):
            host[name] = [t.data_ptr() if t is not None else 0 for t in col]
        host["n"] = [w.numel() for w in weights]
        blocks = _np.asarray([-(-w.numel() // layout.chunk)
                              for w in weights], dtype=_np.int64)
        starts = _np.concatenate([[0], _np.cumsum(blocks)])
        if int(starts[-1]) >= 2 ** 31:
            raise KernelUnsupportedError(
                "%s kernel cannot take this call: %d blocks"
                % (layout.name, int(starts[-1])))
        host["block0"] = starts[:-1]
        self._fixed = _np.asarray([_OUT_FLAG[o.dtype] if o is not None else 0
                                   for o in columns[-1]], dtype=_np.int32)
        self._aligned = _np.asarray(
            [all(_vec_aligned(t) for t in tensors if t is not None)
             for tensors in zip(*columns)], dtype=bool)
        self._key, self._host, self._blocks = key, host, int(starts[-1])
        self._dev = None
        self.rebuilds += 1

    def write(self, layout, columns, grads, lrs, wds):
        """Bring the host-side table up to date for one launch of
        ``layout``'s kernel: ``columns`` holds one list per pointer column
        of ``layout`` (``None`` for a tensor without it), ``grads``,
        ``lrs`` and ``wds`` one entry per tensor.  Returns ``(host
        records, blocks)``; reads only pointers, so it runs for tensors
        on any device."""
        key = (layout.name,
               tuple(t.data_ptr() if t is not None else 0
                     for col in columns for t in col),
               tuple(w.numel() for w in columns[0]),
               tuple(o.dtype if o is not None else None for o in columns[-1]))
        if key != self._key:
            self._rebuild(key, layout, columns)
        host = self._host
        gptr = _np.asarray([g.data_ptr() for g in grads], dtype=_np.uint64)
        galign = _np.asarray([4 * g.element_size() for g in grads],
                             dtype=_np.uint64)
        gflag = _np.asarray([_GRAD_FLAG[g.dtype] for g in grads],
                            dtype=_np.int32)
        vec = self._aligned & (gptr % galign == 0)
        host["g"] = gptr
        host["flags"] = self._fixed | gflag | _np.where(vec, _VEC, 0)
        host["lr"] = _np.asarray(lrs, dtype=_np.float32)
        host["wd"] = _np.asarray(wds, dtype=_np.float32)
        return host, self._blocks

    def fill(self, layout, columns, grads, lrs, wds):
        """:meth:`write`, then the table's one copy to the masters' card;
        returns ``(device table, blocks)``."""
        host, blocks = self.write(layout, columns, grads, lrs, wds)
        if self._dev is None:
            self._dev = torch.empty(host.nbytes, dtype=torch.uint8,
                                    device=columns[0][0].device)
        # pinned staging: the copy is queued on the stream and the caching
        # host allocator keeps the buffer until it has run
        staged = torch.from_numpy(host.view(_np.uint8)).pin_memory()
        self._dev.copy_(staged, non_blocking=True)
        return self._dev, blocks


# ----------------------------------------------------------------- sgd
def sgd_unsupported_reason(weight, grad, state, momentum, out=None):
    """Why the SGD kernel cannot take this tensor, or None: an f32 master,
    a grad of its shape in f32, bf16 or f16, an f32 momentum of its shape
    (when ``momentum`` is not 0), and an ``out`` cast (optional) of its
    shape in f32, bf16 or f16.  Shapes and dtypes only."""
    if grad.shape != weight.shape:
        return "grad shape %s != weight %s" % (tuple(grad.shape),
                                               tuple(weight.shape))
    if weight.dtype != torch.float32:
        return "master must be f32, got %s" % weight.dtype
    if grad.dtype not in _DTYPE_CODE:
        return "grad must be f32, bf16 or f16, got %s" % grad.dtype
    if momentum != 0.0 and (state is None or state.shape != weight.shape
                            or state.dtype != torch.float32):
        return "momentum must be an f32 tensor of %s" % (
            tuple(weight.shape),)
    if out is not None and (out.shape != weight.shape
                            or out.dtype not in _DTYPE_CODE):
        return "out must be f32, bf16 or f16 of %s, got %s %s" % (
            tuple(weight.shape), out.dtype, tuple(out.shape))
    if weight.numel() == 0:
        return "empty tensor"
    return None


def fused_sgd_step_plain(weight, grad, state, lr, wd, momentum,
                         out_dtype=None):
    """The SGD epilogue's arithmetic in PyTorch ops, rounding exactly as
    ``csrc/sgd_step.cu`` does (and as the reference's Pallas body, whose
    multiply-adds its compiler contracts)::

        g' = fma(wd, w, g)
        m' = fma(momentum, m, lr * g');  w' = w - m'     (momentum != 0)
        w' = fma(-lr, g', w)                              (momentum == 0)

    Every scalar is the f32 value of the Python float.  Returns
    ``(w'.to(out_dtype), w', m')``; ``m'`` is None without momentum."""
    dev = weight.device
    lr_, wd_, mom = (_f32(x).to(dev) for x in (lr, wd, momentum))
    out_dtype = out_dtype or weight.dtype
    g = _fma(wd_, weight, grad.float())
    if momentum == 0.0:
        nw = _fma(-lr_, g, weight)
        return nw.to(out_dtype), nw, None
    nm = _fma(mom, state, lr_ * g)
    nw = weight - nm
    return nw.to(out_dtype), nw, nm


def fused_sgd_step_multi_plain(weights, grads, states, lrs, wds, momentum,
                               outs=None):
    """:func:`fused_sgd_step_multi` with the plain version, tensor by
    tensor, in place."""
    outs = outs if outs is not None else [None] * len(weights)
    for w, g, s, lr, wd, o in zip(weights, grads, states, lrs, wds, outs):
        lp, nw, nm = fused_sgd_step_plain(
            w, g, s, lr, wd, momentum,
            out_dtype=o.dtype if o is not None else None)
        w.copy_(nw)
        if nm is not None:
            s.copy_(nm)
        if o is not None:
            o.copy_(lp)


def fused_sgd_step_multi(weights, grads, states, lrs, wds, momentum,
                         outs=None, table=None):
    """One SGD(+momentum) update over a list of tensors, in place:
    ``weights`` (f32 masters) and ``states`` (f32 momenta, ``None``
    entries without momentum) receive the new values, ``outs`` (optional,
    per tensor ``None`` or an f32, bf16 or f16 tensor) the cast of the new
    master.  A grad may be f32, bf16 or f16.
    ``lrs``/``wds`` are per tensor.  CPU tensors run the plain version
    tensor by tensor; CUDA tensors launch ``csrc/sgd_step.cu`` once for the
    whole list, or raise.  ``table`` (a :class:`LaunchTable`) keeps the
    device-side table across calls."""
    n = len(weights)
    states = list(states) if states is not None else [None] * n
    outs = list(outs) if outs is not None else [None] * n
    if not (len(grads) == len(states) == len(lrs) == len(wds) == len(outs)
            == n) or n == 0:
        raise ValueError("fused_sgd_step_multi needs one grad, state, lr, "
                         "wd and out per weight (got %d weights)" % n)
    if all(w.device.type == "cpu" for w in weights):
        return fused_sgd_step_multi_plain(weights, grads, states, lrs, wds,
                                          momentum, outs)
    momentum = float(momentum)
    for i, (w, g, s, o) in enumerate(zip(weights, grads, states, outs)):
        reason = sgd_unsupported_reason(w, g, s, momentum, o)
        if reason is None:
            present = [t for t in (w, g, s if momentum != 0.0 else None, o)
                       if t is not None]
            reason = _launch_reason(weights[0], *present)
        if reason is not None:
            raise KernelUnsupportedError(
                "sgd kernel cannot take tensor %d of %d: %s" % (i, n, reason))
    if momentum == 0.0:
        states = [None] * n
    table = table if table is not None else LaunchTable()
    dev, blocks = table.fill(SGD_LAYOUT, (weights, states, outs), grads,
                             lrs, wds)
    _launch_sgd(dev, n, blocks, momentum, weights[0])


def _launch_sgd(table, n, blocks, momentum, like):
    """Launch K1 alone over a filled device table (:class:`LaunchTable`
    fills it after :func:`fused_sgd_step_multi` has checked every
    tensor), on the stream of ``like``'s device."""
    lib = _build.load("sgd_step", _SIGNATURES["sgd_step"])
    err = lib.mx_sgd_step_multi(table.data_ptr(), n, blocks, SGD_CHUNK,
                                momentum, int(momentum != 0.0), _stream(like))
    _check(lib, err, "sgd_step")
    LAUNCHES["sgd_step"] += 1


def fused_sgd_step(weight, grad, state, lr, wd, momentum, out_dtype=None,
                   out=None, table=None):
    """Single-tensor SGD update with the cast epilogue: returns
    ``(lp, new_w, new_m)`` like the reference's ``fused_sgd_step``
    (``new_m`` is None without momentum).  ``out=(lp, w, m)`` names the
    tensors to write (they may be the inputs: the update is elementwise);
    by default new ones are allocated.  ``lp`` may be ``w`` itself when
    ``out_dtype`` is f32: the master is then written once and returned for
    both.  CPU tensors run the plain version; CUDA tensors launch
    ``csrc/sgd_step.cu`` (one launch) or raise.  ``table`` as for
    :func:`fused_sgd_step_multi`."""
    out_dtype = out_dtype or weight.dtype
    has_mom = float(momentum) != 0.0
    if out is None:
        nw = weight.clone()
        nm = state.clone() if has_mom else None
        lp = nw if out_dtype == torch.float32 else torch.empty_like(
            weight, dtype=out_dtype)
    else:
        lp, nw, nm = out
        if nw is not weight:
            nw.copy_(weight)
        if has_mom and nm is not state:
            nm.copy_(state)
    fused_sgd_step_multi([nw], [grad], [nm], [lr], [wd], momentum,
                         outs=[None if lp is nw else lp], table=table)
    return lp, nw, nm


# --------------------------------------------------------- row softmax
def row_softmax_unsupported_reason(x):
    """Why the row-softmax forward kernel cannot take ``x``, or None: a
    2-D ``[n, d]`` tensor in f32, bf16 or f16 with fewer than 2^31 rows.
    Shapes and dtypes only."""
    if x.dim() != 2:
        return "rank %d != 2" % x.dim()
    if x.dtype not in _DTYPE_CODE:
        return "kernel takes f32, bf16 or f16, got %s" % x.dtype
    n, d = x.shape
    if n == 0 or d == 0:
        return "empty tensor %s" % (tuple(x.shape),)
    if n >= 2 ** 31:
        return "%d rows >= 2^31" % n
    return None


def row_softmax_bwd_unsupported_reason(x, m, l, dy):
    """Why the row-softmax backward kernel cannot take this call, or None:
    the forward's conditions, ``m`` and ``l`` ``[n, 1]`` and ``dy`` of
    ``x``'s shape, all in ``x``'s dtype.  Shapes and dtypes only."""
    reason = row_softmax_unsupported_reason(x)
    if reason is not None:
        return reason
    n = x.shape[0]
    for name, t in (("m", m), ("l", l)):
        if tuple(t.shape) != (n, 1) or t.dtype != x.dtype:
            return "%s must be %s [%d, 1], got %s %s" % (
                name, x.dtype, n, t.dtype, tuple(t.shape))
    if dy.shape != x.shape or dy.dtype != x.dtype:
        return "dy must be %s %s, got %s %s" % (
            x.dtype, tuple(x.shape), dy.dtype, tuple(dy.shape))
    return None


def row_softmax_plain(x):
    """The forward kernel's arithmetic in PyTorch ops, all in f32: the row
    max ``m``, ``l = sum(exp(x - m))``, ``y = exp(x - m) / l``.  Returns
    ``(y, m, l)`` in ``x``'s dtype, ``m`` and ``l`` as ``[n, 1]``."""
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True)
    e = torch.exp(xf - m)
    l = e.sum(dim=-1, keepdim=True)
    return (e / l).to(x.dtype), m.to(x.dtype), l.to(x.dtype)


def row_softmax(x):
    """Softmax over the last axis of ``x [n, d]`` with the saved row
    statistics: ``(y, m, l)`` as :func:`row_softmax_plain` computes them.
    CPU tensors run the plain version; CUDA tensors launch the forward
    kernel of ``csrc/row_softmax.cu`` or raise."""
    if x.device.type == "cpu":
        return row_softmax_plain(x)
    reason = row_softmax_unsupported_reason(x) or _launch_reason(x)
    if reason is not None:
        raise KernelUnsupportedError(
            "row softmax kernel cannot take this call: " + reason)
    n, d = x.shape
    lib = _build.load("row_softmax", _SIGNATURES["row_softmax"])
    y = torch.empty_like(x)
    m = torch.empty((n, 1), dtype=x.dtype, device=x.device)
    l = torch.empty((n, 1), dtype=x.dtype, device=x.device)
    err = lib.mx_row_softmax_fwd(x.data_ptr(), y.data_ptr(), m.data_ptr(),
                                 l.data_ptr(), n, d, _DTYPE_CODE[x.dtype],
                                 _stream(x))
    _check(lib, err, "row_softmax_fwd")
    LAUNCHES["row_softmax_fwd"] += 1
    return y, m, l


def row_softmax_bwd_plain(x, m, l, dy):
    """The backward kernel's arithmetic in PyTorch ops, all in f32, from
    the saved (rounded) ``m`` and ``l``: ``y = exp(x - m) / l``,
    ``dx = y * (dy - sum(dy * y))``, in ``x``'s dtype."""
    y = torch.exp(x.float() - m.float()) / l.float()
    dyf = dy.float()
    dot = (dyf * y).sum(dim=-1, keepdim=True)
    return (y * (dyf - dot)).to(x.dtype)


def row_softmax_bwd(x, m, l, dy):
    """The row softmax's input gradient from the forward's ``x``, ``m``
    and ``l`` and the output gradient ``dy``, as
    :func:`row_softmax_bwd_plain` computes it.  CPU tensors run the plain
    version; CUDA tensors launch the backward kernel of
    ``csrc/row_softmax.cu`` or raise."""
    if x.device.type == "cpu":
        return row_softmax_bwd_plain(x, m, l, dy)
    reason = (row_softmax_bwd_unsupported_reason(x, m, l, dy)
              or _launch_reason(x, m, l, dy))
    if reason is not None:
        raise KernelUnsupportedError(
            "row softmax backward kernel cannot take this call: " + reason)
    n, d = x.shape
    lib = _build.load("row_softmax", _SIGNATURES["row_softmax"])
    dx = torch.empty_like(x)
    err = lib.mx_row_softmax_bwd(x.data_ptr(), m.data_ptr(), l.data_ptr(),
                                 dy.data_ptr(), dx.data_ptr(), n, d,
                                 _DTYPE_CODE[x.dtype], _stream(x))
    _check(lib, err, "row_softmax_bwd")
    LAUNCHES["row_softmax_bwd"] += 1
    return dx


# ------------------------------------------------------ scale bias relu
def scale_bias_relu_unsupported_reason(x, scale, bias):
    """Why the scale-bias-ReLU kernel cannot take this call, or None: a
    2-D ``x [n, d]`` in f32, bf16 or f16 and ``scale``/``bias`` of ``d``
    values in its dtype.  Shapes and dtypes only."""
    if x.dim() != 2:
        return "rank %d != 2" % x.dim()
    if x.dtype not in _DTYPE_CODE:
        return "kernel takes f32, bf16 or f16, got %s" % x.dtype
    n, d = x.shape
    if n == 0 or d == 0:
        return "empty tensor %s" % (tuple(x.shape),)
    for name, t in (("scale", scale), ("bias", bias)):
        if t.numel() != d or t.dtype != x.dtype:
            return "%s must be %d values of %s, got %s %s" % (
                name, d, x.dtype, t.dtype, tuple(t.shape))
    return None


def _relu_nan(v):
    """ReLU that propagates NaN and maps -0 to +0 (``jnp.maximum(v, 0)``)."""
    return torch.where((v > 0) | torch.isnan(v), v, torch.zeros_like(v))


def scale_bias_relu_plain(x, scale, bias):
    """The kernel's arithmetic in PyTorch ops, rounding as it does: f32
    ``relu(fma(x, s, b))`` with the FMA emulated (:func:`_fma`); bf16 and
    f16 ``relu(round(round(x * s) + b))``, each step in f32 and rounded
    to the storage type.  ``scale``/``bias`` hold ``d`` values in ``x``'s
    dtype; the result is in ``x``'s dtype."""
    d = x.shape[-1]
    s = scale.reshape(1, d)
    b = bias.reshape(1, d)
    if x.dtype == torch.float32:
        return _relu_nan(_fma(x, s, b))
    p = (x.float() * s.float()).to(x.dtype).float()
    return _relu_nan(p + b.float()).to(x.dtype)


def scale_bias_relu(x, scale, bias):
    """``relu(x * scale + bias)`` over ``x [n, d]``, ``scale``/``bias`` of
    ``d`` values in ``x``'s dtype, as :func:`scale_bias_relu_plain`
    computes it.  CPU tensors run the plain version; CUDA tensors launch
    ``csrc/scale_bias_relu.cu`` or raise."""
    if x.device.type == "cpu":
        return scale_bias_relu_plain(x, scale, bias)
    reason = (scale_bias_relu_unsupported_reason(x, scale, bias)
              or _launch_reason(x, scale, bias))
    if reason is not None:
        raise KernelUnsupportedError(
            "scale-bias-relu kernel cannot take this call: " + reason)
    n, d = x.shape
    lib = _build.load("scale_bias_relu", _SIGNATURES["scale_bias_relu"])
    y = torch.empty_like(x)
    err = lib.mx_scale_bias_relu(x.data_ptr(), scale.data_ptr(),
                                 bias.data_ptr(), y.data_ptr(), n, d,
                                 _DTYPE_CODE[x.dtype], _stream(x))
    _check(lib, err, "scale_bias_relu")
    LAUNCHES["scale_bias_relu"] += 1
    return y


# ---------------------------------------------------------------- box NMS
#: rows a block of the NMS kernel resolves in shared memory (24 bytes a
#: row, 28 with class ids); a longer segment is taken in chunks of this
#: many rows.  The kernel takes up to 8192; at 4096 two blocks share an
#: SM and a chunk's serial walk is half as long
NMS_BLOCK_ROWS = 4096
#: rows a call (all images) may hold: the kernel's sorted positions are
#: 32-bit
NMS_MAX_ROWS = (1 << 31) - 1024


def box_nms_unsupported_reason(coords, cls, valid):
    """Why the NMS kernel cannot take this call, or None: ``coords [B, N,
    4]`` f32, ``cls [B, N]`` f32 or None, ``valid [B, N]`` bool, with at
    most :data:`NMS_MAX_ROWS` rows over all images.  Shapes and dtypes
    only."""
    if coords.dim() != 3 or coords.shape[-1] != 4:
        return "coords must be [B, N, 4], got %s" % (tuple(coords.shape),)
    if coords.dtype != torch.float32:
        return "kernel takes f32 boxes, got %s" % coords.dtype
    b, n = coords.shape[:2]
    if tuple(valid.shape) != (b, n) or valid.dtype != torch.bool:
        return "valid must be bool [%d, %d], got %s %s" % (
            b, n, valid.dtype, tuple(valid.shape))
    if cls is not None and (tuple(cls.shape) != (b, n)
                            or cls.dtype != torch.float32):
        return "class ids must be f32 [%d, %d], got %s %s" % (
            b, n, cls.dtype, tuple(cls.shape))
    if b * n > NMS_MAX_ROWS:
        return "%d rows over %d images > %d" % (b * n, b, NMS_MAX_ROWS)
    return None


def nms_by_class(cls, overlap_thresh):
    """Whether the scan splits into one scan a class: a class id is given
    and ``overlap_thresh >= 0`` (rows of other classes then never
    suppress, since their 0 > thresh is false; a NaN threshold splits
    nothing)."""
    return cls is not None and overlap_thresh >= 0


def nms_sort(cls, valid, overlap_thresh):
    """The NMS kernel's segments, step 1 of ``csrc/box_nms.cu``.  When
    the scan splits by class (:func:`nms_by_class`): all rows sorted
    stably, flat, by a key, NaN for an invalid row, else the class id
    with -0.0 read as 0.0 (``-0.0 + 0.0`` is 0.0); a segment is a run of
    one image's rows of one key, in score order, and a valid row of NaN
    class is one of its own.  Returns ``(keys, perm)``, ``[B * N]`` each
    (``perm`` the flat row at each position), from PyTorch ops on
    ``valid``'s device with no host synchronisation; or None when the
    scan does not split, and each image's valid rows, in order, are one
    segment."""
    if not nms_by_class(cls, overlap_thresh):
        return None
    key = (cls + 0.0).masked_fill_(~valid, float("nan"))
    return torch.sort(key.view(-1), stable=True)


def _box_area(c):
    return (c[..., 2] - c[..., 0]).clamp(min=0) * \
        (c[..., 3] - c[..., 1]).clamp(min=0)


def _iou_later(a, area_a, rest, area_rest):
    """IoU of one box ``a [4]`` (its area ``area_a``) with the later boxes
    ``rest [m, 4]``, rounding as the reference's ``_corner_iou``: one
    rounding an operation, ``inter / max((area_a + area_b) - inter,
    1e-12)``."""
    w = (torch.minimum(a[2], rest[:, 2])
         - torch.maximum(a[0], rest[:, 0])).clamp(min=0)
    h = (torch.minimum(a[3], rest[:, 3])
         - torch.maximum(a[1], rest[:, 1])).clamp(min=0)
    inter = w * h
    return inter / (area_a + area_rest - inter).clamp(min=1e-12)


def _greedy_keep(coords, area, cls, overlap_thresh):
    """The greedy scan over rows that are all valid, in order: the host
    keep mask (numpy bool)."""
    n = coords.shape[0]
    keep = _np.ones(n, dtype=bool)
    for i in range(n - 1):
        if not keep[i]:
            continue
        v = _iou_later(coords[i], area[i], coords[i + 1:], area[i + 1:])
        if cls is not None:
            v = torch.where(cls[i + 1:] == cls[i], v, torch.zeros_like(v))
        keep[i + 1:] &= ~(v > overlap_thresh).cpu().numpy()
    return keep


def box_nms_sorted_plain(coords, cls, valid, overlap_thresh):
    """The greedy scan of the reference's ``_nms_one`` (contrib.py:77-86)
    by its definition, in O(N) memory: for each row in order that is
    still kept, clear every later valid row it suppresses, where row i
    suppresses a later row j when ``(cls[i] != cls[j] ? 0 : iou(i, j)) >
    overlap_thresh`` (``cls`` None: any class).  ``coords [B, N, 4]``
    sorted by score, ``valid [B, N]`` the rows that may be kept (topk
    applied).  Returns the keep mask ``[B, N]`` (bool) on ``coords``'s
    device.

    Only valid rows take part (an invalid row is never kept, so it
    suppresses nothing); with classes, a threshold >= 0 and no NaN class,
    rows of different classes never suppress each other, so each class
    is scanned on its own.  The kept set is read on the host, one copy a
    kept row."""
    b, n = valid.shape
    keep = _np.zeros((b, n), dtype=bool)
    area = _box_area(coords)
    by_class = cls is not None and overlap_thresh >= 0 \
        and not bool(torch.isnan(cls).any())
    for img in range(b):
        rows = valid[img]
        if by_class:
            groups = [rows & (cls[img] == c)
                      for c in torch.unique(cls[img][rows]).tolist()]
        else:
            groups = [rows]
        for g in groups:
            idx = torch.nonzero(g).flatten()
            if idx.numel() == 0:
                continue
            keep[img, idx.cpu().numpy()] = _greedy_keep(
                coords[img, idx], area[img, idx],
                None if (cls is None or by_class) else cls[img, idx],
                overlap_thresh)
    return torch.from_numpy(keep).to(coords.device)


def box_nms_sorted(coords, cls, valid, overlap_thresh):
    """The keep mask of the greedy NMS scan over score-sorted rows, as
    :func:`box_nms_sorted_plain` computes it.  CPU tensors run the plain
    version; CUDA tensors sort the segments (:func:`nms_sort`) and launch
    ``csrc/box_nms.cu`` once, with no host synchronisation, or raise."""
    if coords.device.type == "cpu":
        return box_nms_sorted_plain(coords, cls, valid, overlap_thresh)
    coords = coords.contiguous()
    valid = valid.contiguous()
    cls = cls.contiguous() if cls is not None else None
    reason = box_nms_unsupported_reason(coords, cls, valid) or \
        _launch_reason(coords, valid, *([cls] if cls is not None else []))
    if reason is None and coords.data_ptr() % 16:
        reason = "coords not 16-byte aligned"
    if reason is not None:
        raise KernelUnsupportedError(
            "box NMS kernel cannot take this call: " + reason)
    b, n = valid.shape
    keep = torch.empty((b, n), dtype=torch.bool, device=coords.device)
    if n == 0 or b == 0:
        return keep
    keys, perm = nms_sort(cls, valid, overlap_thresh) or (None, None)
    _launch_nms(coords, cls, valid, keys, perm, keep, overlap_thresh)
    LAUNCHES["box_nms"] += 1
    return keep


def _launch_nms(coords, cls, valid, keys, perm, keep, overlap_thresh,
                block_rows=NMS_BLOCK_ROWS, pairs=None):
    """The kernel over the segments :func:`nms_sort` gave (``keys`` and
    ``perm`` None: an image a segment), into ``keep`` (zeroed by the
    launch).  ``block_rows``, a multiple of 64 up to 8192: the rows a
    block resolves in shared memory (longer segments are chunked);
    ``pairs``, a zeroed int64 tensor of one element, counts the IoUs the
    kernel computes."""
    lib = _build.load("box_nms", _SIGNATURES["box_nms"])
    b, n = valid.shape
    nbytes = lib.mx_box_nms_scratch_bytes(b, n, block_rows)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=coords.device)
    class_aware = cls is not None and not nms_by_class(cls, overlap_thresh)
    err = lib.mx_box_nms(
        coords.data_ptr(), cls.data_ptr() if class_aware else None,
        valid.data_ptr(), None if keys is None else keys.data_ptr(),
        None if perm is None else perm.data_ptr(), keep.data_ptr(),
        scratch.data_ptr(), nbytes,
        pairs.data_ptr() if pairs is not None else None, b, n, block_rows,
        float(overlap_thresh), int(class_aware), _stream(coords))
    _check(lib, err, "box_nms")
