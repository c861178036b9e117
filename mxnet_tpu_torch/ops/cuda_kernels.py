"""Hand-written CUDA kernels and their plain PyTorch versions
(counterpart of ``mxnet_tpu.ops.pallas_kernels``).

Two kernels, sources under ``mxnet_tpu_torch/csrc``:

* ``flash_attention`` — flash-attention forward (``csrc/flash_fwd.cu``),
  the port of ``_flash_fwd_kernel``; returns ``(o, lse)``.
* ``paged_attention`` — single-query paged decode attention over a
  page-gathered context, bf16 or int8 K/V (``csrc/paged_attn.cu``), the
  port of ``_paged_attn_kernel``.

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
and nowhere else (``flash_fwd``, ``paged_decode_bf16``,
``paged_decode_int8``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import KernelUnsupportedError
from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "paged_attention",
           "paged_attention_plain", "flash_unsupported_reason",
           "paged_unsupported_reason", "LAUNCHES", "reset_launches",
           "HEAD_DIM", "NEG"]

#: masked-score floor of the plain versions (parallel.ring_attention)
NEG = -1e30
#: the head dim both kernels are instantiated for (that of every served
#: configuration; another needs its own instantiation, checked on the card)
HEAD_DIM = 64

LAUNCHES = {"flash_fwd": 0, "paged_decode_bf16": 0, "paged_decode_int8": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_fwd": {
        "mx_flash_fwd_bf16": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                               _P], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "paged_attn": {
        "mx_paged_decode": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _P], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
}


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
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        return "kernel takes bf16, got %s" % q.dtype
    if q.shape[3] != HEAD_DIM:
        return "head dim %d != %d" % (q.shape[3], HEAD_DIM)
    if q.shape[0] * q.shape[1] > 65535:
        return "B*H %d > 65535" % (q.shape[0] * q.shape[1])
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


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash-attention forward: ``(o, lse)`` as :func:`flash_attention_plain`
    computes them.  CPU tensors run the plain version; CUDA tensors launch
    ``csrc/flash_fwd.cu`` (contiguous bf16, head dim 64) or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    reason = (flash_unsupported_reason(q, k, v, causal)
              or _launch_reason(q, k, v))
    if reason is not None:
        raise KernelUnsupportedError(
            "flash kernel cannot take this call: " + reason)
    B, H, S, D = q.shape
    Skv = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load("flash_fwd", _SIGNATURES["flash_fwd"])
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    err = lib.mx_flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), lse.data_ptr(), B * H, S, Skv,
                                D, int(bool(causal)), scale, _stream(q))
    _check(lib, err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


# ------------------------------------------------------- paged attention
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
    if q.dtype != torch.bfloat16:
        return "kernel takes a bf16 query, got %s" % q.dtype
    quant = k_scale is not None
    want = torch.int8 if quant else torch.bfloat16
    if k.dtype != want or v.dtype != want:
        return "kernel takes %s pages, got %s" % (want, k.dtype)
    if quant and (v_scale is None
                  or tuple(k_scale.shape) != (B, H, K)
                  or tuple(v_scale.shape) != (B, H, K)
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        return "int8 pages need f32 k_scale/v_scale [B,H,K]"
    if D != HEAD_DIM:
        return "head dim %d != %d" % (D, HEAD_DIM)
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
    """Single-query paged decode attention.  ``q [B,H,1,D]``; ``k``/``v``
    ``[B,H,K,D]`` gathered through the page table; ``valid [B,K]`` bool;
    int8 pages come with ``k_scale``/``v_scale [B,H,K]`` f32.  CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/paged_attn.cu`` or raise."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k, v, valid, scale=scale,
                                     k_scale=k_scale, v_scale=v_scale)
    quant = k_scale is not None
    tensors = [q, k, v, valid] + ([k_scale, v_scale] if quant else [])
    reason = (paged_unsupported_reason(q, k, v, valid, k_scale, v_scale)
              or _launch_reason(*tensors))
    if reason is not None:
        raise KernelUnsupportedError(
            "paged kernel cannot take this call: " + reason)
    B, H, _, D = q.shape
    K = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load("paged_attn", _SIGNATURES["paged_attn"])
    o = torch.empty_like(q)
    err = lib.mx_paged_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, o.data_ptr(), B, H, K, D,
        int(quant), scale, _stream(q))
    _check(lib, err, "paged_decode")
    LAUNCHES["paged_decode_int8" if quant else "paged_decode_bf16"] += 1
    return o
