"""Hand-written CUDA kernels and their plain PyTorch versions
(counterpart of ``mxnet_tpu.ops.pallas_kernels``).

Kernels, sources under ``mxnet_tpu_torch/csrc``:

* ``flash_attention`` — flash-attention forward (``csrc/flash_fwd.cu``),
  the port of ``_flash_fwd_kernel``; returns ``(o, lse)``.
* ``flash_attention_bwd`` — its backward, two kernels in
  ``csrc/flash_bwd.cu``: dq over q tiles (port of ``_flash_bwd_dq_kernel``)
  and dk/dv over kv tiles (port of ``_flash_bwd_dkv_kernel``).
* ``paged_attention`` — single-query paged decode attention over a
  page-gathered context, bf16 or int8 K/V (``csrc/paged_attn.cu``), the
  port of ``_paged_attn_kernel``.
* ``fused_adam_step`` — the Adam update with its low-precision cast in one
  elementwise pass (``csrc/adam_step.cu``), the port of
  ``_adam_epilogue_kernel``.

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
``paged_decode_bf16``, ``paged_decode_int8``, ``adam_step``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import KernelUnsupportedError
from . import _build

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "paged_attention", "paged_attention_plain", "fused_adam_step",
           "fused_adam_step_plain", "flash_unsupported_reason",
           "flash_bwd_unsupported_reason", "paged_unsupported_reason",
           "adam_unsupported_reason", "sqrt_rn", "div_rn", "LAUNCHES",
           "reset_launches",
           "HEAD_DIM", "NEG"]

#: masked-score floor of the plain versions (parallel.ring_attention)
NEG = -1e30
#: the head dim both kernels are instantiated for (that of every served
#: configuration; another needs its own instantiation, checked on the card)
HEAD_DIM = 64

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "paged_decode_bf16": 0, "paged_decode_int8": 0, "adam_step": 0}

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
    "paged_attn": {
        "mx_paged_decode": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _P], _I),
        "mx_error_string": ([_I], ctypes.c_char_p),
    },
    "adam_step": {
        "mx_adam_step": ([_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int64, _I,
                          _F, _F, _F, _F, _F, _F, _F, _P], _I),
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
    launch the two kernels of ``csrc/flash_bwd.cu`` (dq, then dk/dv;
    contiguous bf16, head dim 64) or raise."""
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
    return _build.load("flash_bwd", _SIGNATURES["flash_bwd"]), ptrs, dims


def _launch_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """Launch K2dq alone on checked inputs (:func:`flash_attention_bwd`
    checks them); returns dq."""
    lib, ptrs, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    dq = torch.empty_like(q)
    _check(lib, lib.mx_flash_bwd_dq_bf16(*ptrs, dq.data_ptr(), *dims),
           "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """Launch K2dkv alone on checked inputs; returns ``(dk, dv)``."""
    lib, ptrs, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _check(lib, lib.mx_flash_bwd_dkv_bf16(*ptrs, dk.data_ptr(),
                                          dv.data_ptr(), *dims),
           "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


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


# ---------------------------------------------------------------- adam
def adam_unsupported_reason(weight, grad, m, v, out_dtype):
    """Why the Adam kernel cannot take this call, or None: f32 master,
    m and v of one shape, a grad of that shape in f32 or bf16, and a bf16
    cast.  Shapes and dtypes only."""
    shape = weight.shape
    if any(t.shape != shape for t in (grad, m, v)):
        return "shapes differ: w%s g%s m%s v%s" % tuple(
            tuple(t.shape) for t in (weight, grad, m, v))
    if not (weight.dtype == m.dtype == v.dtype == torch.float32):
        return "master/m/v must be f32, got %s/%s/%s" % (
            weight.dtype, m.dtype, v.dtype)
    if grad.dtype not in (torch.float32, torch.bfloat16):
        return "grad must be f32 or bf16, got %s" % grad.dtype
    if out_dtype != torch.bfloat16:
        return "the cast must be bf16, got %s" % out_dtype
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
    ``(w'.to(out_dtype), w', (m', v'))``."""
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


def fused_adam_step(weight, grad, m, v, lr_t, wd, beta1, beta2, eps,
                    out_dtype=torch.bfloat16, out=None):
    """Single-kernel Adam update with the cast epilogue: returns
    ``(lp, new_w, (new_m, new_v))`` like the reference's
    ``fused_adam_step``.  ``weight`` is the f32 master; ``grad`` f32 or
    bf16 (widened in registers, exactly).  ``out=(lp, w, m, v)`` names
    the tensors to write (they may be the inputs themselves: the update
    is elementwise, so writing in place is safe and saves the copies);
    by default new ones are allocated.  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/adam_step.cu`` or raise."""
    if weight.device.type == "cpu":
        res = fused_adam_step_plain(weight, grad, m, v, lr_t, wd, beta1,
                                    beta2, eps, out_dtype=out_dtype)
        if out is None:
            return res
        lp, nw, (nm, nv) = res
        for dst, src in zip(out, (lp, nw, nm, nv)):
            dst.copy_(src)
        return out[0], out[1], (out[2], out[3])
    reason = adam_unsupported_reason(weight, grad, m, v, out_dtype)
    if reason is None and out is not None:
        dtypes = (out_dtype, torch.float32, torch.float32, torch.float32)
        if any(o.shape != weight.shape or o.dtype != dt
               for o, dt in zip(out, dtypes)):
            reason = "out tensors must be (%s, f32, f32, f32) of %s" % (
                out_dtype, tuple(weight.shape))
    if reason is None:
        if out is None:
            out = (torch.empty_like(weight, dtype=out_dtype),
                   torch.empty_like(weight), torch.empty_like(m),
                   torch.empty_like(v))
        reason = _launch_reason(weight, grad, m, v, *out)
    if reason is not None:
        raise KernelUnsupportedError(
            "adam kernel cannot take this call: " + reason)
    lp, nw, nm, nv = out
    lib = _build.load("adam_step", _SIGNATURES["adam_step"])
    err = lib.mx_adam_step(
        weight.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(),
        nw.data_ptr(), nm.data_ptr(), nv.data_ptr(), lp.data_ptr(),
        weight.numel(), int(grad.dtype == torch.bfloat16),
        float(lr_t), float(wd), float(beta1), float(beta2),
        1.0 - float(beta1), 1.0 - float(beta2), float(eps), _stream(weight))
    _check(lib, err, "adam_step")
    LAUNCHES["adam_step"] += 1
    return lp, nw, (nm, nv)
