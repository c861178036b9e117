"""``mx.kernels`` — routing tier for the hand-written CUDA kernels
(counterpart of ``mxnet_tpu.kernels``).

The raw kernels live in ``ops/cuda_kernels.py`` and stay policy-free; this
module owns when they run:

* tier off (``kernels.enabled`` false) -> the plain lowering
  (``parallel.ring_attention.attention``, ``paged_attention_plain``,
  ``paged_attention_pool_plain``);
  this is the only way to run the plain version on CUDA tensors;
* tier on -> the kernel wrapper (``kernels.flash_attention`` /
  ``kernels.paged_attention`` counters, one per call, so one per
  transformer layer; the decode step's ``paged_attention_pool`` counts on
  ``kernels.paged_attention`` too).  The wrapper launches the CUDA kernel
  for CUDA tensors, or raises
  :class:`~mxnet_tpu_torch.base.KernelUnsupportedError` naming what the
  kernel cannot take; CPU tensors run its plain version.
  Attention goes through :class:`_FlashVJP`, the counterpart of the
  reference's ``_flash_vjp`` custom VJP: its forward is the flash kernel,
  its backward the two flash backward kernels, so a loss built on it
  carries its gradient through attention.
* NMS (:func:`box_nms`, counted on ``kernels.box_nms``): tier on, the
  greedy scan's kernel wrapper ``cuda_kernels.box_nms_sorted``; tier off,
  its plain version ``box_nms_sorted_plain``, also on CUDA tensors.  The
  kernel takes f32 boxes (``cuda_kernels.box_nms_unsupported_reason``).
* the fused optimizer step (:func:`fused_step_enabled`): tier on and an
  optimizer that has ``step_fused`` and is ``jit_safe``.
  ``kernels.fused_step`` (:func:`note_fused_step`) counts, as in the
  reference, once per tensor updated through ``update_multi_precision``
  (a list of tensors goes through one ``step_fused_multi`` call) and
  once per built step in ``parallel.SPMDTrainer`` (whose every step then
  updates all trainable tensors in one ``step_fused_multi`` call: one
  launch of K1 for SGD, of K3 for Adam).

The feasibility checks are the Hopper kernels' own
(``cuda_kernels.flash_unsupported_reason`` / ``paged_unsupported_reason``
/ ``paged_pool_unsupported_reason``: dtype, head dim, shapes).  Their
domains: the flash kernels take bf16 at head dim 64 and f32 at 16, 32 and
64 (``cuda_kernels.FLASH_HEAD_DIMS``); the paged kernel a bf16 query over
bf16 or int8 pages at head dim 64, and an f32 query over f32 or int8
pages at 16 and 64 (``cuda_kernels.PAGED_HEAD_DIMS``).  f16, and the
other head dims the reference takes (up to 512), raise.  The
reference's checks compared a whole head's K/V with a 2 MiB VMEM budget,
which has no meaning here: both kernels tile K/V through shared memory
(or read it in place), so context length never disqualifies a call.
``mx.autotune`` picks launch parameters, never a route: the paged
kernel's keys per split (``autotune.paged_pick``, applied here by
:func:`paged_attention_pool`) and K1's and K3's elements a block for a
searched tensor list (``autotune.fused_step_pick``, applied where an
optimizer makes the list's launch table).  K2f takes no launch parameter:
``autotune.search_attention`` records its one point, and no attention
dispatch consults the cache.  The reference's gate, which could route a site to the XLA
lowering where that measured faster, has no counterpart: the tier-off
knob is the only way to a plain version on CUDA tensors.

The reference's other names are here under the same names, so user code
ports unchanged: :func:`flash_attention` (K2f with its backward, as the
reference's differentiable Pallas kernel), :func:`pallas_paged_attention`
(the CUDA paged kernel, ``csrc/paged_attn.cu``, over a gathered context;
the name is the reference's), :func:`fused_sgd_step` /
:func:`fused_adam_step` (K1 / K3 on one tensor),
:func:`flash_unsupported_reason` / :func:`paged_unsupported_reason` (the
Hopper kernels' feasibility checks) and :func:`measure` (one call
registered with ``mx.perf`` under the ``kernels`` family).
"""
from __future__ import annotations

import contextlib

import torch

from . import config as _config
from . import telemetry as _telemetry
from .ops import cuda_kernels as _ck
from .parallel.ring_attention import attention as _plain_attention

__all__ = ["enabled", "attention", "paged_attention", "paged_attention_pool",
           "flash_unsupported_reason", "paged_unsupported_reason",
           "record_paged_routes", "fused_step_enabled", "note_fused_step",
           "flash_attention", "pallas_paged_attention", "fused_sgd_step",
           "fused_adam_step", "measure", "box_nms"]


def enabled():
    """True when the kernel tier is switched on (``kernels.enabled``)."""
    return bool(_config.get("kernels.enabled"))


class _FlashVJP(torch.autograd.Function):
    """Flash attention with its backward (the reference's ``_flash_vjp``).

    Forward: ``cuda_kernels.flash_attention`` -> ``o``, saving
    ``q, k, v, o, lse``.  Backward: ``delta = rowsum(dO * O)`` in f32 with
    plain ops, then ``cuda_kernels.flash_attention_bwd`` (dq, then dk/dv),
    gradients in the input dtype.  On CPU tensors both halves run the
    kernels' plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _ck.flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = _ck.flash_delta(o, do)
        dq, dk, dv = _ck.flash_attention_bwd(
            q, k, v, o, lse, do, causal=ctx.causal, scale=ctx.scale,
            delta=delta)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def attention(q, k, v, causal=False, scale=None):
    """Dot-product attention with kernel routing (see the module doc).
    q/k/v ``[B, H, S, D]``; differentiable on both routes."""
    if enabled():
        _telemetry.counter("kernels.flash_attention").inc()
        return _FlashVJP.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), bool(causal), scale)
    return _plain_attention(q, k, v, causal=causal, scale=scale)


def fused_step_enabled(optimizer):
    """True when ``optimizer`` should update through its fused kernel
    (``step_fused``): tier on, the optimizer has a fused step
    (``fused_step``) and its step math is ``jit_safe``.  No autotune pick
    decides it: the port's picks choose a launch parameter, never a
    route (``autotune.fused_step_pick`` is read where the kernel's launch
    table is made)."""
    return (enabled() and bool(getattr(optimizer, "fused_step", False))
            and bool(getattr(optimizer, "jit_safe", True)))


def flash_unsupported_reason(q, k, v, causal):
    """Why the flash kernel cannot take this call, or None
    (``cuda_kernels.flash_unsupported_reason``: shapes and dtypes)."""
    return _ck.flash_unsupported_reason(q, k, v, causal)


def paged_unsupported_reason(q, k, v, valid, quantized=False):
    """Why the paged kernel cannot take this gathered-context call, or
    None (``cuda_kernels.paged_unsupported_reason``).  ``quantized`` says
    the pages are int8 (their scales' shapes are not checked here)."""
    if quantized:
        B, H, K = q.shape[0], q.shape[1], k.shape[2]
        scale = torch.empty((B, H, K), dtype=torch.float32, device="meta")
        return _ck.paged_unsupported_reason(q, k, v, valid, scale, scale)
    return _ck.paged_unsupported_reason(q, k, v, valid)


def flash_attention(q, k, v, causal=False, scale=None, block_q=None):
    """Flash attention through K2f with its backward (the reference's
    differentiable kernel entry): ``o [B, H, Sq, D]``.  ``block_q`` is the
    TPU kernel's tile and has no meaning for the Hopper kernel, whose
    tiles are compiled in: it is accepted and ignored."""
    return _FlashVJP.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           bool(causal), scale)


def pallas_paged_attention(q, k, v, valid, scale=None, k_scale=None,
                           v_scale=None, block_bh=None):
    """The paged decode kernel over a gathered context (the reference's
    name; here it is the CUDA kernel ``csrc/paged_attn.cu``, through
    ``cuda_kernels.paged_attention``).  ``block_bh`` is the TPU kernel's
    row block and has no meaning here: it is accepted and ignored."""
    return _ck.paged_attention(q.contiguous(), k, v, valid, scale=scale,
                               k_scale=k_scale, v_scale=v_scale)


#: K1 on one tensor (``cuda_kernels.fused_sgd_step``)
fused_sgd_step = _ck.fused_sgd_step
#: K3 on one tensor (``cuda_kernels.fused_adam_step``)
fused_adam_step = _ck.fused_adam_step


def measure(key, fn, *args):
    """Run ``fn(*args)`` once, counted by ``mx.perf`` under the
    ``kernels`` family (``perf.wrap``): returns ``(outputs, record)``, the
    record carrying the FLOPs and bytes (a hand kernel's own analytic
    cost), the counted run's wall time and the roofline verdict."""
    from . import perf as _perf
    wrapped = _perf.wrap(fn, "kernels", key)
    out = wrapped(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, _perf.program("kernels", key)


def note_fused_step():
    """Count one fused optimizer update (``kernels.fused_step``)."""
    _telemetry.counter("kernels.fused_step").inc()


def box_nms(coords, cls, valid, overlap_thresh):
    """The keep mask ``[B, N]`` of the greedy NMS scan over score-sorted
    rows (``coords [B, N, 4]``, class ids ``cls [B, N]`` or None for
    suppression across classes, ``valid [B, N]`` the rows that may be
    kept), with kernel routing (see the module doc); the ops ``box_nms``,
    ``MultiBoxDetection`` and ``Proposal`` reach NMS only here."""
    if enabled():
        _telemetry.counter("kernels.box_nms").inc()
        return _ck.box_nms_sorted(coords, cls, valid, overlap_thresh)
    return _ck.box_nms_sorted_plain(coords, cls, valid, overlap_thresh)


# Route capture: under record_paged_routes() every paged routing decision
# lands as {"impl", "reason", "quantized"} in the yielded list.
_PAGED_ROUTE_SINK = []


@contextlib.contextmanager
def record_paged_routes():
    """Collect ``{"impl", "reason", "quantized"}`` dicts for every paged
    route decision made under this context."""
    routes = []
    _PAGED_ROUTE_SINK.append(routes)
    try:
        yield routes
    finally:
        _PAGED_ROUTE_SINK.remove(routes)


def _note_paged_route(impl, reason, quantized):
    for routes in _PAGED_ROUTE_SINK:
        routes.append({"impl": impl, "reason": reason,
                       "quantized": bool(quantized)})


def paged_attention(q, k, v, valid, scale=None, k_scale=None,
                    v_scale=None):
    """Decode-step attention over a page-gathered context window.

    ``q [B, H, 1, Dh]``; ``k``/``v [B, H, K, Dh]`` gathered through the
    page table (slots past a sequence's length hold stale or
    clipped-sentinel data); ``valid [B, K]`` masks exactly the real
    positions.  With ``k_scale``/``v_scale`` (``[B, H, K]`` f32 from
    ``quantization.quantize_rows``) the pages are int8 and dequantise in
    the consumer.  Routing as in :func:`attention`, counted on
    ``kernels.paged_attention``."""
    quant = k_scale is not None
    if enabled():
        _telemetry.counter("kernels.paged_attention").inc()
        _note_paged_route("paged", None, quant)
        return _ck.paged_attention(q.contiguous(), k, v, valid,
                                   scale=scale, k_scale=k_scale,
                                   v_scale=v_scale)
    _note_paged_route("plain", "tier off", quant)
    return _ck.paged_attention_plain(q, k, v, valid, scale=scale,
                                     k_scale=k_scale, v_scale=v_scale)


def paged_attention_pool(q, k_pool, v_pool, page_table, lengths, scale=None,
                         k_scale_pool=None, v_scale_pool=None):
    """Decode-step attention read through the page table from the page
    pool itself (no gathered copy).

    ``q [B, H, 1, Dh]``; ``k_pool``/``v_pool [pool, psz, H, Dh]`` (one
    layer's pool); ``page_table [B, W]`` int32 (entries past a sequence's
    length may be sentinels); ``lengths [B]`` int32, the real positions
    ``0 .. lengths[b] - 1``.  With ``k_scale_pool``/``v_scale_pool``
    (``[pool, psz, H]`` f32) the pool is int8.  Routing as in
    :func:`paged_attention` (tier off: the gather and the plain version),
    counted on ``kernels.paged_attention``; the keys per split are
    ``autotune.paged_pick``'s where it has one (the fixed rule
    otherwise)."""
    quant = k_scale_pool is not None
    if enabled():
        _telemetry.counter("kernels.paged_attention").inc()
        _note_paged_route("paged", None, quant)
        from . import autotune as _autotune
        per = _autotune.paged_pick(
            tuple(q.shape), page_table.shape[1] * k_pool.shape[1],
            str(q.dtype).replace("torch.", ""), quant)
        return _ck.paged_attention_pool(
            q.contiguous(), k_pool, v_pool, page_table, lengths, scale=scale,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
            keys_per_split=per)
    _note_paged_route("plain", "tier off", quant)
    return _ck.paged_attention_pool_plain(
        q, k_pool, v_pool, page_table, lengths, scale=scale,
        k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
