"""The port's kernel tier held against the reference's Pallas kernels.

The CUDA kernels themselves (``mxnet_tpu_torch/csrc``) build and run only
on an H100; ``chip_smoke.py`` holds each against its plain version there.
Here, on the CPU, the plain versions — the arithmetic the kernels
implement — are held against the Pallas kernels run in interpret mode,
with inputs made by numpy from a seed.

Tolerance: f32 inputs, <= 1e-6 absolute (the reference's own f32 bound;
the two sides sum in different orders, so bitwise is not promised).
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.quantization import dequantize_rows as jax_dequantize_rows
from mxnet_tpu.quantization import quantize_rows as jax_quantize_rows

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kernels as tk
from mxnet_tpu_torch import quantization as tq
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------- paged decode
def _paged_case(B=3, H=2, K=40, D=16, seed=7, quant=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, 1, D).astype(np.float32)
    # ragged valid prefixes, one of them a single position
    lens = np.asarray([K - 5, K, 1][:B])
    valid = np.arange(K)[None, :] < lens[:, None]
    if quant:
        k = rng.randint(-127, 128, (B, H, K, D)).astype(np.int8)
        v = rng.randint(-127, 128, (B, H, K, D)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, (B, H, K)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (B, H, K)).astype(np.float32)
        return q, k, v, valid, ks, vs
    k = rng.randn(B, H, K, D).astype(np.float32)
    v = rng.randn(B, H, K, D).astype(np.float32)
    return q, k, v, valid, None, None


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_plain_matches_pallas_kernel(quant):
    q, k, v, valid, ks, vs = _paged_case(quant=quant)
    want = pk.pallas_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    before = dict(ck.LAUNCHES)
    got = ck.paged_attention(
        _t(q), _t(k), _t(v), _t(valid),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    assert ck.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


# ------------------------------------------------ paged decode, pool form
def _pool_case(dtype, B=3, H=2, D=16, psz=4, W=5, pool=23, seed=9):
    """A page pool, a shuffled page table whose entries past each
    sequence's length are sentinels (``pool``, out of range), ragged
    lengths (a full row, a middle one, a single position), and the same
    context gathered by hand with numpy: ``(q, k_pool, v_pool, ks, vs,
    table, lengths, k [B,H,K,D], v, k_scale [B,H,K], v_scale, valid)``."""
    rng = np.random.RandomState(seed)
    K = W * psz
    q = rng.randn(B, H, 1, D).astype(np.float32)
    if dtype == "int8":
        kp = rng.randint(-127, 128, (pool, psz, H, D)).astype(np.int8)
        vp = rng.randint(-127, 128, (pool, psz, H, D)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, (pool, psz, H)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (pool, psz, H)).astype(np.float32)
    else:
        kp = rng.randn(pool, psz, H, D).astype(np.float32)
        vp = rng.randn(pool, psz, H, D).astype(np.float32)
        ks = vs = None
    lengths = np.asarray([K, 2 * psz + 1, 1][:B], np.int32)
    table = rng.permutation(pool)[:B * W].reshape(B, W).astype(np.int32)
    for b in range(B):
        used = -(-lengths[b] // psz)
        table[b, used:] = pool               # sentinel
    pages = np.clip(table, 0, pool - 1)
    k = np.stack([kp[pages[b]].reshape(K, H, D).transpose(1, 0, 2)
                  for b in range(B)])
    v = np.stack([vp[pages[b]].reshape(K, H, D).transpose(1, 0, 2)
                  for b in range(B)])
    kscale = vscale = None
    if ks is not None:
        kscale = np.stack([ks[pages[b]].reshape(K, H).T for b in range(B)])
        vscale = np.stack([vs[pages[b]].reshape(K, H).T for b in range(B)])
    valid = np.arange(K)[None, :] < lengths[:, None]
    return q, kp, vp, ks, vs, table, lengths, k, v, kscale, vscale, valid


def _opt_t(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_pool_plain_equals_gathered_plain(dtype):
    """The pool form's plain version, through a shuffled table with
    sentinel entries past each length, equals ``paged_attention_plain``
    on the context gathered by hand, bit for bit (bf16, f32 and int8
    pools); a CPU tensor launches nothing."""
    (q, kp, vp, ks, vs, table, lengths, k, v, kscale, vscale,
     valid) = _pool_case(dtype)
    cast = (lambda a: _t(a).bfloat16()) if dtype == "bfloat16" else _t
    qt = cast(q)
    before = dict(ck.LAUNCHES)
    got = ck.paged_attention_pool(
        qt, cast(kp), cast(vp), _t(table), _t(lengths),
        k_scale_pool=_opt_t(ks), v_scale_pool=_opt_t(vs))
    assert ck.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    want = ck.paged_attention_plain(qt, cast(k), cast(v), _t(valid),
                                    k_scale=_opt_t(kscale),
                                    v_scale=_opt_t(vscale))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert torch.equal(got, want)
    # the gather helper itself: the hand gather, sentinels clamped
    assert torch.equal(ck.gather_pages(cast(kp), _t(table)), cast(k))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_pool_plain_matches_pallas_kernel(quant):
    """The pool form's plain version equals the reference's Pallas kernel
    (interpret mode) over the hand-gathered context, within ATOL."""
    (q, kp, vp, ks, vs, table, lengths, k, v, kscale, vscale,
     valid) = _pool_case("int8" if quant else "float32")
    want = pk.pallas_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        k_scale=None if kscale is None else jnp.asarray(kscale),
        v_scale=None if vscale is None else jnp.asarray(vscale))
    got = ck.paged_attention_pool(
        _t(q), _t(kp), _t(vp), _t(table), _t(lengths),
        k_scale_pool=_opt_t(ks), v_scale_pool=_opt_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("bh,kctx", [(12, 16), (12, 2048), (96, 16),
                                     (96, 2048), (96, 512), (8 * 64, 64),
                                     (1, 100000)])
def test_paged_splits_cover_the_context(bh, kctx):
    """The split-K choice covers every key exactly once (splits x keys a
    split >= K, the last split non-empty), each split a multiple of
    PAGED_SPLIT_KEYS, and at least half the target block count wherever
    the context has keys enough (rounding a split up to whole steps of
    PAGED_SPLIT_KEYS keys costs at most half)."""
    per, splits = ck.paged_splits(bh, kctx)
    assert per % ck.PAGED_SPLIT_KEYS == 0
    assert per * splits >= kctx > per * (splits - 1)
    most = -(-kctx // ck.PAGED_SPLIT_KEYS)
    assert bh * splits >= min(ck.PAGED_TARGET_BLOCKS // 2, bh * most)


def test_paged_counters_one_buffer_a_stream():
    """The split-K merge's counts are kept per (device, stream): launches
    on two streams never share a buffer, launches on one stream do (and so
    run in order), a wider launch grows the stream's buffer, and dropping
    a stream's buffer (after a failed launch) gives it fresh zeros."""
    dev = torch.device("cpu")
    a, b = 0x1000, 0x2000   # two raw stream handles
    try:
        ca = ck._paged_counters(dev, a, 96)
        assert ck._paged_counters(dev, a, 96) is ca
        cb = ck._paged_counters(dev, b, 96)
        assert cb is not ca and cb.data_ptr() != ca.data_ptr()
        assert ca.dtype == torch.int32 and not ca.any()
        wide = ck._paged_counters(dev, a, 4096)
        assert wide.numel() >= 4096 and wide is not ca
        assert ck._paged_counters(dev, b, 96) is cb
        wide[0] = 3
        ck._drop_paged_counters(dev, a)
        fresh = ck._paged_counters(dev, a, 96)
        assert fresh is not wide and not fresh.any()
    finally:
        ck._drop_paged_counters(dev, a)
        ck._drop_paged_counters(dev, b)


def test_paged_pool_checks_and_routing():
    """The pool form's check takes the served decode shapes (B=8, H=12,
    D=64, pages of 16, widths 1..128, bf16 and int8 pools) and names what
    it refuses; ``kernels.paged_attention_pool`` routes like
    ``kernels.paged_attention``, counted on ``kernels.paged_attention``."""
    q = _meta(8, 12, 1, 64)
    lengths = _meta(8, dtype=torch.int32)
    pool, pool8 = _meta(1024, 16, 12, 64), _meta(1024, 16, 12, 64,
                                                 dtype=torch.int8)
    sc = _meta(1024, 16, 12, dtype=torch.float32)
    for W in (1, 32, 128):
        table = _meta(8, W, dtype=torch.int32)
        assert ck.paged_pool_unsupported_reason(q, pool, pool, table,
                                                lengths) is None
        assert ck.paged_pool_unsupported_reason(q, pool8, pool8, table,
                                                lengths, sc, sc) is None
    table = _meta(8, 4, dtype=torch.int32)
    why = ck.paged_pool_unsupported_reason
    assert "int32" in why(q, pool, pool, table.long(), lengths)
    assert "pages" in why(q, pool8, pool8, table, lengths)
    assert "scale" in why(q, pool8, pool8, table, lengths, sc, None)
    assert "pools must be" in why(q, _meta(1024, 16, 6, 64), pool, table,
                                  lengths)
    assert "one query row" in why(_meta(8, 12, 2, 64), pool, pool, table,
                                  lengths)
    assert "bf16" in why(q.float(), pool, pool, table, lengths)
    with pytest.raises(mt.KernelUnsupportedError, match="CUDA"):
        ck.paged_attention_pool(q, pool, pool, table, lengths)
    # the export's per-width verdict is this check's
    from mxnet_tpu_torch.deploy import _paged_route
    spec = {"num_heads": 12, "head_dim": 64, "dtype": "bfloat16"}
    for W in (1, 32, 128):
        for quant in (False, True):
            assert _paged_route(spec, W, 16, 8, quant)["impl"] == "paged"
    (qn, kp, vp, _, _, tab, lens, _, _, _, _, _) = _pool_case("float32")
    args = (_t(qn), _t(kp), _t(vp), _t(tab), _t(lens))
    tt.reset()
    mt.config.set("kernels.enabled", True)
    try:
        with tk.record_paged_routes() as routes:
            on = tk.paged_attention_pool(*args)
            mt.config.set("kernels.enabled", False)
            off = tk.paged_attention_pool(*args)
    finally:
        mt.config.unset("kernels.enabled")
    assert [r["impl"] for r in routes] == ["paged", "plain"]
    assert tt.counter("kernels.paged_attention").value == 1
    assert torch.equal(on, off)


# -------------------------------------------------------- flash forward
@pytest.mark.parametrize("causal,sq,skv", [(True, 24, 24),
                                           (False, 8, 24),
                                           (False, 24, 8)],
                         ids=["causal", "noncausal-skv>sq",
                              "noncausal-skv<sq"])
def test_flash_plain_matches_pallas_forward(causal, sq, skv):
    rng = np.random.RandomState(3)
    B, H, D = 2, 3, 16
    q = rng.randn(B, H, sq, D).astype(np.float32)
    k = rng.randn(B, H, skv, D).astype(np.float32)
    v = rng.randn(B, H, skv, D).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    # block_q=8: several q blocks, so the causal offsets are exercised
    want_o = pk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=8)
    _, want_lse = pk._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, scale, 8)
    o, lse = ck.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=ATOL)


# ------------------------------------------------------- flash backward
# f32 inputs; the two sides sum the same products in different orders.
# Gradients reach ~3 here, so 4e-6 absolute is a few f32 ulps of the
# largest values.
BWD_ATOL = 4e-6


@pytest.mark.parametrize("D", [64, 16])
@pytest.mark.parametrize("causal,sq,skv", [(True, 64, 64), (False, 32, 96)],
                         ids=["causal-64", "noncausal-32x96"])
def test_flash_bwd_plain_matches_pallas_backward(causal, sq, skv, D):
    rng = np.random.RandomState(11)
    B, H = 2, 2
    q, do = (rng.randn(B, H, sq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, skv, D).astype(np.float32) for _ in range(2))
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    # both sides start from the reference forward's o and lse
    o, lse = pk._flash_forward(jq, jk, jv, causal, scale, 16)
    want = pk._flash_backward(jq, jk, jv, o, lse, jdo, causal, scale, 16)
    o_t, lse_t = _t(np.asarray(o)), _t(np.asarray(lse))
    before = dict(ck.LAUNCHES)
    got = ck.flash_attention_bwd(_t(q), _t(k), _t(v), o_t, lse_t, _t(do),
                                 causal=causal)
    assert ck.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=BWD_ATOL)


def test_flash_vjp_is_the_grad_fn_and_matches_plain():
    """Tier on, attention runs through the flash autograd Function (the
    reference's ``_flash_vjp``): its output carries that Function as its
    grad_fn, and on the CPU its gradients equal the plain lowering's
    within 1e-6 (f32, summation order only)."""
    rng = np.random.RandomState(5)
    base = [rng.randn(2, 2, 24, 16).astype(np.float32) for _ in range(4)]
    grads = {}
    for tier in (True, False):
        q, k, v = (_t(x.copy()).requires_grad_(True) for x in base[:3])
        mt.config.set("kernels.enabled", tier)
        try:
            out = tk.attention(q, k, v, causal=True)
        finally:
            mt.config.unset("kernels.enabled")
        if tier:
            assert type(out.grad_fn) is tk._FlashVJP._backward_cls
        else:
            assert type(out.grad_fn) is not tk._FlashVJP._backward_cls
        out.backward(_t(base[3]))
        grads[tier] = [x.grad.numpy() for x in (q, k, v)]
    for on, off in zip(grads[True], grads[False]):
        np.testing.assert_allclose(on, off, rtol=0, atol=1e-6)


# ------------------------------------------------------------ fused adam
def _bits(a):
    a = np.asarray(a, dtype=np.float32) if np.asarray(a).dtype != np.float32 \
        else np.asarray(a)
    return a.view(np.uint32)


def _adam_case(shape, seed=4):
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * 0.02).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    m = (rng.randn(*shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.randn(*shape)) * 0.01).astype(np.float32)
    return w, g, m, v


@pytest.mark.parametrize("t", [1, 3, 1000])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("shape", [(256, 64), (1000,), (37, 13)],
                         ids=["2d", "1d", "odd"])
def test_fused_adam_plain_bitwise_with_pallas(shape, wd, t):
    """The plain Adam epilogue equals the reference's Pallas kernel bit
    for bit on the master, m, v and the bf16 cast."""
    from mxnet_tpu_torch.optimizer.optimizer import _bias_corrected_lr
    w, g, m, v = _adam_case(shape)
    lr_t = float(_bias_corrected_lr(1e-3, 0.9, 0.999, t))
    lp, nw, (nm, nv) = pk.fused_adam_step(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        np.float32(lr_t), wd, 0.9, 0.999, 1e-8, out_dtype=jnp.bfloat16)
    before = dict(ck.LAUNCHES)
    tlp, tnw, (tnm, tnv) = ck.fused_adam_step(
        _t(w), _t(g), _t(m), _t(v), lr_t, wd, 0.9, 0.999, 1e-8,
        out_dtype=torch.bfloat16)
    assert ck.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    assert tlp.dtype == torch.bfloat16 and tnw.dtype == torch.float32
    for want, got in ((nw, tnw), (nm, tnm), (nv, tnv), (lp, tlp.float())):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("t", [1, 1000])
@pytest.mark.parametrize("shape", [(256, 64), (1000,), (37, 13)],
                         ids=["2d", "1d", "odd"])
def test_fused_adam_f32_out_plain_bitwise_with_pallas(shape, t):
    """The f32-out form (the symbolic Module's fused step): the plain
    version equals the reference's Pallas kernel with
    ``out_dtype=float32`` bit for bit, and its cast is the new master
    itself, not a second copy."""
    from mxnet_tpu_torch.optimizer.optimizer import _bias_corrected_lr
    w, g, m, v = _adam_case(shape)
    lr_t = float(_bias_corrected_lr(1e-3, 0.9, 0.999, t))
    lp, nw, (nm, nv) = pk.fused_adam_step(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        np.float32(lr_t), 0.01, 0.9, 0.999, 1e-8, out_dtype=jnp.float32)
    tlp, tnw, (tnm, tnv) = ck.fused_adam_step(
        _t(w), _t(g), _t(m), _t(v), lr_t, 0.01, 0.9, 0.999, 1e-8,
        out_dtype=torch.float32)
    assert tlp is tnw
    for want, got in ((lp, tlp), (nw, tnw), (nm, tnm), (nv, tnv)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # in place, as the Module step calls it: out=(w, w, m, v)
    tw, tm, tv = _t(w).clone(), _t(m).clone(), _t(v).clone()
    res = ck.fused_adam_step(tw, _t(g), tm, tv, lr_t, 0.01, 0.9, 0.999,
                             1e-8, out_dtype=torch.float32,
                             out=(tw, tw, tm, tv))
    assert res[0] is tw and res[1] is tw
    for want, got in ((nw, tw), (nm, tm), (nv, tv)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


#: (grad, cast) dtypes of MXNet's f16 multi_precision update and its mixes
F16_CASES = [("float16", "float16"), ("float32", "float16"),
             ("float16", "bfloat16"), ("float16", "float32")]


def _as(a, dtype):
    """A numpy f32 array as ``dtype`` on both sides: (jax array, torch
    tensor) holding the same values."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    t = _t(a).to(getattr(torch, dtype))
    return j, t


@pytest.mark.parametrize("grad_dtype,cast", F16_CASES,
                         ids=["-".join(c) for c in F16_CASES])
@pytest.mark.parametrize("t", [1, 1000])
@pytest.mark.parametrize("shape", [(256, 64), (37, 13)], ids=["2d", "odd"])
def test_fused_adam_f16_plain_bitwise_with_pallas(shape, t, grad_dtype,
                                                  cast):
    """f16 grads (widened exactly) and an f16 cast (rounded once): the
    plain Adam epilogue equals the reference's Pallas kernel in interpret
    mode bit for bit on the master, m, v and the cast."""
    from mxnet_tpu_torch.optimizer.optimizer import _bias_corrected_lr
    w, g, m, v = _adam_case(shape)
    jg, tg = _as(g, grad_dtype)
    lr_t = float(_bias_corrected_lr(1e-3, 0.9, 0.999, t))
    lp, nw, (nm, nv) = pk.fused_adam_step(
        jnp.asarray(w), jg, jnp.asarray(m), jnp.asarray(v),
        np.float32(lr_t), 0.01, 0.9, 0.999, 1e-8,
        out_dtype=getattr(jnp, cast))
    before = dict(ck.LAUNCHES)
    tlp, tnw, (tnm, tnv) = ck.fused_adam_step(
        _t(w), tg, _t(m), _t(v), lr_t, 0.01, 0.9, 0.999, 1e-8,
        out_dtype=getattr(torch, cast))
    assert ck.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    assert tlp.dtype == getattr(torch, cast)
    for want, got in ((nw, tnw), (nm, tnm), (nv, tnv), (lp, tlp.float())):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fused_adam_f32_out_checks():
    """The kernel's checks take an f32 cast, refuse a separate f32 cast
    tensor (the master is written once) and any cast but f32, bf16 and
    f16."""
    w = _meta(3, 5, dtype=torch.float32)
    assert ck.adam_unsupported_reason(w, w, w, w, torch.float32) is None
    assert ck.adam_unsupported_reason(w, w.bfloat16(), w, w,
                                      torch.float32) is None
    assert "f32, bf16 or f16" in ck.adam_unsupported_reason(w, w, w, w,
                                                            torch.float64)
    with pytest.raises(mt.KernelUnsupportedError, match="out\\[0\\]"):
        ck.fused_adam_step(w, w, w, w, 1e-3, 0.0, 0.9, 0.999, 1e-8,
                           out_dtype=torch.float32,
                           out=(torch.empty_like(w), w, w, w))


def test_fma_rounds_once():
    """``_fma`` rounds a*b + c once.  With a = 1 + 2^-23,
    b = 2^-24 (1 - 2^-23) and c = 1 + 2^-23 the exact value lies 2^-70
    below the f32 tie 1 + 2^-23 + 2^-24: rounded once it goes down to
    1 + 2^-23; a plain f64 sum rounds onto the tie first and then to the
    even neighbour 1 + 2^-22."""
    a = torch.tensor([1.0 + 2.0 ** -23], dtype=torch.float32)
    b = torch.tensor([2.0 ** -24 * (1.0 - 2.0 ** -23)], dtype=torch.float32)
    c = a.clone()
    assert float((a.double() * b.double() + c.double()).float()) == \
        1.0 + 2.0 ** -22
    assert float(ck._fma(a, b, c)) == 1.0 + 2.0 ** -23


def test_fused_adam_out_writes_in_place():
    """The ``out=`` form, given the inputs themselves, writes the same bits
    as the allocating form."""
    w, g, m, v = (_t(x) for x in _adam_case((9, 5)))
    res = ck.fused_adam_step(w, g, m, v, 1e-3, 0.01, 0.9, 0.999, 1e-8)
    out = (torch.empty(9, 5, dtype=torch.bfloat16), w.clone(), m.clone(),
           v.clone())
    ck.fused_adam_step(out[1], g, out[2], out[3], 1e-3, 0.01, 0.9, 0.999,
                       1e-8, out=out)
    for want, got in zip((res[0], res[1]) + res[2], out):
        assert torch.equal(want, got)


# -------------------------------------------------------- quantize_rows
def test_quantize_rows_bitwise():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5, 3, 16).astype(np.float32) * \
        rng.uniform(0.01, 10.0, (4, 5, 3, 1)).astype(np.float32)
    # exact half-way points after scaling (amax 127 -> scale 1) check
    # round-half-to-even on both sides; an all-zero row checks the floor
    x[0, 0, 0] = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 10)
    x[0, 0, 1] = 0.0
    jq, js = jax_quantize_rows(jnp.asarray(x))
    q, s = tq.quantize_rows(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_rows(q, s).numpy(),
        np.asarray(jax_dequantize_rows(jq, js)))


# -------------------------------------------------------------- routing
def _qkv(S=8, D=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 2, S, D, generator=g).to(dtype)
            for _ in range(3)]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_attention_routing_counts_and_matches_plain():
    q, k, v = _qkv()
    tt.reset()
    mt.config.set("kernels.enabled", True)
    try:
        on = tk.attention(q, k, v, causal=True)
        assert tt.counter("kernels.flash_attention").value == 1
        # a non-CPU tensor the kernel cannot take raises, naming why; it
        # never runs the plain version instead
        mq = _meta(1, 2, 8, 32)
        with pytest.raises(mt.KernelUnsupportedError, match="head dim 32"):
            tk.attention(mq, mq, mq, causal=True)
        mt.config.set("kernels.enabled", False)
        off = tk.attention(q, k, v, causal=True)
        assert tt.counter("kernels.flash_attention").value == 2
    finally:
        mt.config.unset("kernels.enabled")
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=0, atol=ATOL)


def test_paged_routing_records_routes():
    q, k, v, valid, _, _ = _paged_case()
    args = (_t(q), _t(k), _t(v), _t(valid))
    tt.reset()
    mt.config.set("kernels.enabled", True)
    try:
        with tk.record_paged_routes() as routes:
            tk.paged_attention(*args)
            # two query rows on a non-CPU tensor: not a decode call the
            # kernel takes, so it raises instead of running the plain path
            mq, mkv = _meta(3, 2, 2, 64), _meta(3, 2, 40, 64)
            with pytest.raises(mt.KernelUnsupportedError,
                               match="one query row"):
                tk.paged_attention(mq, mkv, mkv,
                                   _meta(3, 40, dtype=torch.bool))
            mt.config.set("kernels.enabled", False)
            tk.paged_attention(*args)
    finally:
        mt.config.unset("kernels.enabled")
    assert [r["impl"] for r in routes] == ["paged", "paged", "plain"]
    assert routes[2]["reason"] == "tier off"
    assert tt.counter("kernels.paged_attention").value == 2


def test_served_shapes_pass_the_kernel_checks():
    """Every shape the serving path gives the kernels (bf16, H=12, D=64;
    prefill buckets 8..2048; decode B=8, K=16..2048, bf16 and int8 pages)
    passes the kernels' own checks, so no served call raises."""
    for S in (8, 128, 2048):
        q = _meta(1, 12, S, 64)
        assert ck.flash_unsupported_reason(q, q, q, True) is None
    for K in (16, 512, 2048):
        q = _meta(8, 12, 1, 64)
        valid = _meta(8, K, dtype=torch.bool)
        kv8, sc = _meta(8, 12, K, 64, dtype=torch.int8), \
            _meta(8, 12, K, dtype=torch.float32)
        assert ck.paged_unsupported_reason(q, _meta(8, 12, K, 64),
                                           _meta(8, 12, K, 64),
                                           valid) is None
        assert ck.paged_unsupported_reason(q, kv8, kv8, valid, sc,
                                           sc) is None


def test_kernel_checks_reject_what_the_kernels_do_not_take():
    q = _meta(1, 2, 8, 64)
    f = q.float()
    h = q.half()
    assert "f32 or bf16" in ck.flash_unsupported_reason(h, h, h, False)
    assert "head dim" in ck.flash_unsupported_reason(
        q[..., :32], q[..., :32], q[..., :32], False)
    assert "causal" in ck.flash_unsupported_reason(q[:, :, :4], q, q, True)
    valid = _meta(1, 8, dtype=torch.bool)
    q1 = q[:, :, :1]
    assert "pages" in ck.paged_unsupported_reason(q1, f, f, valid)
    assert "pages" in ck.paged_unsupported_reason(
        q1, q, q, valid, _meta(1, 2, 8, dtype=torch.float32),
        _meta(1, 2, 8, dtype=torch.float32))
    assert "scale" in ck.paged_unsupported_reason(
        q1, q.to(torch.int8), q.to(torch.int8), valid,
        _meta(1, 2, 8, dtype=torch.float32), None)
    # each wrapper raises the typed error for a non-CPU tensor it cannot
    # take: a bf16 shape it takes, but not on a CUDA device; an f16 query
    # (the kernel takes bf16 and f32 ones)
    with pytest.raises(mt.KernelUnsupportedError, match="CUDA"):
        ck.flash_attention(q, q, q, causal=True)
    with pytest.raises(mt.KernelUnsupportedError, match="bf16"):
        ck.paged_attention(h[:, :, :1], h, h, valid)


def test_training_shapes_pass_the_kernel_checks():
    """Every call the full-width training step makes (B=4, H=12, S=2048,
    D=64 bf16 attention; the 9 parameter tensors' Adam updates with a bf16
    grad) passes the kernels' own checks."""
    q = _meta(4, 12, 2048, 64)
    lse = _meta(48, 2048, dtype=torch.float32)
    assert ck.flash_unsupported_reason(q, q, q, True) is None
    assert ck.flash_bwd_unsupported_reason(q, q, q, q, lse, q, True) is None
    L, D, H, Dh, F, V, S = 12, 768, 12, 64, 3072, 32000, 2048
    for shape in [(V, D), (S, D), (D,), (L, D), (L, D, 3, H, Dh),
                  (L, H, Dh, D), (L, D), (L, D, F), (L, F, D)]:
        w = _meta(*shape, dtype=torch.float32)
        assert ck.adam_unsupported_reason(
            w, _meta(*shape), w, w, torch.bfloat16) is None


@pytest.mark.parametrize("B,causal,sq,skv", [
    (1, True, 1000, 1000),    # ragged causal: 1000 = 15 x 64 + 40
    (1, False, 200, 1000),    # ragged, Sq != Skv, no mask
    (8, False, 128, 128),     # BERT-base: B=8, H=12, S=128, no mask
], ids=["ragged-causal", "ragged-noncausal", "bert-base"])
def test_backward_checks_take_the_ragged_and_bert_shapes(B, causal, sq, skv):
    """The shapes chip_smoke.py's backward checks add pass the backward
    kernels' own check: ragged tiles are masked in the kernels, not
    refused."""
    q = _meta(B, 12, sq, 64)
    kv = _meta(B, 12, skv, 64)
    lse = _meta(B * 12, sq, dtype=torch.float32)
    assert ck.flash_unsupported_reason(q, kv, kv, causal) is None
    assert ck.flash_bwd_unsupported_reason(q, kv, kv, q, lse, q,
                                           causal) is None


@pytest.mark.parametrize("shape_q,shape_kv,causal,match", [
    ((1, 2, 8, 32), (1, 2, 8, 32), False, "head dim 32"),
    ((1, 2, 8, 64), (1, 2, 16, 64), True, "causal needs Sq == Skv"),
    ((2, 32768, 1, 64), (2, 32768, 1, 64), False, "65535"),
    ((1, 2, 0, 64), (1, 2, 0, 64), False, "empty"),
    ((0, 2, 8, 64), (0, 2, 8, 64), False, "empty"),
], ids=["head-dim", "causal-ragged", "bh", "empty-s", "empty-b"])
def test_backward_wrapper_rejects_what_bad_dims_rejects(shape_q, shape_kv,
                                                        causal, match):
    """Every call ``bad_dims`` in ``csrc/flash_bwd.cu`` refuses is refused
    by the wrapper first, by name, before any launch."""
    q, kv = _meta(*shape_q), _meta(*shape_kv)
    lse = _meta(shape_q[0] * shape_q[1], shape_q[2], dtype=torch.float32)
    assert match in ck.flash_bwd_unsupported_reason(q, kv, kv, q, lse, q,
                                                    causal)
    with pytest.raises(mt.KernelUnsupportedError, match=match):
        ck.flash_attention_bwd(q, kv, kv, q, lse, q, causal=causal)


@pytest.mark.parametrize("B,H,causal,sq,skv", [
    (4, 8, True, 1024, 1024),   # the f32 TransformerLM's train row
    (1, 8, True, 1000, 1000),   # ragged causal
    (1, 8, False, 200, 1000),   # ragged, Sq != Skv, no mask
], ids=["train-row", "ragged-causal", "ragged-noncausal"])
def test_f32_flash_checks_take_head_dim_32(B, H, causal, sq, skv):
    """f32 at head dim 32 (bench.py transformer_kernels_config's f32
    TransformerLM: 8 heads of 32) passes the forward's and the
    backward's checks at chip_smoke.py's F32_D32_CASES shapes."""
    q = _meta(B, H, sq, 32, dtype=torch.float32)
    kv = _meta(B, H, skv, 32, dtype=torch.float32)
    lse = _meta(B * H, sq, dtype=torch.float32)
    assert ck.flash_unsupported_reason(q, kv, kv, causal) is None
    assert ck.flash_bwd_unsupported_reason(q, kv, kv, q, lse, q,
                                           causal) is None


@pytest.mark.parametrize("dtype,D,dims", [
    (torch.bfloat16, 32, "64"), (torch.float32, 48, "16/32/64"),
    (torch.float32, 128, "16/32/64")], ids=["bf16-32", "f32-48", "f32-128"])
def test_flash_checks_refuse_head_dims_not_built(dtype, D, dims):
    """A head dim the flash kernels are not built for in this dtype is
    refused by both checks, which name the dims that are, and both
    wrappers raise on it (no fallback)."""
    q = _meta(1, 2, 8, D, dtype=dtype)
    lse = _meta(2, 8, dtype=torch.float32)
    want = "head dim %d not in %s" % (D, dims)
    assert want in ck.flash_unsupported_reason(q, q, q, False)
    assert want in ck.flash_bwd_unsupported_reason(q, q, q, q, lse, q,
                                                   False)
    with pytest.raises(mt.KernelUnsupportedError, match=want):
        ck.flash_attention(q, q, q)
    with pytest.raises(mt.KernelUnsupportedError, match=want):
        ck.flash_attention_bwd(q, q, q, q, lse, q)


def test_backward_and_adam_checks_reject_what_the_kernels_do_not_take():
    q = _meta(1, 2, 8, 64)
    lse = _meta(2, 8, dtype=torch.float32)
    f = q.float()
    h = q.half()
    assert "f32 or bf16" in ck.flash_bwd_unsupported_reason(h, h, h, h, lse,
                                                            h, False)
    assert "o/dO" in ck.flash_bwd_unsupported_reason(q, q, q, q[:, :, :4],
                                                     lse, q, False)
    assert "lse" in ck.flash_bwd_unsupported_reason(q, q, q, q, lse.double(),
                                                    q, False)
    w = _meta(3, 5, dtype=torch.float32)
    assert "shapes" in ck.adam_unsupported_reason(w, w[:2], w, w,
                                                  torch.bfloat16)
    assert "f32" in ck.adam_unsupported_reason(w.half(), w, w, w,
                                               torch.bfloat16)
    assert "grad" in ck.adam_unsupported_reason(w, w.double(), w, w,
                                                torch.bfloat16)
    assert "f16" in ck.adam_unsupported_reason(w, w, w, w, torch.float64)
    # a non-CPU tensor the kernel cannot take raises the typed error
    with pytest.raises(mt.KernelUnsupportedError, match="backward"):
        ck.flash_attention_bwd(f, f, f, f, lse, f)
    with pytest.raises(mt.KernelUnsupportedError, match="CUDA"):
        ck.flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(mt.KernelUnsupportedError, match="adam"):
        ck.fused_adam_step(w, w, w, w, 1e-3, 0.0, 0.9, 0.999, 1e-8,
                           out_dtype=torch.float32)
    with pytest.raises(mt.KernelUnsupportedError, match="CUDA"):
        ck.fused_adam_step(w, w, w, w, 1e-3, 0.0, 0.9, 0.999, 1e-8)


# ------------------------------------------------------------ sgd (K1)
def _sgd_case(shape, seed=6):
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    m = (rng.randn(*shape) * 0.1).astype(np.float32)
    return w, g, m


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("shape", [(33, 7), (50,), (256, 64)],
                         ids=["odd", "1d", "2d"])
def test_fused_sgd_plain_bitwise_with_pallas(shape, momentum, out_dtype):
    """The plain SGD epilogue equals the reference's Pallas kernel
    (interpret mode) bit for bit on the master, the momentum and the
    cast, with wd != 0.  Bitwise, because both contract the same two
    multiply-adds: fma(wd, w, g), then fma(momentum, m, lr*g') or, without
    momentum, fma(-lr, g', w)."""
    w, g, m = _sgd_case(shape)
    lr, wd = 0.1, 1e-4
    lp, nw, nm = pk.fused_sgd_step(
        jnp.asarray(w), jnp.asarray(g),
        jnp.asarray(m) if momentum else None, lr, wd, momentum,
        out_dtype=getattr(jnp, out_dtype))
    before = dict(ck.LAUNCHES)
    tlp, tnw, tnm = ck.fused_sgd_step(
        _t(w), _t(g), _t(m) if momentum else None, lr, wd, momentum,
        out_dtype=getattr(torch, out_dtype))
    assert ck.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    assert tlp.dtype == getattr(torch, out_dtype)
    pairs = [(nw, tnw), (lp, tlp.float())]
    if momentum:
        pairs.append((nm, tnm))
    else:
        assert nm is None and tnm is None
    for want, got in pairs:
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("grad_dtype,cast", F16_CASES,
                         ids=["-".join(c) for c in F16_CASES])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("shape", [(33, 7), (256, 64)], ids=["odd", "2d"])
def test_fused_sgd_f16_plain_bitwise_with_pallas(shape, momentum, grad_dtype,
                                                 cast):
    """f16 grads and an f16 cast: the plain SGD epilogue equals the
    reference's Pallas kernel (interpret mode) bit for bit on the master,
    the momentum and the cast."""
    w, g, m = _sgd_case(shape)
    jg, tg = _as(g, grad_dtype)
    lp, nw, nm = pk.fused_sgd_step(
        jnp.asarray(w), jg, jnp.asarray(m) if momentum else None, 0.1,
        1e-4, momentum, out_dtype=getattr(jnp, cast))
    tlp, tnw, tnm = ck.fused_sgd_step(
        _t(w), tg, _t(m) if momentum else None, 0.1, 1e-4, momentum,
        out_dtype=getattr(torch, cast))
    assert tlp.dtype == getattr(torch, cast)
    pairs = [(nw, tnw), (lp, tlp.float())] + (
        [(nm, tnm)] if momentum else [])
    for want, got in pairs:
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("grad_dtype,cast", F16_CASES,
                         ids=["-".join(c) for c in F16_CASES])
def test_optimizer_checks_take_f16(grad_dtype, cast):
    """K1's and K3's checks take an f16 grad and an f16 cast (on ``meta``
    tensors: shapes and dtypes only)."""
    w = _meta(3, 5, dtype=torch.float32)
    g = _meta(3, 5, dtype=getattr(torch, grad_dtype))
    out = _meta(3, 5, dtype=getattr(torch, cast))
    assert ck.adam_unsupported_reason(w, g, w, w, out.dtype) is None
    assert ck.sgd_unsupported_reason(w, g, w, 0.9, out=out) is None
    assert ck.sgd_unsupported_reason(w, g, None, 0.0, out=out) is None


def test_fused_sgd_multi_equals_per_tensor_calls():
    """The multi-tensor form, over a list with per-tensor lr and wd and a
    mix of casts (none, f32, bf16), writes in place exactly the bits that
    one call per tensor returns."""
    shapes = [(33, 7), (50,), (4, 3, 3, 3), (1,)]
    lrs, wds = [0.1, 0.05, 0.2, 0.1], [1e-4, 0.0, 1e-3, 1e-4]
    cases = [_sgd_case(s, seed=i) for i, s in enumerate(shapes)]
    ws = [_t(w).clone() for w, _, _ in cases]
    gs = [_t(g) for _, g, _ in cases]
    ms = [_t(m).clone() for _, _, m in cases]
    outs = [None, torch.empty(shapes[1]),
            torch.empty(shapes[2], dtype=torch.bfloat16), None]
    want = [ck.fused_sgd_step(_t(w), _t(g), _t(m), lr, wd, 0.9,
                              out_dtype=torch.bfloat16 if o is not None and
                              o.dtype == torch.bfloat16 else torch.float32)
            for (w, g, m), lr, wd, o in zip(cases, lrs, wds, outs)]
    ck.fused_sgd_step_multi(ws, gs, ms, lrs, wds, 0.9, outs=outs)
    for (lp, nw, nm), w, m, o in zip(want, ws, ms, outs):
        assert torch.equal(w, nw) and torch.equal(m, nm)
        if o is not None:
            assert torch.equal(o, lp)


def test_sgd_checks_reject_what_the_kernel_does_not_take():
    w = _meta(3, 5, dtype=torch.float32)
    assert ck.sgd_unsupported_reason(w, w, w, 0.9) is None
    assert ck.sgd_unsupported_reason(w, _meta(3, 5), None, 0.0) is None
    assert "grad shape" in ck.sgd_unsupported_reason(w, w[:2], w, 0.9)
    assert "master" in ck.sgd_unsupported_reason(w.half(), w, w, 0.9)
    assert "grad must" in ck.sgd_unsupported_reason(w, w.double(), w, 0.9)
    assert "momentum" in ck.sgd_unsupported_reason(w, w, None, 0.9)
    assert "momentum" in ck.sgd_unsupported_reason(w, w, w.half(), 0.9)
    assert "out" in ck.sgd_unsupported_reason(w, w, w, 0.9, out=w.double())
    with pytest.raises(mt.KernelUnsupportedError, match="sgd.*f32"):
        ck.fused_sgd_step_multi([w.half()], [w], [w], [0.1], [0.0], 0.9)
    # a tensor off the CPU the kernel cannot reach raises, naming why
    with pytest.raises(mt.KernelUnsupportedError, match="sgd.*CUDA"):
        ck.fused_sgd_step_multi([w], [w], [w], [0.1], [0.0], 0.9)
    with pytest.raises(ValueError, match="one grad"):
        ck.fused_sgd_step_multi([w], [], [w], [0.1], [0.0], 0.9)


def test_resnet50_shapes_pass_the_sgd_check():
    """Every trainable tensor of the port's resnet50_v1 (193 tensors,
    25,575,912 parameters, shapes from the model after shape inference)
    passes K1's check as the trainer hands it over: f32 master, f32 grad,
    f32 momentum, no cast; and the launch table it needs fits one grid."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.get_model("resnet50_v1", classes=1000)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    net(mt.nd.array(np.zeros((1, 3, 32, 32), np.float32), ctx=mt.cpu()))
    shapes = [p.shape for p in net.collect_params().values()
              if p.grad_req != "null"]
    assert len(shapes) == 193
    assert sum(int(np.prod(s)) for s in shapes) == 25575912
    blocks = 0
    for s in shapes:
        w = _meta(*s, dtype=torch.float32)
        assert ck.sgd_unsupported_reason(w, w, w, 0.9) is None
        blocks += -(-w.numel() // ck.SGD_CHUNK)
    assert blocks < 2 ** 31


# ----------------------------------------------------- build and sources
def test_kernel_sources_and_build_dir_is_ignored():
    csrc = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")
    for src in _build.SOURCES.values():
        text = open(os.path.join(csrc, src)).read()
        assert "sm_90a" in text and "Replaces:" in text
        assert "__global__" in text and 'extern "C"' in text
    assert "arch=compute_90a,code=sm_90a" in _build._FLAGS
    bdir = _build.build_dir()
    assert os.path.commonpath([bdir, ROOT]) == ROOT
    probe = os.path.join(os.path.relpath(bdir, ROOT), "libx.so")
    res = subprocess.run(["git", "check-ignore", "-q", probe], cwd=ROOT)
    assert res.returncode == 0, "%s is not git-ignored" % probe


# ------------------------------------------------------ import isolation
def test_import_does_not_load_jax():
    code = ("import sys; import mxnet_tpu_torch; "
            "import mxnet_tpu_torch.optimizer; "
            "import mxnet_tpu_torch.gluon; "
            "import mxnet_tpu_torch.gluon.model_zoo.vision; "
            "import mxnet_tpu_torch.parallel.trainer; "
            "import mxnet_tpu_torch._tape, mxnet_tpu_torch.kvstore; "
            "import mxnet_tpu_torch.metric, mxnet_tpu_torch.io; "
            "import mxnet_tpu_torch.callback, mxnet_tpu_torch.lr_scheduler; "
            "import mxnet_tpu_torch.gluon.trainer; "
            "import mxnet_tpu_torch.ops.kernel_ops; "
            "import mxnet_tpu_torch.rtc, mxnet_tpu_torch.ops._cudart; "
            "import mxnet_tpu_torch.symbol, mxnet_tpu_torch.module; "
            "import mxnet_tpu_torch.model, mxnet_tpu_torch.engine; "
            "import mxnet_tpu_torch.executor; "
            "import mxnet_tpu_torch.executor_manager; "
            "import mxnet_tpu_torch.recordio, mxnet_tpu_torch.image; "
            "import mxnet_tpu_torch.compat, mxnet_tpu_torch.resilience; "
            "import mxnet_tpu_torch.elastic; "
            "import mxnet_tpu_torch.gluon.data.vision.transforms; "
            "import mxnet_tpu_torch.gluon.contrib.data; "
            "import mxnet_tpu_torch.module.sequential_module; "
            "import mxnet_tpu_torch.module.python_module; "
            "import mxnet_tpu_torch.models.ssd; "
            "import mxnet_tpu_torch.image.detection; "
            "import mxnet_tpu_torch.symbol.contrib; "
            "import mxnet_tpu_torch.gluon.contrib.cnn; "
            "import mxnet_tpu_torch.launch, mxnet_tpu_torch.kvstore_server; "
            "import mxnet_tpu_torch.parallel.dist; "
            "import mxnet_tpu_torch.parallel.embedding; "
            "import mxnet_tpu_torch.parallel.compression; "
            "import mxnet_tpu_torch.parallel.collectives; "
            "import mxnet_tpu_torch.parallel.pipeline; "
            "import mxnet_tpu_torch.parallel.moe; "
            "import mxnet_tpu_torch.models.bert; "
            "import mxnet_tpu_torch.attribute; "
            "import mxnet_tpu_torch.gluon.contrib.nn.basic_layers; "
            "import mxnet_tpu_torch.telemetry, mxnet_tpu_torch.tracing; "
            "import mxnet_tpu_torch.profiler, mxnet_tpu_torch.numerics; "
            "import mxnet_tpu_torch.monitor, mxnet_tpu_torch.trace_merge; "
            "import mxnet_tpu_torch.perf, mxnet_tpu_torch.autotune; "
            "import mxnet_tpu_torch.obs; "
            "assert 'mxnet_tpu_torch.ops.contrib' in sys.modules; "
            "assert 'mxnet_tpu_torch.ops.contrib_extra' in sys.modules; "
            "assert 'mxnet_tpu_torch.gluon.data.dataloader' in sys.modules; "
            "assert 'mxnet_tpu_torch.image.image' in sys.modules; "
            "assert 'mxnet_tpu_torch.optimizer.optimizer' in sys.modules; "
            "assert 'mxnet_tpu_torch.symbol.symbol' in sys.modules; "
            "assert 'mxnet_tpu_torch.module.module' in sys.modules; "
            "assert 'mxnet_tpu_torch.gluon.trainer' in sys.modules; "
            "assert 'mxnet_tpu_torch.ops.kernel_ops' in sys.modules; "
            "assert 'mxnet_tpu_torch.gluon.nn.conv_layers' in sys.modules; "
            "assert 'mxnet_tpu_torch.parallel.trainer' in sys.modules; "
            "assert 'mxnet_tpu_torch.parallel.mesh' in sys.modules; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mxnet_tpu' "
            "or m.startswith('mxnet_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("top", ["mxnet_tpu_torch", "chip_smoke.py"])
def test_port_sources_import_neither_jax_nor_reference(top):
    path = os.path.join(ROOT, top)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path)
        for f in fs if f.endswith(".py")]
    assert files
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "mxnet_tpu"), (f, name)
