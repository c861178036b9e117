"""The error model of the f32 flash kernels (``csrc/flash_f32.cu``) on the
CPU.

The forward and the two backward kernels multiply on the tensor cores as
3xTF32: each f32 operand ``x`` is split into ``big = tf32(x)`` and
``small = tf32(x - big)``, rounded as ``cvt.rna.tf32.f32`` rounds (to
nearest, ties away from zero; inf and nan pass through), and a product is
``small*big + big*small + big*big`` accumulated in f32.  Here that
arithmetic is emulated in plain torch (a product of two TF32 values is
exact in f32), the kernels' arithmetic runs with it in
``cuda_kernels.flash_attention_plain``'s and
``flash_attention_bwd_plain``'s own op order (their ``torch.matmul``
replaced), and o, dq, dk and dv are held to
``chip_smoke.F32_ROW_REL_TOL`` (2^-12) of each row's absolute sum against
the full-f32 plain version, by ``chip_smoke._abs_row_err``, the measure
the card's check uses.  Single TF32 products must miss that limit: the
limit is what shows on the card that the split happens.

Inputs: B=1, H=2, head dim 64 or 32 (the two the f32 kernels are built
for), seeded numpy normals; one causal S=256 and one non-causal
Sq=64 x Skv=192.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import cuda_kernels as ck

_SMOKE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

_MATMUL = torch.matmul
_LOW13 = ~0x1FFF  # clears the 13 mantissa bits TF32 drops


def tf32_rna(x):
    """f32 -> the f32 reading of ``cvt.rna.tf32.f32``: the 13 low mantissa
    bits rounded off to nearest, ties away from zero (adding half of the
    dropped ulp to the sign-magnitude bits carries into the kept ones),
    inf and nan unchanged; past the largest TF32 value it rounds to inf."""
    u = x.contiguous().view(torch.int32)
    finite = (u & 0x7F800000) != 0x7F800000
    return torch.where(finite, (u + 0x1000) & _LOW13, u).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_3xtf32(a, b):
    ab, as_ = split(a)
    bb, bs = split(b)
    return _MATMUL(as_, bb) + _MATMUL(ab, bs) + _MATMUL(ab, bb)


def mm_tf32(a, b):
    return _MATMUL(tf32_rna(a), tf32_rna(b))


def _bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("word,want", [
    (0x3F801000, 0x3F802000),   # 1 + 2^-11, a tie: away from zero
    (0xBF801000, 0xBF802000),   # its negative: away from zero too
    (0x3F800FFF, 0x3F800000),   # just below the tie: down
    (0x3F803000, 0x3F804000),   # a tie above an odd kept bit: up
    (0x3F7FF000, 0x3F800000),   # a tie that carries into the exponent
    (0x7F7FE000, 0x7F7FE000),   # the largest TF32 value: kept
    (0x7F7FFFFF, 0x7F800000),   # the largest f32: rounds past it to inf
    (0xFF7FFFFF, 0xFF800000),   # and its negative to -inf
    (0x00000001, 0x00000000),   # the least denormal: to zero
    (0x00001000, 0x00002000),   # a denormal tie: away from zero
    (0x80001000, 0x80002000),   # a negative denormal tie
    (0x007FF000, 0x00800000),   # the top denormal tie: the least normal
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0
    (0x7F800000, 0x7F800000),   # inf
    (0xFF800000, 0xFF800000),   # -inf
    (0x7FC00000, 0x7FC00000),   # quiet nan
    (0x7F800001, 0x7F800001),   # nan with a payload in the dropped bits
], ids=lambda w: "%08x" % w)
def test_tf32_rna_edge_values(word, want):
    got = tf32_rna(_bits(word).view(torch.float32)).view(torch.int32)
    assert int(got) == int(_bits(want)), "%08x" % (int(got) & 0xFFFFFFFF)


def test_split_leaves_at_most_2_to_minus_22():
    """big + small is x to within the rounding of small: 2^-11 of
    |x - big| <= 2^-11 |x|, so 2^-22 |x|; both parts are TF32 values."""
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        100_000).astype(np.float32) * np.float32(1e3))
    big, small = split(x)
    for part in (big, small):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    resid = (x.double() - big.double() - small.double()).abs()
    assert float((resid / x.double().abs()).max()) <= 2.0 ** -22


def _case(B, causal, sq, skv, seed=0, D=64):
    rng = np.random.RandomState(seed)
    H = 2
    q, do = (torch.from_numpy(rng.standard_normal((B, H, sq, D)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, H, skv, D)).astype(
        np.float32)) for _ in range(2))
    o, lse = ck.flash_attention_plain(q, k, v, causal=causal)
    delta = ck.flash_delta(o, do)
    want = ck.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        delta=delta)
    sums = chip_smoke._bwd_abs_sums(torch, q, k, v, do, lse, delta, causal)
    return (q, k, v, o, lse, do, delta), want, sums


def _errors(monkeypatch, mm, B, causal, sq, skv, D=64):
    """Per-row error of dq, dk and dv against each row's absolute sum,
    with every product of the plain backward taken by ``mm``."""
    (q, k, v, o, lse, do, delta), want, sums = _case(B, causal, sq, skv,
                                                     D=D)
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", mm)
        got = ck.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                           causal=causal, delta=delta)
    for x in got:
        assert bool(torch.isfinite(x).all())
    return [chip_smoke._abs_row_err(torch, x, w, s)
            for x, w, s in zip(got, want, sums)]


_SHAPES = pytest.mark.parametrize("B,causal,sq,skv", [
    (1, True, 256, 256), (1, False, 64, 192)],
    ids=["causal-256", "noncausal-64x192"])


@_SHAPES
def test_3xtf32_backward_within_the_f32_limit(monkeypatch, B, causal, sq,
                                              skv):
    errs = _errors(monkeypatch, mm_3xtf32, B, causal, sq, skv)
    assert max(errs) <= chip_smoke.F32_ROW_REL_TOL, errs


@_SHAPES
def test_single_tf32_backward_misses_the_f32_limit(monkeypatch, B, causal,
                                                   sq, skv):
    errs = _errors(monkeypatch, mm_tf32, B, causal, sq, skv)
    assert min(errs) > chip_smoke.F32_ROW_REL_TOL, errs


@_SHAPES
def test_3xtf32_backward_within_the_f32_limit_at_head_dim_32(
        monkeypatch, B, causal, sq, skv):
    errs = _errors(monkeypatch, mm_3xtf32, B, causal, sq, skv, D=32)
    assert max(errs) <= chip_smoke.F32_ROW_REL_TOL, errs


@_SHAPES
def test_single_tf32_backward_misses_the_f32_limit_at_head_dim_32(
        monkeypatch, B, causal, sq, skv):
    errs = _errors(monkeypatch, mm_tf32, B, causal, sq, skv, D=32)
    assert min(errs) > chip_smoke.F32_ROW_REL_TOL, errs


def _forward_error(monkeypatch, mm, B, causal, sq, skv, D):
    """Per-row error of the forward's o against each row's absolute sum
    (the plain forward over |v|), with both products of the plain forward
    (q k^T and p v) taken by ``mm``; lse within chip_smoke.LSE_ATOL."""
    (q, k, v, *_), _, _ = _case(B, causal, sq, skv, D=D)
    want, want_lse = ck.flash_attention_plain(q, k, v, causal=causal)
    sums = ck.flash_attention_plain(q, k, v.abs(), causal=causal)[0]
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", mm)
        got, lse = ck.flash_attention_plain(q, k, v, causal=causal)
    assert bool(torch.isfinite(got).all())
    assert float((lse - want_lse).abs().max()) <= chip_smoke.LSE_ATOL
    return chip_smoke._abs_row_err(torch, got, want, sums)


_FWD = pytest.mark.parametrize("B,causal,sq,skv,D", [
    (1, True, 256, 256, 64), (1, False, 64, 192, 64),
    (1, True, 256, 256, 32), (1, False, 64, 192, 32)],
    ids=["causal-256-d64", "noncausal-64x192-d64", "causal-256-d32",
         "noncausal-64x192-d32"])


@_FWD
def test_3xtf32_forward_within_the_f32_limit(monkeypatch, B, causal, sq,
                                             skv, D):
    err = _forward_error(monkeypatch, mm_3xtf32, B, causal, sq, skv, D)
    assert err <= chip_smoke.F32_ROW_REL_TOL, err


@_FWD
def test_single_tf32_forward_misses_the_f32_limit(monkeypatch, B, causal,
                                                  sq, skv, D):
    err = _forward_error(monkeypatch, mm_tf32, B, causal, sq, skv, D)
    assert err > chip_smoke.F32_ROW_REL_TOL, err
