"""NaN propagation of the attention and softmax kernels' plain versions
against the reference's Pallas kernels (interpret mode), on the same NaN
inputs made by numpy from a seed.

The reference reduces with ``jnp.max``/``jnp.sum``, which keep NaN, and
the plain versions with ``torch.amax``: a NaN in q, k, v or dO reaches
the same outputs in both.  These are the semantics the CUDA kernels keep
on the card (``chip_smoke.py`` ``check_nan`` holds each kernel against
its plain version there).  NaN positions must be equal; the finite values
within 1e-6 (f32, the two sides sum in different orders).  The NaNs sit
where every version's masking agrees: the last query row (it attends
every key under the causal mask), key 0 (every row attends it) and the
last row of dO.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.ops import cuda_kernels as ck

ATOL = 1e-6
# one interpret-mode compile a signature, shared by the cases
_FWD = jax.jit(pk._flash_forward, static_argnums=(3, 4, 5))
_BWD = jax.jit(pk._flash_backward, static_argnums=(6, 7, 8))
_SM_FWD = jax.jit(pk._softmax_fwd_call)
_SM_BWD = jax.jit(pk._softmax_bwd_call)
B, H, S, D = 1, 2, 32, 16
PLANTS = {"q": (0, 1, S - 1, 5), "k": (0, 0, 0, 7), "v": (0, 1, 0, 3),
          "do": (0, 0, S - 1, 9)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ATOL)


def _flash_inputs(plant, seed=3):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, S, D).astype(np.float32)
                   for _ in range(4))
    if plant is not None:
        {"q": q, "k": k, "v": v, "do": do}[plant][PLANTS[plant]] = np.nan
    return q, k, v, do


@pytest.mark.parametrize("plant,causal", [
    ("q", True), ("k", True), ("v", True), ("do", True), ("k", False)],
    ids=["q-causal", "k-causal", "v-causal", "do-causal", "k-full"])
def test_flash_nan_positions_match_pallas(plant, causal):
    """Forward (o, lse) and backward (dq, dk, dv) with one NaN planted."""
    q, k, v, do = _flash_inputs(plant)
    scale = 1.0 / math.sqrt(D)
    jo, jlse = _FWD(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                    scale, S)
    o, lse = ck.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    _same(o.numpy(), jo)
    _same(lse.numpy(), jlse)
    if plant in ("q", "k", "v"):
        assert np.isnan(np.asarray(jo)).any()
    want = _BWD(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jlse,
                jnp.asarray(do), causal, scale, S)
    got = ck.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), _t(np.asarray(jo)), _t(np.asarray(jlse)),
        _t(do), causal=causal)
    for g, w in zip(got, want):
        _same(g.numpy(), w)
    assert any(np.isnan(np.asarray(w)).any() for w in want)


def _paged_inputs(quant, seed=5, Bp=3, K=24):
    rng = np.random.RandomState(seed)
    q = rng.randn(Bp, H, 1, D).astype(np.float32)
    lens = np.asarray([K, 9, 1])
    if quant:
        k = rng.randint(-127, 128, (Bp, H, K, D)).astype(np.int8)
        v = rng.randint(-127, 128, (Bp, H, K, D)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, (Bp, H, K)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (Bp, H, K)).astype(np.float32)
    else:
        k = rng.randn(Bp, H, K, D).astype(np.float32)
        v = rng.randn(Bp, H, K, D).astype(np.float32)
        ks = vs = None
    return q, k, v, lens, ks, vs


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("plant", ["q", "k", "v", "empty"])
def test_paged_nan_positions_match_pallas(quant, plant):
    """A NaN in the query, in a valid key's K or V (its f32 scale for int8
    pages), or a row with no valid key at all (every slot pinned to the
    -1e30 floor: the mean of V over the row's slots in both)."""
    q, k, v, lens, ks, vs = _paged_inputs(quant)
    K = k.shape[2]
    if plant == "empty":
        lens = lens.copy()
        lens[1] = 0
    valid = np.arange(K)[None, :] < lens[:, None]
    if plant == "q":
        q[1, 1, 0, 4] = np.nan
    elif plant in ("k", "v"):
        if quant:
            (ks if plant == "k" else vs)[0, 1, 2] = np.nan
        else:
            (k if plant == "k" else v)[0, 1, 2, 6] = np.nan
    want = pk.pallas_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    got = ck.paged_attention_plain(
        _t(q), _t(k), _t(v), _t(valid),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    _same(got.numpy(), want)
    if plant != "empty":
        assert np.isnan(np.asarray(want)).any()


def test_paged_pool_form_keeps_nan_and_the_empty_row():
    """The pool form's plain version: a NaN key in sequence 0 and a
    sequence of length 0, against the gathered form (the Pallas kernel's
    semantics, above) on the same context."""
    rng = np.random.RandomState(11)
    P, psz, W = 9, 4, 3
    kp = rng.randn(P, psz, H, D).astype(np.float32)
    vp = rng.randn(P, psz, H, D).astype(np.float32)
    table = np.asarray([[2, 5, 7], [1, P, P], [0, 3, P]], np.int32)
    lens = np.asarray([10, 0, 6], np.int32)
    kp[2, 1, 0, 3] = np.nan
    q = rng.randn(3, H, 1, D).astype(np.float32)
    got = ck.paged_attention_pool_plain(_t(q), _t(kp), _t(vp), _t(table),
                                        _t(lens))
    kc = ck.gather_pages(_t(kp), _t(table))
    vc = ck.gather_pages(_t(vp), _t(table))
    valid = np.arange(W * psz)[None, :] < lens[:, None]
    want = pk.pallas_paged_attention(
        jnp.asarray(q), jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()),
        jnp.asarray(valid))
    _same(got.numpy(), want)
    assert np.isnan(got[0, 0].numpy()).all()
    assert np.isfinite(got[1].numpy()).all()


@pytest.mark.parametrize("plant", ["x", "dy"])
def test_row_softmax_nan_positions_match_pallas(plant):
    """K5's forward (y, m, l) with a NaN in x, and its backward with a NaN
    in x or dy."""
    rng = np.random.RandomState(7)
    x = (rng.randn(8, 40) * 4).astype(np.float32)
    dy = rng.randn(8, 40).astype(np.float32)
    if plant == "x":
        x[3, 17] = np.nan
    else:
        dy[5, 30] = np.nan
    jy, jm, jl = _SM_FWD(jnp.asarray(x))
    y, m, l = ck.row_softmax_plain(_t(x))
    for g, w in zip((y, m, l), (jy, jm, jl)):
        _same(g.numpy(), w)
    jdx = _SM_BWD(jnp.asarray(x), jm, jl, jnp.asarray(dy))
    dx = ck.row_softmax_bwd_plain(_t(x), _t(np.asarray(jm)),
                                  _t(np.asarray(jl)), _t(dy))
    _same(dx.numpy(), jdx)
    row = 3 if plant == "x" else 5
    assert np.isnan(np.asarray(jdx)[row]).all()
