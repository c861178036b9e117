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
    assert "bf16" in ck.flash_unsupported_reason(f, f, f, False)
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
    # take: a bf16 shape it takes, but not on a CUDA device
    with pytest.raises(mt.KernelUnsupportedError, match="CUDA"):
        ck.flash_attention(q, q, q, causal=True)
    with pytest.raises(mt.KernelUnsupportedError, match="bf16"):
        ck.paged_attention(f[:, :, :1], f, f, valid)


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
