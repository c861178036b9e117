"""bench.py's ``generation_config`` on the port, held against the reference.

The configuration is ``bench.py`` ``generation_config``'s own
(bench.py:1153-1155): an f32 TransformerLM of vocab 89, 2 layers,
d_model 32, 2 heads of 16, d_ff 64, context 32, pages of 8, its weights
made by numpy as bench.py makes them (seed 0, pos_embed x25).  Both
scenarios run through each package's ``export_generation`` ->
``Server``, with fewer requests than on the card:

* scenario 1: its mixed-length traffic at 4 slots (continuous) and
  one request at a time through ``GenerationPredictor.generate``
  (static);
* scenario 2: 8 slots, a 24-token system prompt, one divergent token,
  7 new tokens; f32 pages without sharing at a pool of one request
  against int8 pages at twice the page count with shared-prefix reuse.

Every greedy stream the port serves must EQUAL the reference's served
stream token for token (and, for f32 pages, the reference's cache-free
``greedy_decode``).  The port runs the kernels' plain versions here (CPU
tensors) with the tier on; the export's route verdicts say the Hopper
kernels take every width.  The kernels' plain versions are held against
the reference's Pallas kernels in interpret mode at the configuration's
shapes and at the full-width model's head dim: f32, <= 1e-6 absolute
(summation order only), as ``tests/test_torch_kernels.py``; the flash
backward at 4e-6 (gradients reach ~3, a few f32 ulps).
"""
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as rmx
from mxnet_tpu import deploy as rdeploy
from mxnet_tpu import serving as rserving
from mxnet_tpu.models.transformer import TransformerLM as JaxLM
from mxnet_tpu.models.transformer import TransformerLMConfig as JaxCfg
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.quantization import quantize_rows as jax_quantize_rows

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import params_from_reference
from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                TransformerLMConfig)
from mxnet_tpu_torch.ops import cuda_kernels as ck

VOCAB, PAGE, CTX, SLOTS = 89, 8, 32, 4
L, D, H, F = 2, 32, 2, 64
MIX = [(3, 9), (7, 6), (12, 12), (5, 8), (9, 10), (14, 7)]
SLOTS2, SYS_LEN, DIVERGE, NEW2 = 8, 24, 1, 7
#: bench.py serves 24 requests (scenario 2: 8 x 24) on the card
REQUESTS = 6
ATOL = 1e-6
BWD_ATOL = 4e-6


def _np_params():
    """bench.py generation_config's host-side init, as it writes it."""
    prng = np.random.default_rng(0)

    def mk(*shape):
        return prng.normal(0.0, 0.02, size=shape).astype(np.float32)

    return {
        "embed": mk(VOCAB, D),
        "pos_embed": mk(CTX, D) * 25.0,
        "final_norm": np.ones((D,), np.float32),
        "layers": {
            "ln1": np.ones((L, D), np.float32),
            "wqkv": mk(L, D, 3, H, D // H),
            "wo": mk(L, H, D // H, D),
            "ln2": np.ones((L, D), np.float32),
            "w1": mk(L, D, F),
            "w2": mk(L, F, D),
        },
    }


def _traffic(requests):
    """bench.py's traffic from its one RandomState(7)."""
    traffic = [MIX[i % len(MIX)] for i in range(requests)]
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, VOCAB, size=p).astype(np.int32)
               for p, _ in traffic]
    sys_prompt = rng.randint(0, VOCAB, size=SYS_LEN).astype(np.int32)
    prompts2 = [np.concatenate([sys_prompt,
                                np.asarray([(i + 1) % VOCAB], np.int32)])
                for i in range(8 * requests)]
    return traffic, prompts, prompts2


def _pages():
    """Scenario 2's pools: one f32 request's pages, and twice as many int8
    pages in no more bytes."""
    pages_f32 = math.ceil((SYS_LEN + DIVERGE + NEW2) / PAGE)
    row = L * H * (D // H)
    assert (2 * pages_f32 * (2 * row * PAGE + 2 * L * H * PAGE * 4)
            <= pages_f32 * 2 * row * PAGE * 4)
    return pages_f32, 2 * pages_f32


class _Knobs:
    """Set one package's config knobs for a block and restore them after."""

    def __init__(self, pkg, **knobs):
        self.pkg = pkg
        self.knobs = {k.replace("__", "."): v for k, v in knobs.items()}

    def __enter__(self):
        for k, v in self.knobs.items():
            self.pkg.config.set(k, v)

    def __exit__(self, *exc):
        for k in self.knobs:
            self.pkg.config.unset(k)


def _serve(pkg, server, label, prefix, prompts, budgets, **knobs):
    """Register ``prefix`` on a fresh server of ``pkg`` under ``knobs``,
    serve the burst, stop; returns (streams, the engine's stats after)."""
    with _Knobs(pkg, **knobs):
        srv = server()
        engine = srv.register(label, prefix, generate=True)
        srv.start()
        try:
            futs = [srv.submit_generate(label, pr, n)
                    for pr, n in zip(prompts, budgets)]
            streams = [np.asarray(f.result(timeout=120)) for f in futs]
            stats = engine.stats()
        finally:
            srv.stop()
    return streams, stats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' artifacts and served streams for both scenarios."""
    p = _np_params()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jm = JaxLM(JaxCfg(vocab_size=VOCAB, num_layers=L, d_model=D,
                      num_heads=H, d_ff=F, max_len=CTX, dtype=jnp.float32))
    tm = TransformerLM(TransformerLMConfig(
        vocab_size=VOCAB, num_layers=L, d_model=D, num_heads=H, d_ff=F,
        max_len=CTX, dtype=torch.float32), device="cpu")
    tm.load_state_dict(params_from_reference(p))
    traffic, prompts, prompts2 = _traffic(REQUESTS)
    budgets = [n for _, n in traffic]
    pages_f32, pages_int8 = _pages()
    out = {"jm": jm, "jp": jp, "tm": tm, "prompts": prompts,
           "budgets": budgets, "prompts2": prompts2,
           "pages": (pages_f32, pages_int8), "meta": {}}
    for name, pkg, dep in (("ref", rmx, rdeploy), ("port", mt, mt.deploy)):
        d = tmp_path_factory.mktemp("gen_" + name)
        model = jm if name == "ref" else tm
        params = jp if name == "ref" else p
        dep.export_generation(model, params, str(d / "lm"), page_size=PAGE,
                              max_context=CTX, prompt_buckets=(8, 16))
        dep.export_generation(model, params, str(d / "base"),
                              page_size=PAGE, max_context=CTX,
                              prompt_buckets=(32,))
        with _Knobs(pkg, kernels__enabled=True):
            dep.export_generation(model, params, str(d / "opt"),
                                  page_size=PAGE, max_context=CTX,
                                  prompt_buckets=(32,), sampling=True,
                                  kv_quantized=True, decode_batch=SLOTS2)
        for art in ("lm", "base", "opt"):
            with open(str(d / art) + "-meta.json") as f:
                out["meta"][name, art] = json.load(f)
        if name == "ref":
            server = rserving.Server
        else:
            def server():
                return mt.serving.Server(device="cpu")
        common = {"kernels__enabled": True, "serving__kv_page_size": PAGE}
        out[name, "cont"], _ = _serve(
            pkg, server, "lm", str(d / "lm"), prompts, budgets,
            serving__kv_pages=2 * SLOTS * math.ceil(CTX / PAGE),
            serving__decode_slots=SLOTS, **common)
        if name == "port":
            tt.reset()
        out[name, "base"], out[name, "base_stats"] = _serve(
            pkg, server, "lm_base", str(d / "base"), prompts2,
            [NEW2] * len(prompts2), serving__kv_pages=pages_f32,
            serving__decode_slots=SLOTS2, serving__shared_prefix=False,
            **common)
        if name == "port":
            out["port_base_counters"] = tt.snapshot()["counters"]
            tt.reset()
        out[name, "opt"], out[name, "opt_stats"] = _serve(
            pkg, server, "lm_opt", str(d / "opt"), prompts2,
            [NEW2] * len(prompts2), serving__kv_pages=pages_int8,
            serving__decode_slots=SLOTS2, serving__shared_prefix=True,
            **common)
        if name == "port":
            out["port_opt_counters"] = tt.snapshot()["counters"]
            pred = mt.deploy.load_generator(str(d / "lm"), device="cpu")
            with _Knobs(mt, kernels__enabled=True):
                out["port", "static"] = [pred.generate(pr, n)
                                         for pr, n in zip(prompts, budgets)]
    return out


def test_scenario1_streams_equal_the_reference(runs):
    """Scenario 1: the port's continuous and static streams equal the
    reference's served streams and its cache-free greedy oracle."""
    oracle = [runs["jm"].greedy_decode(runs["jp"], pr, n)
              for pr, n in zip(runs["prompts"], runs["budgets"])]
    for got, ref, want in zip(runs["port", "cont"], runs["ref", "cont"],
                              oracle):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, want)
    for got, want in zip(runs["port", "static"], oracle):
        np.testing.assert_array_equal(got, want)


def test_scenario2_streams_equal_the_reference(runs):
    """Scenario 2: the f32-page baseline and the int8-page shared-prefix
    run serve the reference's streams; the f32 streams also equal the
    oracle."""
    oracle = [runs["jm"].greedy_decode(runs["jp"], pr, NEW2)
              for pr in runs["prompts2"]]
    for got, ref, want in zip(runs["port", "base"], runs["ref", "base"],
                              oracle):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, want)
    for got, ref in zip(runs["port", "opt"], runs["ref", "opt"]):
        np.testing.assert_array_equal(got, ref)


def test_scenario2_counters_and_page_accounting(runs):
    """The pool-bound baseline stalls on pages and shares nothing; the
    int8 run reuses the system prompt's pages (prefix hits), counts the
    paged route on every decode layer; both end with every page free."""
    pages_f32, pages_int8 = runs["pages"]
    base, opt = runs["port_base_counters"], runs["port_opt_counters"]
    n = len(runs["prompts2"])
    assert base.get("serving.prefix_hits", 0) == 0
    assert base["serving.kv_pool_exhausted"] >= 1
    assert opt["serving.prefix_hits"] >= 1
    for c in (base, opt):
        assert c["serving.tokens_generated"] == n * NEW2
        assert c["kernels.flash_attention"] == n * L
        assert c["kernels.paged_attention"] > 0
        assert c["kernels.paged_attention"] % L == 0
    for key, pages in (("base_stats", pages_f32), ("opt_stats", pages_int8)):
        stats = runs["port", key]
        assert stats["kv_pages_free"] == pages and stats["active"] == 0
        assert stats["prefix_entries"] == 0


def test_exported_route_verdicts_take_every_width(runs):
    """The port's kernel check takes every decode width of the three
    artifacts (f32 pages at head dim 16, and int8 pages under an f32
    query), as the reference's own verdict does for the int8 artifact
    exported at a fixed decode batch."""
    for art in ("lm", "base", "opt"):
        routes = runs["meta"]["port", art]["paged"]
        assert set(routes) == {"1", "2", "4"}
        assert all(r["impl"] == "paged" and r["reason"] is None
                   for r in routes.values()), routes
        assert all(r["quantized"] == (art == "opt") for r in routes.values())
    ref = runs["meta"]["ref", "opt"]["paged"]
    assert all(r["impl"] == "paged" for r in ref.values()), ref


def test_chip_smoke_builds_the_same_model_and_traffic():
    """chip_smoke.py's phase 3b builds generation_config's weights and
    traffic as bench.py does (this file's copy of it)."""
    got, want = chip_smoke.genconf_params(np), _np_params()
    assert set(got) == set(want) and set(got["layers"]) == set(
        want["layers"])
    for k in ("embed", "pos_embed", "final_norm"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in want["layers"]:
        np.testing.assert_array_equal(got["layers"][k], want["layers"][k])
    traffic, prompts, prompts2 = chip_smoke.genconf_traffic(np, REQUESTS)
    w_traffic, w_prompts, w_prompts2 = _traffic(REQUESTS)
    assert traffic == w_traffic
    for a, b in zip(prompts + prompts2, w_prompts + w_prompts2):
        np.testing.assert_array_equal(a, b)
    cfg = chip_smoke.genconf_config(torch)
    assert (cfg.vocab_size, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.d_ff, cfg.max_len, cfg.dtype) == (
        VOCAB, L, D, H, F, CTX, torch.float32)


# -------------------------------------- the kernels' plain versions, f32
def _pool(quant, B, Hh, Dh, psz, W, seed):
    """A pool with a shuffled table (sentinels past each length) and
    ragged lengths (a full row, a single position), as numpy."""
    rng = np.random.RandomState(seed)
    P = B * W + 3
    q = rng.randn(B, Hh, 1, Dh).astype(np.float32)
    kp = rng.randn(P, psz, Hh, Dh).astype(np.float32)
    vp = rng.randn(P, psz, Hh, Dh).astype(np.float32)
    ks = vs = None
    if quant:
        kp, ks = (np.asarray(x) for x in jax_quantize_rows(kp))
        vp, vs = (np.asarray(x) for x in jax_quantize_rows(vp))
    lengths = rng.randint(1, W * psz + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = W * psz, 1
    table = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    for b in range(B):
        table[b, -(-lengths[b] // psz):] = P
    return q, kp, vp, ks, vs, table, lengths


def _gathered(pool, table):
    """``[P, psz, H, ...]`` through ``table [B, W]`` (clamped) as
    ``[B, H, W*psz, ...]``."""
    B, W = table.shape
    g = pool[np.clip(table, 0, pool.shape[0] - 1)]
    g = g.reshape(B, W * pool.shape[1], *pool.shape[2:])
    return np.ascontiguousarray(np.swapaxes(g, 1, 2))


@pytest.mark.parametrize("form", ["pool", "gathered"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("B,Hh,Dh,psz,W", [
    (8, 2, 16, 8, 4),      # generation_config's decode at width 4
    (8, 12, 64, 16, 8),    # the full-width f32 TransformerLM's
], ids=["genconf-d16", "full-width-d64"])
def test_plain_paged_f32_query_matches_pallas(B, Hh, Dh, psz, W, quant,
                                              form):
    """An f32 query over f32 pages, and over int8 pages with f32 scales:
    ``paged_attention_pool_plain`` (the decode step's entry) and
    ``paged_attention_plain`` (the gathered entry) against
    ``pallas_paged_attention`` in interpret mode, f32 out."""
    q, kp, vp, ks, vs, table, lengths = _pool(quant, B, Hh, Dh, psz, W,
                                              seed=Dh + int(quant))
    k, v = _gathered(kp, table), _gathered(vp, table)
    valid = np.arange(W * psz)[None, :] < lengths[:, None]
    scales = {}
    if quant:
        scales = {"k_scale": _gathered(ks, table),
                  "v_scale": _gathered(vs, table)}
    want = pk.pallas_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        **{n: jnp.asarray(a) for n, a in scales.items()})
    t = torch.from_numpy
    before = dict(ck.LAUNCHES)
    if form == "pool":
        got = ck.paged_attention_pool(
            t(q), t(kp), t(vp), t(table), t(lengths),
            k_scale_pool=None if ks is None else t(ks),
            v_scale_pool=None if vs is None else t(vs))
    else:
        got = ck.paged_attention(t(q), t(k), t(v), t(valid),
                                 **{n: t(a) for n, a in scales.items()})
    assert ck.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("S", [8, 16, 32])
def test_plain_flash_f32_d16_matches_pallas(S):
    """generation_config's prefill attention (B=1, 2 heads of 16, causal,
    its buckets 8 and 16 and its context 32) in f32:
    ``flash_attention_plain`` and ``flash_attention_bwd_plain`` against the
    Pallas forward and backward in interpret mode."""
    rng = np.random.RandomState(S)
    q, k, v, do = (rng.randn(1, 2, S, 16).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / np.sqrt(16)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = pk._flash_forward(jq, jk, jv, True, scale, 8)
    want = pk._flash_backward(jq, jk, jv, o, lse, jdo, True, scale, 8)
    t = torch.from_numpy
    before = dict(ck.LAUNCHES)
    got_o, got_lse = ck.flash_attention(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=0,
                               atol=ATOL)
    grads = ck.flash_attention_bwd(t(q), t(k), t(v), t(np.asarray(o)),
                                   t(np.asarray(lse)), t(do), causal=True)
    assert ck.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=BWD_ATOL)


# ---------------------------------------------- the kernels' own checks
def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _pool_reason(B, Hh, Dh, psz, W, quant, qdtype=torch.float32):
    q = _meta(B, Hh, 1, Dh, dtype=qdtype)
    pool = _meta(64, psz, Hh, Dh, dtype=torch.int8 if quant else qdtype)
    sc = _meta(64, psz, Hh) if quant else None
    return ck.paged_pool_unsupported_reason(
        q, pool, pool, _meta(B, W, dtype=torch.int32),
        _meta(B, dtype=torch.int32), sc, sc)


def test_checks_take_every_phase_3b_shape():
    """Every call phase 3b makes passes the kernels' own checks:
    generation_config's prefill (B=1, H=2, D=16, buckets 8, 16, 32) and
    decode (B = 1, 4 and 8 over widths 1, 2 and 4 of pages of 8; f32 and
    int8 pages), and the full-width f32 model's prefill (H=12, D=64,
    buckets 8..2048) and decode (B=8, widths 1..128 of pages of 16)."""
    for S in (8, 16, 32):
        q = _meta(1, 2, S, 16)
        assert ck.flash_unsupported_reason(q, q, q, True) is None
    for S in (8, 512, 2048):
        q = _meta(1, 12, S, 64)
        assert ck.flash_unsupported_reason(q, q, q, True) is None
    for quant in (False, True):
        for B in (1, 4, 8):
            for W in (1, 2, 4):
                assert _pool_reason(B, 2, 16, 8, W, quant) is None
        for W in (1, 32, 128):
            assert _pool_reason(8, 12, 64, 16, W, quant) is None
        q, kv = _meta(8, 2, 1, 16), _meta(8, 2, 32, 16)
        scales = {}
        if quant:
            kv = kv.to(torch.int8)
            scales = {"k_scale": _meta(8, 2, 32), "v_scale": _meta(8, 2, 32)}
        assert ck.paged_unsupported_reason(
            q, kv, kv, _meta(8, 32, dtype=torch.bool), **scales) is None


@pytest.mark.parametrize("quant", [False, True], ids=["f32-pages",
                                                      "int8-pages"])
def test_checks_refuse_f16_and_head_dims_not_built(quant):
    """An f16 query, and an f32 query at an unbuilt head dim (48), are
    refused by name; so is an f32 flash call at head dim 48, and both
    wrappers raise on them (no fallback)."""
    why = _pool_reason(8, 2, 16, 8, 4, quant, qdtype=torch.float16)
    assert "bf16 or f32 query, got f16" in why
    assert "head dim 48 not in 16/64 for float32" in _pool_reason(
        8, 2, 48, 8, 4, quant)
    q = _meta(1, 2, 8, 48)
    assert "head dim 48 not in 16/32/64 for float32" in \
        ck.flash_unsupported_reason(q, q, q, True)
    with pytest.raises(mt.KernelUnsupportedError, match="head dim 48"):
        ck.flash_attention(q, q, q, causal=True)
    q, pool = _meta(8, 2, 1, 48), _meta(64, 8, 2, 48)
    scales = {}
    if quant:
        pool = pool.to(torch.int8)
        scales = {"k_scale_pool": _meta(64, 8, 2),
                  "v_scale_pool": _meta(64, 8, 2)}
    with pytest.raises(mt.KernelUnsupportedError, match="head dim 48"):
        ck.paged_attention_pool(q, pool, pool,
                                _meta(8, 4, dtype=torch.int32),
                                _meta(8, dtype=torch.int32), **scales)
