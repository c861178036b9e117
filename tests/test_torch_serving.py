"""The port's generation server on the CPU, held against the reference.

The traffic is ``tools/check_generation.py``'s: its TRAFFIC mix, prompt
buckets 4 and 8, page size 8, a pool of ``pool_pages`` pages (so requests
wait for pages), and its small f32 model with pos_embed x25.  Every
served greedy stream must EQUAL the reference's cache-free oracle
(``mxnet_tpu`` ``TransformerLM.greedy_decode``) token for token.
"""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models.transformer import TransformerLM as JaxLM
from mxnet_tpu.models.transformer import TransformerLMConfig as JaxCfg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import params_from_reference
from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                TransformerLMConfig)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_check_generation():
    spec = importlib.util.spec_from_file_location(
        "_check_generation", os.path.join(ROOT, "tools",
                                          "check_generation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CG = _load_check_generation()
L, D, H, F = 2, 16, 2, 32


def _np_params(max_len, seed=0):
    """check_generation.py's host-side init."""
    prng = np.random.default_rng(seed)

    def mk(*shape):
        return prng.normal(0.0, 0.02, size=shape).astype(np.float32)

    return {
        "embed": mk(CG.VOCAB, D),
        "pos_embed": mk(max_len, D) * 25.0,
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


def _models(max_len):
    p = _np_params(max_len)
    jm = JaxLM(JaxCfg(vocab_size=CG.VOCAB, num_layers=L, d_model=D,
                      num_heads=H, d_ff=F, max_len=max_len,
                      dtype=jnp.float32))
    tm = TransformerLM(TransformerLMConfig(
        vocab_size=CG.VOCAB, num_layers=L, d_model=D, num_heads=H, d_ff=F,
        max_len=max_len, dtype=torch.float32), device="cpu")
    tm.load_state_dict(params_from_reference(p))
    return p, jm, jax.tree_util.tree_map(jnp.asarray, p), tm


class _Knobs:
    """Set port knobs for one test and restore them after."""

    def __init__(self, **knobs):
        self.knobs = {k.replace("__", "."): v for k, v in knobs.items()}

    def __enter__(self):
        for k, v in self.knobs.items():
            mt.config.set(k, v)

    def __exit__(self, *exc):
        for k in self.knobs:
            mt.config.unset(k)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """check_generation.py's main artifact, exported by the port (tier on,
    sampling, decode batch 4) and registered on a CPU server."""
    p, jm, jp, tm = _models(CG.MAX_CONTEXT)
    prefix = str(tmp_path_factory.mktemp("gen") / "lm")
    mt.deploy.export_generation(tm, p, prefix, page_size=CG.PAGE_SIZE,
                                max_context=CG.MAX_CONTEXT,
                                prompt_buckets=CG.PROMPT_BUCKETS,
                                sampling=True, decode_batch=4)
    pool_pages = 2 * math.ceil(
        max(p_ + n for p_, n in CG.TRAFFIC) / CG.PAGE_SIZE)
    srv = mt.serving.Server(device="cpu")
    with _Knobs(serving__kv_pages=pool_pages, kernels__enabled=True):
        engine = srv.register("lm", prefix, generate=True)
    srv.start()
    yield {"srv": srv, "engine": engine, "jm": jm, "jp": jp, "tm": tm,
           "prefix": prefix, "pool_pages": pool_pages, "params": p}
    srv.stop()


def test_traffic_streams_equal_reference_oracle(served):
    srv, engine = served["srv"], served["engine"]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, CG.VOCAB, size=p).astype(np.int32)
               for p, _ in CG.TRAFFIC]
    oracle = [served["jm"].greedy_decode(served["jp"], pr, n)
              for pr, (_, n) in zip(prompts, CG.TRAFFIC)]
    tt.reset()
    with _Knobs(kernels__enabled=True):
        futs = [srv.submit_generate("lm", pr, n)
                for pr, (_, n) in zip(prompts, CG.TRAFFIC)]
        streams = [f.result(timeout=60) for f in futs]
    for s, o in zip(streams, oracle):
        np.testing.assert_array_equal(s, o)
    assert tt.counter("serving.kv_pool_exhausted").value > 0
    with engine._cond:
        assert len(engine._free) == served["pool_pages"]
    # every prefill and decode layer went through the routed wrappers
    assert tt.counter("kernels.flash_attention").value >= len(CG.TRAFFIC) * L
    assert tt.counter("kernels.paged_attention").value > 0
    assert tt.counter("serving.tokens_generated").value == sum(
        n for _, n in CG.TRAFFIC)
    routes = engine.predictor.paged_routes
    assert set(routes) == {str(w) for w in engine.predictor.decode_widths}
    # the f32 model is not the kernel's dtype: the verdict says so (on the
    # card such a decode call raises; here the CPU runs the plain version)
    assert all(r["impl"] == "unsupported" and "bf16" in r["reason"]
               for r in routes.values())


def test_sampling_replays_per_seed(served):
    srv = served["srv"]
    sp = np.arange(3, dtype=np.int32)
    rep = [srv.generate("lm", sp, 5, temperature=5.0, seed=42, timeout=60)
           for _ in range(2)]
    np.testing.assert_array_equal(rep[0], rep[1])
    futs = [srv.submit_generate("lm", sp, 5, temperature=5.0,
                                seed=1000 + i) for i in range(8)]
    assert len({tuple(f.result(timeout=60).tolist()) for f in futs}) >= 2
    # temperature 0 stays the greedy stream
    greedy = srv.generate("lm", sp, 5, timeout=60)
    np.testing.assert_array_equal(
        greedy, served["tm"].greedy_decode(sp, 5))


def test_predictor_generate_matches_server(served):
    gp = mt.deploy.load_generator(served["prefix"], device="cpu")
    pr = np.asarray([5, 1, 7, 3], np.int32)
    np.testing.assert_array_equal(
        gp.generate(pr, 6), served["srv"].generate("lm", pr, 6, timeout=60))
    assert gp.prompt_buckets == CG.PROMPT_BUCKETS
    assert gp.decode_widths == (1, 2)
    assert gp.decode_batch == 4 and gp.sampling


def test_typed_errors(served):
    srv = served["srv"]
    with pytest.raises(NotImplementedError):
        srv.register("oneshot", served["prefix"])
    with pytest.raises(mt.serving.ServingError):
        srv.submit("lm", np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError):
        srv.submit_generate("lm", np.zeros(CG.MAX_CONTEXT, np.int32), 4)
    with pytest.raises(mt.serving.ServingError):
        srv.submit_generate("nope", np.zeros(2, np.int32), 2)
    stopped = mt.serving.Server(device="cpu")
    stopped.register("lm", served["prefix"], generate=True)
    with pytest.raises(mt.serving.ServingError):
        stopped.submit_generate("lm", np.zeros(2, np.int32), 2)


def test_shared_prefix_pages_are_refcounted_and_freed(tmp_path):
    max_len, psz = 32, 8
    p, jm, jp, tm = _models(max_len)
    prefix = str(tmp_path / "lm")
    mt.deploy.export_generation(tm, p, prefix, page_size=psz,
                                max_context=max_len, prompt_buckets=(16, 32))
    rng = np.random.default_rng(4)
    system = rng.integers(0, CG.VOCAB, 16).astype(np.int32)  # 2 full pages
    prompts = [np.concatenate([system, rng.integers(0, CG.VOCAB, n)
                               .astype(np.int32)]) for n in (1, 3, 5, 2)]
    tt.reset()
    srv = mt.serving.Server(device="cpu")
    with _Knobs(serving__kv_pages=24, serving__decode_slots=4):
        engine = srv.register("lm", prefix, generate=True)
    srv.start()
    try:
        # concurrent: the first admitted request registers and populates
        # the prefix pages, the others map onto them while it is in flight
        futs = [srv.submit_generate("lm", pr, 6) for pr in prompts]
        streams = [f.result(timeout=60) for f in futs]
        with engine._cond:
            free, entries = len(engine._free), len(engine._prefix)
    finally:
        srv.stop()
    for s, pr in zip(streams, prompts):
        np.testing.assert_array_equal(s, jm.greedy_decode(jp, pr, 6))
    assert tt.counter("serving.prefix_hits").value >= 1
    assert tt.counter("serving.prefix_pages_shared").value >= 2
    # every page, shared ones included, went back to the free list
    assert free == 24 and entries == 0


def test_int8_kv_serving_completes(served, tmp_path):
    p, tm = served["params"], served["tm"]
    prefixq = str(tmp_path / "lmq")
    mt.deploy.export_generation(tm, p, prefixq, page_size=CG.PAGE_SIZE,
                                max_context=CG.MAX_CONTEXT,
                                prompt_buckets=CG.PROMPT_BUCKETS,
                                kv_quantized=True)
    srv = mt.serving.Server(device="cpu")
    with _Knobs(serving__kv_pages=served["pool_pages"]):
        eng = srv.register("lmq", prefixq, generate=True)
    assert eng.predictor.kv_quantized
    srv.start()
    try:
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, CG.VOCAB, size=p_).astype(np.int32)
                   for p_, _ in CG.TRAFFIC]
        futs = [srv.submit_generate("lmq", pr, n)
                for pr, (_, n) in zip(prompts, CG.TRAFFIC)]
        done = [f.result(timeout=60) for f in futs]
    finally:
        srv.stop()
    assert [len(s) for s in done] == [n for _, n in CG.TRAFFIC]
    with eng._cond:
        assert len(eng._free) == served["pool_pages"]


def test_concurrent_submitters_lose_no_request_or_page(served):
    """More submitting threads than cores, with a short switch interval:
    every future resolves with its full budget and every page returns."""
    import sys
    import threading
    srv, engine = served["srv"], served["engine"]
    results, errors = [], []
    lock = threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(3):
                pr = rng.integers(0, CG.VOCAB, int(rng.integers(1, 8)))
                out = srv.generate("lm", pr.astype(np.int32), 4, timeout=60)
                with lock:
                    results.append(len(out))
        except Exception as exc:  # noqa: BLE001 — reported below
            with lock:
                errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2 * (os.cpu_count() or 1) + 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert results == [4] * (3 * len(threads))
    with engine._cond:
        assert len(engine._free) == served["pool_pages"]
        assert not engine._queue
