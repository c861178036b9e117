"""The port's TransformerLM held against the reference's, on the CPU.

A small model (2 layers, d_model 32, 2 heads, vocab 89, f32) gets the same
numpy-made weights in both packages (``convert.params_from_reference``).
Tolerances: logits <= 1e-5 absolute (f32, different summation orders);
greedy tokens equal; f32 pool contents <= 1e-6 where written.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models.transformer import TransformerLM as JaxLM
from mxnet_tpu.models.transformer import TransformerLMConfig as JaxCfg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import params_from_reference
from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                TransformerLMConfig)

V, L, D, H, F, S = 89, 2, 32, 2, 64, 32
PSZ = 4
LOGIT_ATOL = 1e-5


def _np_params(seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(0.0, 0.02, size=shape).astype(np.float32)

    return {
        "embed": mk(V, D),
        "pos_embed": mk(S, D) * 25.0,
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


@pytest.fixture(scope="module")
def pair():
    p = _np_params()
    jm = JaxLM(JaxCfg(vocab_size=V, num_layers=L, d_model=D, num_heads=H,
                      d_ff=F, max_len=S, dtype=jnp.float32))
    tm = TransformerLM(TransformerLMConfig(
        vocab_size=V, num_layers=L, d_model=D, num_heads=H, d_ff=F,
        max_len=S, dtype=torch.float32), device="cpu")
    tm.load_state_dict(params_from_reference(p))
    return jm, jax.tree_util.tree_map(jnp.asarray, p), tm


@pytest.mark.parametrize("tier", [True, False], ids=["tier-on", "tier-off"])
def test_apply_logits_match_reference(pair, tier):
    jm, jp, tm = pair
    toks = np.random.default_rng(1).integers(0, V, (2, 13)).astype(np.int32)
    want = np.asarray(jm.apply(jp, jnp.asarray(toks)))
    mt.config.set("kernels.enabled", tier)
    try:
        got = tm.apply(toks)
    finally:
        mt.config.unset("kernels.enabled")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


def _run_generation(model, params, kv, prompt_len, steps, jax_side):
    """prefill one prompt (bucket 8, table [0, 1]) then ``steps`` decode
    steps over table [0, 1, 2, 5] (pool 6 pages of 4).  A second,
    inactive decode row rides along on the all-sentinel table."""
    toks = np.zeros((1, 8), np.int32)
    toks[0, :prompt_len] = np.random.default_rng(2).integers(
        0, V, prompt_len)
    lengths = np.asarray([prompt_len], np.int32)
    table = np.asarray([[0, 1]], np.int32)
    dtable = np.asarray([[0, 1, 2, 5], [6, 6, 6, 6]], np.int32)
    ids_seq, logits_seq = [], []
    if jax_side:
        kv, ids, lg = model.prefill(params, kv, jnp.asarray(toks),
                                    jnp.asarray(lengths), jnp.asarray(table),
                                    PSZ, return_logits=True)
    else:
        kv, ids, lg = model.prefill(kv, toks, lengths, table, PSZ,
                                    return_logits=True)
    ids_seq.append(int(ids[0]))
    logits_seq.append(np.asarray(lg)[0])
    pos = prompt_len
    for _ in range(steps):
        tok = np.asarray([ids_seq[-1], 0], np.int32)
        poss = np.asarray([pos, 0], np.int32)
        if jax_side:
            kv, ids, lg = model.decode_step(
                params, kv, jnp.asarray(tok), jnp.asarray(poss),
                jnp.asarray(dtable), PSZ, return_logits=True)
        else:
            kv, ids, lg = model.decode_step(kv, tok, poss, dtable, PSZ,
                                            return_logits=True)
        ids_seq.append(int(ids[0]))
        logits_seq.append(np.asarray(lg)[0])
        pos += 1
    return kv, ids_seq, logits_seq


def _np_pool(kv):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in kv.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["bf-pool", "int8"])
def test_prefill_and_decode_match_reference(pair, quant):
    jm, jp, tm = pair
    jkv, jids, jlog = _run_generation(
        jm, jp, jm.init_kv_pages(6, PSZ, quantized=quant), 7, 3, True)
    tkv, tids, tlog = _run_generation(
        tm, None, tm.init_kv_pages(6, PSZ, quantized=quant), 7, 3, False)
    assert tids == jids
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL)
    jp_, tp_ = _np_pool(jkv), _np_pool(tkv)
    # written rows: positions 0..9 -> pages 0, 1, 2 (slots 0..1 of page 2)
    for key in jp_:
        w, r = tp_[key][:, :3], jp_[key][:, :3]
        if w.dtype == np.int8:
            # int8 rounding of inputs that differ in the last f32 bit may
            # land one step apart
            assert np.abs(w.astype(np.int32) - r.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(w, r, rtol=1e-5, atol=1e-6)
        # never-written pages stay zero (sentinel writes were dropped)
        assert not tp_[key][:, 3:].any()


def test_int8_pool_within_error_budget(pair):
    _, _, tm = pair
    budget = float(mt.config.get("quant.error_budget"))
    fkv, fids, flog = _run_generation(tm, None, tm.init_kv_pages(6, PSZ),
                                      7, 4, False)
    qkv, qids, qlog = _run_generation(
        tm, None, tm.init_kv_pages(6, PSZ, quantized=True), 7, 4, False)
    for name in ("k", "v"):
        deq = qkv[name].float() * qkv[name + "_scale"][..., None]
        ref = fkv[name].float()
        rel = float((deq - ref).norm() / ref.norm())
        assert rel <= budget, (name, rel)
    scale = max(float(np.abs(r).max()) for r in flog)
    drift = max(float(np.abs(q - r).max()) for q, r in zip(qlog, flog))
    assert drift / scale <= budget


def test_greedy_decode_matches_reference_oracle(pair):
    jm, jp, tm = pair
    prompt = np.random.default_rng(5).integers(0, V, 6).astype(np.int32)
    want = jm.greedy_decode(jp, prompt, 8)
    got = tm.greedy_decode(prompt, 8)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- sampler
def _sample_case(B=6, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    sample = {
        "temperature": np.asarray([0.0, 0.7, 1.0, 2.0, 1.3, 0.9],
                                  np.float32)[:B],
        "top_k": np.asarray([0, 5, 0, 12, 3, 0], np.int32)[:B],
        "top_p": np.asarray([1.0, 1.0, 0.6, 0.9, 0.8, 0.3],
                            np.float32)[:B],
        "key": rng.integers(0, 2 ** 32, (B, 2)).astype(np.uint32),
    }
    positions = rng.integers(0, S, B).astype(np.int32)
    return x, sample, positions


def _jax_sample(jm, jp, x, sample, positions):
    ids, _ = jm._sample_last(jp, jnp.asarray(x), jnp.asarray(positions),
                             {k: jnp.asarray(v) for k, v in sample.items()})
    return np.asarray(ids)


def test_sampler_argmax_matches_reference_with_its_noise(pair):
    """The reference's own Gumbel noise, fed to the port's sampler, picks
    the same token in every row (several key draws)."""
    jm, jp, tm = pair
    for seed in range(4):
        x, sample, positions = _sample_case(seed=seed)
        want = _jax_sample(jm, jp, x, sample, positions)
        gum = np.asarray(jax.vmap(lambda kr, pos: jax.random.gumbel(
            jax.random.fold_in(kr, pos), (V,), jnp.float32))(
                jnp.asarray(sample["key"]),
                jnp.asarray(positions).astype(jnp.uint32)))
        orig = tm.gumbel
        tm.gumbel = lambda keys, pos, vocab, device: torch.tensor(gum)
        try:
            got, _ = tm._sample_last(torch.from_numpy(x), positions, sample)
        finally:
            tm.gumbel = orig
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_keep_mask_matches_reference(pair, monkeypatch):
    """Probe both samplers' top-k/top-p keep-masks: noise 1e6 on token j
    (and 0 elsewhere) picks j exactly when j survives the mask.  The
    reference is probed by routing the row's key word 0 to j through
    patched ``jax.random.fold_in``/``gumbel``."""
    jm, jp, tm = pair
    x, sample, positions = _sample_case()
    B = x.shape[0]
    rows = np.repeat(np.arange(B), V)
    probe = np.tile(np.arange(V), B)
    xs = x[rows]
    samp = {k: v[rows] for k, v in sample.items() if k != "key"}
    samp["key"] = np.stack([probe, np.zeros_like(probe)], 1).astype(
        np.uint32)
    monkeypatch.setattr(jax.random, "fold_in", lambda k, d: k)
    monkeypatch.setattr(
        jax.random, "gumbel",
        lambda k, shape, dtype: 1e6 * jax.nn.one_hot(k[0], shape[0],
                                                     dtype=dtype))
    jax_pick = _jax_sample(jm, jp, xs, samp, positions[rows])
    orig = tm.gumbel
    tm.gumbel = lambda keys, pos, vocab, device: 1e6 * torch.nn.functional \
        .one_hot(torch.from_numpy(keys[:, 0].astype(np.int64)),
                 vocab).float()
    try:
        port_pick, _ = tm._sample_last(torch.from_numpy(xs),
                                       positions[rows], samp)
    finally:
        tm.gumbel = orig
    greedy = sample["temperature"][rows] == 0
    want = (jax_pick == probe).reshape(B, V)
    got = (port_pick.numpy() == probe).reshape(B, V)
    np.testing.assert_array_equal(got, want)
    # sampled rows keep a non-trivial, properly truncated set
    kept = want[~(sample["temperature"] == 0)].sum(axis=1)
    assert (kept >= 1).all() and (kept < V).any()
    assert greedy.any()


def test_gumbel_noise_is_per_row_and_position():
    from mxnet_tpu_torch.models.transformer import gumbel_noise
    keys = np.asarray([[1, 2], [1, 2], [3, 4]], np.uint32)
    a = gumbel_noise(keys, [5, 6, 5], V, "cpu")
    b = gumbel_noise(keys[::-1].copy(), [5, 6, 5][::-1], V, "cpu")
    assert a.shape == (3, V) and torch.isfinite(a).all()
    # same (key, position) -> same row, whatever else is in the batch
    assert torch.equal(a[0], b[2]) and torch.equal(a[2], b[0])
    assert not torch.equal(a[0], a[1])


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    cfg = TransformerLMConfig(vocab_size=V, num_layers=1, d_model=D,
                              num_heads=H, d_ff=F, max_len=S,
                              dtype=torch.float32)
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"
    assert TransformerLM(cfg, device=mt.cpu()).device.type == "cpu"
    if torch.cuda.is_available():
        assert TransformerLM(cfg).device == torch.device("cuda", 0)
    else:
        with pytest.raises(mt.MXNetErrorNoDevice):
            TransformerLM(cfg)
        with pytest.raises(mt.MXNetErrorNoDevice):
            TransformerLM(cfg, device=mt.gpu())
