"""The port's BERT pretraining held against ``mxnet_tpu.models.bert`` on
the CPU.

A tiny BERT (vocab 64, 2 layers, d_model 128, 2 heads of 64, d_ff 256,
S=16, M=4 masked positions, B=2) from the same numpy weights
(``convert.params_from_reference`` into ``BERT.load_state_dict``).  The
batch repeats one masked position (the gather's backward must add both
rows) and gives one masked position weight 0 (it must drop out of the
loss).  Tier on, the port's attention is the flash autograd Function
(its plain versions on the CPU) and the reference's the Pallas flash
kernels in interpret mode; tier off, both packages' plain attention.

Tolerances (f32 unless named), stated where they are used: the hidden
states, the pooler and the MLM logits at FWD_RTOL; the loss at
LOSS_RTOL; gradients per tensor at GRAD_RTOL of the tensor's largest
entry; the example's SGD step bitwise; a 3-step Adam loop by its losses;
the bf16 loss at BF16_LOSS_RTOL.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.models.bert import BERT as JaxBERT
from mxnet_tpu.models.bert import BERTConfig as JaxCfg
from mxnet_tpu.ndarray.ndarray import _wrap

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import params_from_reference, params_to_reference
from mxnet_tpu_torch.models import BERT, BERTConfig, bert_base
from mxnet_tpu_torch.ops import cuda_kernels as ck

_SMOKE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

V, L, D, H, F, S, M, B = 64, 2, 128, 2, 256, 16, 4, 2
# f32 forward values: the packages sum the same products in other orders
# (a few f32 ulps of each tensor's largest entry; measured below 1e-6).
FWD_RTOL = 1e-5
# the loss and the gradients: tests/test_torch_training.py's bounds (the
# same f32 reductions over B*S = 32 positions and a 64-way softmax)
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
LR = 1e-4
ADAM_LR, ADAM_WD = 1e-3, 0.01


def _np_params(seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(0.0, 0.02, size=shape).astype(np.float32)

    def zeros(*shape):
        # small nonzero biases, so a bias that is dropped shows
        return rng.normal(0.0, 0.01, size=shape).astype(np.float32)

    return {
        "embed": mk(V, D),
        "pos_embed": mk(S, D),
        "final_norm": np.ones((D,), np.float32),
        "layers": {
            "ln1": np.ones((L, D), np.float32),
            "wqkv": mk(L, D, 3, H, D // H),
            "wo": mk(L, H, D // H, D),
            "ln2": np.ones((L, D), np.float32),
            "w1": mk(L, D, F),
            "w2": mk(L, F, D),
        },
        "type_embed": mk(2, D),
        "pooler_w": mk(D, D),
        "pooler_b": zeros(D),
        "nsp_w": mk(D, 2),
        "nsp_b": zeros(2),
        "mlm_w": mk(D, D),
        "mlm_b": zeros(D),
        "mlm_norm": np.ones((D,), np.float32),
        "mlm_bias_v": zeros(V),
    }


def _batch():
    rng = np.random.RandomState(0)
    pos = rng.randint(0, S, (B, M))
    pos[0, 3] = pos[0, 1]                      # a repeated masked position
    weights = np.ones((B, M), np.float32)
    weights[1, 2] = 0.0                        # a padded masked position
    return dict(tokens=rng.randint(0, V, (B, S)).astype(np.int32),
                token_types=rng.randint(0, 2, (B, S)).astype(np.int32),
                mlm_positions=pos.astype(np.int32),
                mlm_labels=rng.randint(0, V, (B, M)).astype(np.int32),
                mlm_weights=weights,
                nsp_labels=rng.randint(0, 2, (B,)).astype(np.int32))


_ARGS = ("tokens", "token_types", "mlm_positions", "mlm_labels",
         "mlm_weights", "nsp_labels")


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


def _nest(flat):
    out = {}
    for name, val in flat.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return out


def _models(p, dtype="float32"):
    jm = JaxBERT(JaxCfg(vocab_size=V, num_layers=L, d_model=D, num_heads=H,
                        d_ff=F, max_len=S, dtype=jnp.dtype(dtype)))
    tm = BERT(BERTConfig(vocab_size=V, num_layers=L, d_model=D, num_heads=H,
                         d_ff=F, max_len=S, dtype=getattr(torch, dtype)),
              device="cpu")
    tm.load_state_dict(params_from_reference(p))
    # the reference's init keeps mlm_bias_v f32 in every model dtype
    jp = _nest({n: jnp.asarray(a, jnp.float32 if n == "mlm_bias_v"
                               else jnp.dtype(dtype))
                for n, a in _flat(p).items()})
    return jm, jp, tm


def _jax_batch(batch):
    return [jnp.asarray(batch[k]) for k in _ARGS]


class _Tier:
    """The kernel tier of both packages on or off, for one block."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        jmx.config.set("kernels.enabled", self.on)
        mt.config.set("kernels.enabled", self.on)

    def __exit__(self, *exc):
        jmx.config.unset("kernels.enabled")
        mt.config.unset("kernels.enabled")


class _Remat:
    """``runtime.remat`` set in both packages for one block."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        jmx.config.set("runtime.remat", self.name)
        mt.config.set("runtime.remat", self.name)

    def __exit__(self, *exc):
        jmx.config.unset("runtime.remat")
        mt.config.unset("runtime.remat")


def _rel(got, want):
    got = np.asarray(got.detach().float(), np.float64) \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------- the model
def test_config_and_parameters():
    cfg = bert_base()
    assert (cfg.vocab_size, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.d_ff, cfg.max_len, cfg.type_vocab) == (30522, 12, 768, 12,
                                                        3072, 512, 2)
    assert cfg.causal is False and cfg.dtype == torch.bfloat16
    tm = BERT(BERTConfig(vocab_size=V, num_layers=L, d_model=D, num_heads=H,
                         d_ff=F, max_len=S), device="cpu").init(3)
    names = [n for n, _ in tm.named_parameters()]
    want = sorted(_flat(_np_params()))
    assert sorted(names) == want and len(names) == 18
    # the encoder shares BERT's tensors; mlm_bias_v is f32 in a bf16 model
    assert tm.encoder.embed is tm.embed and tm.encoder.layers is tm.layers
    assert tm.mlm_bias_v.dtype == torch.float32
    assert tm.embed.dtype == torch.bfloat16
    # init: unit norm scales, zero biases, normal(0.02) matrices
    assert torch.equal(tm.mlm_norm, torch.ones_like(tm.mlm_norm))
    assert torch.equal(tm.layers.ln2, torch.ones_like(tm.layers.ln2))
    assert not tm.mlm_bias_v.any() and not tm.pooler_b.any()
    assert abs(float(tm.mlm_w.float().std()) - 0.02) < 2e-3
    assert not any(p.requires_grad for p in tm.parameters())
    with pytest.raises(NotImplementedError, match="slice 14"):
        tm.param_specs()


def test_params_round_trip_keeps_mlm_bias_f32():
    """``params_from_reference`` -> ``BERT.load_state_dict`` ->
    ``params_to_reference`` gives the reference's tree back (names,
    nesting, values); in a bf16 model ``mlm_bias_v`` stays f32, and the
    bf16 tensors come back as their exact f32 widening."""
    p = _np_params()
    _, _, tm = _models(p)
    back = _flat(params_to_reference(tm.state_dict()))
    assert back.keys() == _flat(p).keys()
    for n, want in _flat(p).items():
        np.testing.assert_array_equal(back[n], want)
    _, _, tb = _models(p, "bfloat16")
    assert tb.mlm_bias_v.dtype == torch.float32
    np.testing.assert_array_equal(tb.mlm_bias_v.numpy(), p["mlm_bias_v"])
    back = _flat(params_to_reference(tb.state_dict()))
    want = torch.from_numpy(p["pooler_w"]).bfloat16().float().numpy()
    np.testing.assert_array_equal(back["pooler_w"], want)


def test_hidden_pooled_and_mlm_logits_match_reference():
    p = _np_params()
    jm, jp, tm = _models(p)
    batch = _batch()
    jb = _jax_batch(batch)
    jh, jpool = jm.apply(jp, jb[0], jb[1])
    jlog = jm.mlm_logits(jp, jh, jb[2])
    with torch.no_grad():
        th, tpool = tm.apply(batch["tokens"], batch["token_types"])
        tlog = tm.mlm_logits(th, batch["mlm_positions"])
    assert tpool.dtype == tlog.dtype == torch.float32
    assert _rel(th, jh) <= FWD_RTOL
    assert _rel(tpool, jpool) <= FWD_RTOL
    assert _rel(tlog, jlog) <= FWD_RTOL
    assert tlog.shape == (B, M, V)


@pytest.mark.parametrize("tier", [True, False], ids=["tier-on", "tier-off"])
def test_loss_and_gradients_match_reference(tier):
    """``pretrain_loss`` and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's.  Tier on, one flash call a
    layer in the port (non-causal) and the Pallas kernels in the
    reference."""
    p = _np_params()
    jm, jp, tm = _models(p)
    batch = _batch()
    tm.requires_grad_(True)
    tt.reset()
    with _Tier(tier):
        jloss, jgrads = jax.jit(jax.value_and_grad(jm.pretrain_loss))(
            jp, *_jax_batch(batch))
        loss = tm.pretrain_loss(*(batch[k] for k in _ARGS))
        loss.backward()
    assert tt.counter("kernels.flash_attention").value == (L if tier else 0)
    tl, jl = float(loss.detach()), float(jloss)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    jg = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, prm in tm.named_parameters():
        assert prm.grad is not None, name
        err = np.abs(prm.grad.numpy() - jg[name]).max()
        assert err <= GRAD_RTOL * np.abs(jg[name]).max(), (name, err)


def test_tied_embedding_gradient_takes_both_contributions():
    """The embedding matrix is read twice: the input lookup and the MLM
    readout.  The reference's two contributions, taken apart (two copies
    of the matrix), are both large, and the port's one gradient is their
    sum."""
    p = _np_params()
    jm, jp, tm = _models(p)
    batch = _batch()
    jb = _jax_batch(batch)

    def split_loss(e_in, e_out):
        h, _ = jm.apply(dict(jp, embed=e_in), jb[0], jb[1])
        logits = jm.mlm_logits(dict(jp, embed=e_out), h, jb[2])
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, jb[3][..., None], -1)[..., 0]
        return jnp.sum((logz - gold) * jb[4]) / jnp.maximum(jnp.sum(jb[4]),
                                                            1.0)

    g_in, g_out = jax.grad(split_loss, argnums=(0, 1))(jp["embed"],
                                                       jp["embed"])
    g_in, g_out = np.asarray(g_in), np.asarray(g_out)
    scale = np.abs(g_in + g_out).max()
    assert np.abs(g_in).max() > 0.1 * scale
    assert np.abs(g_out).max() > 0.1 * scale
    tm.requires_grad_(True)
    hidden, _ = tm.apply(batch["tokens"], batch["token_types"])
    logits = tm.mlm_logits(hidden, batch["mlm_positions"])
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, torch.as_tensor(
        batch["mlm_labels"]).long()[..., None])[..., 0]
    w = torch.as_tensor(batch["mlm_weights"])
    ((logz - gold) * w).sum().div(w.sum().clamp(min=1)).backward()
    err = np.abs(tm.embed.grad.numpy() - (g_in + g_out)).max()
    assert err <= GRAD_RTOL * scale, err


def test_repeated_and_zero_weight_positions():
    """A masked position that appears twice gathers its row twice, and
    the gather's backward adds both rows' gradients; a position of weight
    0 contributes nothing."""
    p = _np_params()
    _, _, tm = _models(p)
    batch = _batch()
    tm.requires_grad_(True)
    hidden, _ = tm.apply(batch["tokens"], batch["token_types"])
    hidden.retain_grad()
    logits = tm.mlm_logits(hidden, batch["mlm_positions"])
    pos = batch["mlm_positions"]
    assert torch.equal(logits[0, 1], logits[0, 3])
    g1 = torch.autograd.grad(logits[0, 1].sum(), hidden, retain_graph=True)
    g2 = torch.autograd.grad(logits[0, 1].sum() + logits[0, 3].sum(),
                             hidden, retain_graph=True)
    np.testing.assert_allclose(g2[0][0, pos[0, 1]].numpy(),
                               2 * g1[0][0, pos[0, 1]].numpy(),
                               rtol=1e-6, atol=0)
    # the zero-weight slot: changing its label leaves the loss as it is
    args = [batch[k] for k in _ARGS]
    with torch.no_grad():
        base = float(tm.pretrain_loss(*args))
        labels = batch["mlm_labels"].copy()
        labels[1, 2] = (labels[1, 2] + 1) % V
        args[3] = labels
        assert float(tm.pretrain_loss(*args)) == base
        labels[1, 1] = (labels[1, 1] + 1) % V
        assert float(tm.pretrain_loss(*args)) != base


# ------------------------------------------------------------- training
def test_example_sgd_step_bitwise_with_reference():
    """``examples/bert_pretrain.py``'s update ``w - lr * g.astype(w.dtype)``
    on a bf16 model (and the f32 ``mlm_bias_v``), given the same grads:
    ``chip_smoke.example_sgd_step`` gives the reference's bits."""
    p = _np_params()
    _, jp, tm = _models(p, "bfloat16")
    rng = np.random.RandomState(4)
    grads = {n: rng.randn(*a.shape).astype(np.float32)
             for n, a in _flat(p).items()}
    params = dict(tm.named_parameters())
    # each grad in its parameter's dtype, as a backward gives it
    jflat = _flat(jp)
    jg = _nest({n: jnp.asarray(g).astype(jflat[n].dtype)
                for n, g in grads.items()})
    want = jax.tree_util.tree_map(
        lambda w, gw: w - LR * gw.astype(w.dtype), jp, jg)
    for n, prm in params.items():
        prm.grad = torch.from_numpy(grads[n]).to(prm.dtype)
    chip_smoke.example_sgd_step(list(params.values()), LR)
    for n, w in _flat(want).items():
        got = params[n].detach()
        assert got.dtype == (torch.float32 if n == "mlm_bias_v"
                             else torch.bfloat16), n
        w = np.asarray(jnp.asarray(w, jnp.float32))
        np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                      w.view(np.uint32), err_msg=n)


@pytest.mark.parametrize("tier", [True, False], ids=["tier-on", "tier-off"])
def test_three_adam_steps_through_the_list_route(tier):
    """Three Adam steps (lr 1e-3, wd 0.01, ``multi_precision``) of the
    small f32 model: the port updates its 18 tensors with one
    ``update_multi_precision`` call over lists (tier on: one fused step,
    each f32 tensor its own master), the reference one call per index
    (its f32 weights take its plain ``update`` either way; its tier stays
    off here, since its loss and gradients with the tier on are held by
    test_loss_and_gradients_match_reference).  Losses at 1e-5 relative
    at every step, as tests/test_torch_training.py's loop."""
    p = _np_params()
    jm, jp, tm = _models(p)
    batch = _batch()
    names = [n for n, _ in tm.named_parameters()]
    tm.requires_grad_(True)
    kw = dict(learning_rate=ADAM_LR, wd=ADAM_WD, multi_precision=True)
    jo, to = jmx.optimizer.Adam(**kw), mt.optimizer.Adam(**kw)
    jmx.config.set("kernels.enabled", False)
    jw = {n: _wrap(a) for n, a in _flat(jp).items()}
    jstate = {n: jo.create_state_multi_precision(i, jw[n])
              for i, n in enumerate(names)}
    params = [p_ for _, p_ in tm.named_parameters()]
    tstate = [to.create_state_multi_precision(i, w)
              for i, w in enumerate(params)]
    grad_fn = jax.jit(jax.value_and_grad(jm.pretrain_loss))
    jl, tl = [], []
    tt.reset()
    mt.config.set("kernels.enabled", tier)
    try:
        for _ in range(3):
            loss, grads = grad_fn(_nest({n: w._data for n, w in jw.items()}),
                                  *_jax_batch(batch))
            jl.append(float(loss))
            jg = _flat(grads)
            for i, n in enumerate(names):
                jo.update_multi_precision(i, jw[n], _wrap(jg[n]), jstate[n])
            tm.zero_grad(set_to_none=True)
            loss = tm.pretrain_loss(*(batch[k] for k in _ARGS))
            loss.backward()
            tl.append(float(loss.detach()))
            to.update_multi_precision(list(range(len(params))), params,
                                      [w.grad for w in params], tstate)
    finally:
        mt.config.unset("kernels.enabled")
        jmx.config.unset("kernels.enabled")
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[2] < tl[0]
    assert tt.counter("kernels.fused_step").value == (3 * 18 if tier else 0)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_same_loss_and_grads(remat):
    """``runtime.remat`` '' / 'dots' / 'full' in both packages: each
    package's loss and gradients under the policy equal its own without
    recomputation (f32 recomputation repeats the same operations: the
    port bitwise, the reference at GRAD_RTOL since XLA may fuse the
    recomputed body otherwise), and the two packages agree at LOSS_RTOL
    and GRAD_RTOL."""
    p = _np_params()
    jm, jp, tm = _models(p)
    batch = _batch()
    tm.requires_grad_(True)
    runs = {}
    for name in ("", remat):
        tm.zero_grad(set_to_none=True)
        with _Remat(name):
            jloss, jgrads = jax.value_and_grad(jm.pretrain_loss)(
                jp, *_jax_batch(batch))
            loss = tm.pretrain_loss(*(batch[k] for k in _ARGS))
            loss.backward()
        runs[name] = (float(jloss), _flat(jax.tree_util.tree_map(
            np.asarray, jgrads)), float(loss.detach()),
            {n: w.grad.clone() for n, w in tm.named_parameters()})
    (jl0, jg0, tl0, tg0), (jl, jg, tl, tg) = runs[""], runs[remat]
    assert tl == tl0
    assert abs(jl - jl0) <= LOSS_RTOL * abs(jl0)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    for n in tg:
        assert torch.equal(tg[n], tg0[n]), n
        scale = np.abs(jg0[n]).max()
        assert np.abs(jg[n] - jg0[n]).max() <= GRAD_RTOL * scale, n
        assert np.abs(tg[n].numpy() - jg[n]).max() <= GRAD_RTOL * scale, n


# bf16: both packages round weights and activations to bf16 (8 significant
# bits, 2^-9 relative per rounding) at their own points: the embedding
# sums, each layer's projections and residual adds, the MLM transform's
# norm.  The loss is a log-sum-exp over f32 logits whose inputs carry a
# few such roundings; each moves a logit by about 2^-9 of its size and
# logits here are O(1), so the loss moves by a few 2^-9 at most against
# its size of ~5: 2^-8 relative bounds it (measured 1.4e-4).
BF16_LOSS_RTOL = 2.0 ** -8


def test_bf16_loss_matches_reference():
    p = _np_params()
    jm, jp, tm = _models(p, "bfloat16")
    batch = _batch()
    jl = float(jm.pretrain_loss(jp, *_jax_batch(batch)))
    with torch.no_grad():
        tl = float(tm.pretrain_loss(*(batch[k] for k in _ARGS)))
    assert np.isfinite(tl)
    assert abs(tl - jl) <= BF16_LOSS_RTOL * abs(jl), (tl, jl)


# ------------------------------------------------------------ the kernels
def test_flash_checks_take_the_bert_calls_and_refuse_the_rest():
    """Every attention call BERT-base makes, bf16 and f32 (B=8, H=12,
    S=128, D=64, non-causal), passes the flash kernels' own checks; f16
    and head dims the kernels are not built for (f32 at 128, bf16 at 128)
    do not, and on a non-CPU tensor the wrappers raise
    ``KernelUnsupportedError`` (no fallback)."""
    for dt in (torch.bfloat16, torch.float32):
        q = torch.empty(8, 12, 128, 64, dtype=dt, device="meta")
        lse = torch.empty(96, 128, device="meta")
        assert ck.flash_unsupported_reason(q, q, q, False) is None
        assert ck.flash_bwd_unsupported_reason(q, q, q, q, lse, q,
                                               False) is None
    for q in (torch.empty(8, 12, 128, 64, dtype=torch.float16,
                          device="meta"),
              torch.empty(8, 12, 128, 128, device="meta"),
              torch.empty(8, 12, 128, 128, dtype=torch.bfloat16,
                          device="meta")):
        reason = ck.flash_unsupported_reason(q, q, q, False)
        assert reason is not None and ("f32 or bf16" in reason
                                       or "head dim" in reason), reason
        with pytest.raises(mt.KernelUnsupportedError):
            ck.flash_attention(q, q, q)
        lse = torch.empty(96, 128, device="meta")
        with pytest.raises(mt.KernelUnsupportedError):
            ck.flash_attention_bwd(q, q, q, q, lse, q)
    # the f32 plain versions are what the CPU runs: f32 through and
    # through (no rounding of P)
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 24, 64).astype(
        np.float32)) for _ in range(4))
    o, lse = ck.flash_attention(q, k, v)
    ref = torch.softmax(q @ k.transpose(-1, -2) / 8.0, -1) @ v
    assert o.dtype == torch.float32
    assert float((o - ref).abs().max()) <= 1e-6
    dq, dk, dv = ck.flash_attention_bwd(q, k, v, o, lse, do)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    (torch.softmax(qr @ kr.transpose(-1, -2) / 8.0, -1) @ vr).backward(do)
    for got, want in ((dq, qr.grad), (dk, kr.grad), (dv, vr.grad)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_bert_run_counts_one_flash_call_a_layer_in_both_dtypes():
    """The f32 and bf16 models reach ``kernels.attention`` once a layer
    with ``causal=False`` (the tier's counter) and never a causal call."""
    seen = []
    orig = ck.flash_attention

    def spy(q, k, v, causal=False, scale=None):
        seen.append((q.dtype, causal))
        return orig(q, k, v, causal=causal, scale=scale)

    p = _np_params()
    batch = _batch()
    for dtype in ("float32", "bfloat16"):
        _, _, tm = _models(p, dtype)
        ck.flash_attention, saved = spy, ck.flash_attention
        try:
            with _Tier(True), torch.no_grad():
                tm.pretrain_loss(*(batch[k] for k in _ARGS))
        finally:
            ck.flash_attention = saved
    assert seen == [(torch.float32, False)] * L + [(torch.bfloat16,
                                                    False)] * L
