"""The port's training path held against the reference's, on the CPU.

TransformerLM training is ``loss = model.loss(tokens, targets)`` ->
``loss.backward()`` -> ``Adam.update_multi_precision`` per parameter.
Inputs and weights are made by numpy from a seed and handed to both
packages (``convert.params_from_reference``); the reference's Pallas
kernels run in interpret mode (tier on) or its XLA lowering (tier off).

Tolerances, each stated where it is used:

* the optimizer: bitwise (the port's plain Adam epilogue repeats the
  reference's roundings, FMAs included);
* the loss: 1e-6 relative (f32; the packages sum in different orders);
* the gradients: per tensor, max |port - reference| <= GRAD_RTOL x max
  |reference| of that tensor;
* a 3-step loop: its losses, 1e-5 relative, and its weights to the bound
  Adam's step size gives (see the test).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.models.transformer import TransformerLM as JaxLM
from mxnet_tpu.models.transformer import TransformerLMConfig as JaxCfg
from mxnet_tpu.ndarray.ndarray import _wrap

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import params_from_reference, params_to_reference
from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                TransformerLMConfig)

V, L, D, H, F, S, B = 256, 2, 128, 2, 256, 64, 2
LR, WD = 1e-3, 0.01
# f32 gradients over B*S = 128 positions and a 256-way softmax: the two
# packages reduce in different orders, a few f32 ulps of each tensor's
# largest entry (measured at most 9.1e-7, tier on and off; bounded at
# 1e-5).
GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-6


def _np_params(seed=0, heads=H):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(0.0, 0.02, size=shape).astype(np.float32)

    return {
        "embed": mk(V, D),
        "pos_embed": mk(S, D),
        "final_norm": np.ones((D,), np.float32),
        "layers": {
            "ln1": np.ones((L, D), np.float32),
            "wqkv": mk(L, D, 3, heads, D // heads),
            "wo": mk(L, heads, D // heads, D),
            "ln2": np.ones((L, D), np.float32),
            "w1": mk(L, D, F),
            "w2": mk(L, F, D),
        },
    }


def _batch(seed=1):
    toks = np.random.default_rng(seed).integers(0, V, (B, S + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


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


def _models(p, heads=H):
    jm = JaxLM(JaxCfg(vocab_size=V, num_layers=L, d_model=D,
                      num_heads=heads, d_ff=F, max_len=S,
                      dtype=jnp.float32))
    tm = TransformerLM(TransformerLMConfig(
        vocab_size=V, num_layers=L, d_model=D, num_heads=heads, d_ff=F,
        max_len=S, dtype=torch.float32), device="cpu")
    tm.load_state_dict(params_from_reference(p))
    return jm, tm


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


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("tier", [True, False], ids=["tier-on", "tier-off"])
def test_update_multi_precision_bitwise_with_reference(tier):
    """bf16 weight over an f32 master, Adam with L2 wd, three updates of
    the same bf16 grads: the bf16 weight, the master, m and v equal the
    reference's bit for bit.  Tier on, both packages take their fused
    step (one ``kernels.fused_step`` per update); tier off, their plain
    ``step``."""
    rng = np.random.RandomState(8)
    w0 = (rng.randn(33, 17) * 0.02).astype(np.float32)
    grads = [rng.randn(33, 17).astype(np.float32) for _ in range(3)]
    jo = jmx.optimizer.Adam(learning_rate=LR, wd=WD, multi_precision=True)
    to = mt.optimizer.create("adam", learning_rate=LR, wd=WD,
                             multi_precision=True)
    jw = jmx.nd.array(w0, dtype="bfloat16")
    tw = torch.from_numpy(w0).to(torch.bfloat16)
    jstate = jo.create_state_multi_precision(0, jw)
    tstate = to.create_state_multi_precision(0, tw)
    jtel.reset()
    tt.reset()
    with _Tier(tier):
        for i, g in enumerate(grads):
            jo.update_multi_precision(0, jw, jmx.nd.array(g, dtype="bfloat16"),
                                      jstate)
            to.update_multi_precision(0, tw, torch.from_numpy(g).to(
                torch.bfloat16), tstate)
            fused = tt.counter("kernels.fused_step").value
            assert fused == ((i + 1) if tier else 0)
            assert jtel.counter("kernels.fused_step").value == fused
    assert tw.dtype == torch.bfloat16
    pairs = [(jw._data, tw), (jstate[0]._data, tstate[0]),
             (jstate[1][0]._data, tstate[1][0]),
             (jstate[1][1]._data, tstate[1][1])]
    for want, got in pairs:
        want = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                      want.view(np.uint32))


def test_optimizer_registry_and_state():
    o = mt.optimizer.create("Adam", learning_rate=0.5)
    assert isinstance(o, mt.optimizer.Adam) and o.learning_rate == 0.5
    assert o.fused_step and o.jit_safe
    assert isinstance(mt.optimizer.create("sgd"), mt.optimizer.SGD)
    assert isinstance(mt.optimizer.create("rmsprop"), mt.optimizer.RMSProp)
    with pytest.raises(ValueError, match="nosuchopt"):
        mt.optimizer.create("nosuchopt")
    w = torch.zeros(4, 3, dtype=torch.bfloat16)
    master, (m, v) = mt.optimizer.Adam(
        multi_precision=True).create_state_multi_precision(0, w)
    assert master.dtype == m.dtype == v.dtype == torch.float32
    # without multi_precision a bf16 weight keeps bf16 state
    m, v = mt.optimizer.Adam().create_state_multi_precision(0, w)
    assert m.dtype == torch.bfloat16
    # lr/wd multipliers, by name through idx2name, and the update count
    o = mt.optimizer.Adam(learning_rate=0.1, wd=0.2,
                          param_idx2name={0: "fc_weight", 1: "fc_bias"})
    o.set_lr_mult({"fc_weight": 0.5})
    assert o._get_lr(0) == 0.05 and o._get_lr(1) == 0.1
    assert o._get_wd(0) == 0.2 and o._get_wd(1) == 0.0
    o._update_count(0)
    o._update_count(0)
    assert o._index_update_count[0] == 2 and o.num_update == 2


def test_rescaled_grad_goes_through_f32_preprocessing():
    """With ``rescale_grad`` != 1 the fused step gets the grad widened to
    f32 and rescaled first, as the reference does: bitwise equal to
    rescaling the grad by hand and updating with ``rescale_grad`` 1."""
    rng = np.random.RandomState(9)
    w0 = torch.from_numpy((rng.randn(8, 8) * 0.02).astype(np.float32))
    g = torch.from_numpy(rng.randn(8, 8).astype(np.float32)).to(
        torch.bfloat16)
    out = []
    for rescale, grad in ((0.5, g), (1.0, g.float() * 0.5)):
        o = mt.optimizer.Adam(multi_precision=True, rescale_grad=rescale)
        w = w0.to(torch.bfloat16)
        state = o.create_state_multi_precision(0, w)
        with _Tier(True):
            o.update_multi_precision(0, w, grad, state)
        out.append(state[0])
    assert torch.equal(out[0], out[1])


# the two head dims the f32 flash kernels take: 2 heads of 64 and 4 heads
# of 32 (bench.py transformer_kernels_config's f32 model has heads of 32)
_TIER_HEADS = pytest.mark.parametrize("tier,heads", [
    (True, H), (False, H), (True, 4), (False, 4)],
    ids=["tier-on", "tier-off", "tier-on-head-dim-32",
         "tier-off-head-dim-32"])


# ----------------------------------------------------------- gradients
@_TIER_HEADS
def test_loss_and_gradients_match_reference(tier, heads):
    """``TransformerLM.loss`` and its gradients against
    ``jax.value_and_grad(JaxLM.loss)`` on a small f32 model (vocab 256,
    2 layers, d_model 128, 2 heads of 64 or 4 of 32, d_ff 256; B=2,
    S=64).  Tier on, the port's attention is the flash autograd Function
    and the reference's the Pallas custom VJP (interpret mode)."""
    p = _np_params(heads=heads)
    jm, tm = _models(p, heads)
    toks, tgts = _batch()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tm.requires_grad_(True)
    jtel.reset()
    tt.reset()
    with _Tier(tier):
        jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jnp.asarray(toks),
                                                    jnp.asarray(tgts))
        loss = tm.loss(toks, tgts)
        loss.backward()
    # the port counts each layer's call; the reference counts traces of
    # its scanned layer body
    assert tt.counter("kernels.flash_attention").value == (L if tier else 0)
    assert (jtel.counter("kernels.flash_attention").value > 0) == tier
    jl, tl = float(jloss), float(loss.detach())
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    jg = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, prm in tm.named_parameters():
        want = jg[name]
        got = prm.grad.numpy()
        err = np.abs(got - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (name, err)


# ---------------------------------------------------------- a 3-step loop
@_TIER_HEADS
def test_three_step_loop_matches_reference(tier, heads):
    """Three Adam steps (lr 1e-3, wd 0.01) of the small f32 model (heads
    of 64 or of 32) on one batch, in both packages, each from its own
    gradients.

    Losses: 1e-5 relative at every step.  Weights: Adam normalises each
    step by the gradient's running RMS, so an entry whose gradient is
    near zero can take a step of the other sign from a rounding-level
    difference: the two runs may differ by two steps in such an entry.
    A step is at most ``lr * |m_hat| / sqrt(v_hat)``, which for t <= 3
    and beta1 0.9, beta2 0.999 is at most 1.01 lr (Cauchy-Schwarz over
    the bias-corrected averages; wd * |w| adds under 1e-3 of it), so after
    3 steps no weight may differ by more than 3 x 2 x 1.01 lr."""
    p = _np_params(heads=heads)
    jm, tm = _models(p, heads)
    toks, tgts = _batch()
    names = [n for n, _ in tm.named_parameters()]
    tm.requires_grad_(True)
    jo = jmx.optimizer.Adam(learning_rate=LR, wd=WD)
    to = mt.optimizer.Adam(learning_rate=LR, wd=WD)
    jw = {n: _wrap(jnp.asarray(a)) for n, a in _flat(p).items()}
    jstate = {n: jo.create_state(i, jw[n]) for i, n in enumerate(names)}
    params = dict(tm.named_parameters())
    tstate = {n: to.create_state(i, params[n]) for i, n in enumerate(names)}
    grad_fn = jax.value_and_grad(jm.loss)
    jl, tl = [], []
    with _Tier(tier):
        for _ in range(3):
            tree = _nest({n: w._data for n, w in jw.items()})
            loss, grads = grad_fn(tree, jnp.asarray(toks), jnp.asarray(tgts))
            jl.append(float(loss))
            jg = _flat(grads)
            for i, n in enumerate(names):
                jo.update_multi_precision(i, jw[n], _wrap(jg[n]), jstate[n])
            tm.zero_grad(set_to_none=True)
            loss = tm.loss(toks, tgts)
            loss.backward()
            tl.append(float(loss.detach()))
            for i, n in enumerate(names):
                to.update_multi_precision(i, params[n], params[n].grad,
                                          tstate[n])
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[2] < tl[0]
    bound = 3 * 2 * 1.01 * LR
    got = params_to_reference(tm.state_dict())
    for n in names:
        want = np.asarray(jw[n]._data)
        assert np.abs(_flat(got)[n] - want).max() <= bound, n


def test_params_to_reference_inverts_params_from_reference():
    p = _np_params()
    sd = params_from_reference(p)
    back = params_to_reference(sd)
    flat_p, flat_b = _flat(p), _flat(back)
    assert flat_p.keys() == flat_b.keys()
    for n in flat_p:
        np.testing.assert_array_equal(flat_b[n], flat_p[n])
    # bf16 comes back as f32, exactly
    bf = {"embed": torch.tensor([[1.5, -0.0078125]], dtype=torch.bfloat16)}
    out = params_to_reference(bf)["embed"]
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, [[1.5, -0.0078125]])


def test_apply_stays_without_autograd():
    """``apply`` (serving) builds no graph even with gradients switched
    on; ``loss`` does, and the default model has them off."""
    _, tm = _models(_np_params())
    toks, tgts = _batch()
    assert not any(p.requires_grad for p in tm.parameters())
    tm.requires_grad_(True)
    assert tm.apply(toks).grad_fn is None
    assert tm.loss(toks, tgts).grad_fn is not None
