"""Tensor and sequence parallelism in the port (Megatron splits and
``param_specs`` of TransformerLM, BERT and SPMDTrainer) against the
reference on the CPU.

One launch of 4 gloo ranks (tests/torch_mesh_worker.py, suite ``tp``)
runs every scenario; the reference runs each on 4 of the virtual CPU
devices, over the same mesh, from the same numpy weights (carried to the
ranks with ``convert.shard_params`` and gathered back with
``convert.gather_params``).

- ``__graft_entry__.dryrun_multichip``'s TransformerLM (f32) over ``{dp 1,
  tp 2, sp 2}``: the loss, the gradients and the weights after the
  dryrun's momentum SGD step, at the dryrun's bound (rtol 2e-4, atol
  1e-5, ``__graft_entry__.py:150-153``).
- A narrow BERT over ``{dp 2, tp 2}`` (the file's one group has 4 ranks),
  and over ``{dp 2, sp 2}`` (ring attention in the encoder, the heads on
  the sequence gathered whole): ``pretrain_loss`` within LOSS_RTOL and
  its gradients per tensor within GRAD_RTOL of the tensor's largest entry
  (tests/test_torch_bert.py's bounds).
- ``SPMDTrainer`` with ``param_specs`` splitting a Gluon MLP's Dense
  weights on ``tp`` over ``{dp 2, tp 2}``: 3 momentum SGD steps against
  the reference's trainer (losses and weights within MLP_ATOL), each rank
  storing its blocks; and over ``{dp 1, tp 4}`` bitwise with a one-rank
  trainer in the same worker.

Without a worker: every model over a mesh whose axes all have one rank
is bitwise the model without a mesh.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import mxnet_tpu as ref
import mxnet_tpu.name  # noqa: F401
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxLMCfg
from mxnet_tpu.models.bert import BERT as JaxBERT
from mxnet_tpu.models.bert import BERTConfig as JaxBERTCfg
from mxnet_tpu.parallel import SPMDTrainer as RefTrainer
from mxnet_tpu.parallel import make_mesh as ref_mesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import params_from_reference
from mxnet_tpu_torch.models import BERT, BERTConfig
from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                TransformerLMConfig)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

# __graft_entry__.py:150-153
LM_RTOL, LM_ATOL = 2e-4, 1e-5
# tests/test_torch_bert.py's LOSS_RTOL and GRAD_RTOL
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-5
# tests/test_torch_dist.py's LOSS_ATOL and SGD PARAM_ATOL (the same f32
# step over other summation orders)
MLP_LOSS_ATOL, MLP_ATOL = 2e-7, 1e-7


def _inputs():
    inp = {"lm/" + k: v for k, v in W.flat(W.lm_params()).items()}
    rng = np.random.RandomState(5)
    for name in ("lm_tokens", "lm_targets"):
        inp[name] = rng.randint(0, W.LM_CFG["vocab_size"], (W.LM_B, W.LM_S))
    inp.update({"bert/" + k: v for k, v in W.flat(W.bert_params()).items()})
    inp.update({"bert_batch/" + k: v for k, v in W.bert_batch().items()})
    for name, v in _mlp_init().items():
        inp["mlp/init/" + name] = v
    for s, (x, y) in enumerate(W.mlp_batches()):
        inp["mlp/x%d" % s], inp["mlp/y%d" % s] = x, y
    return inp


def _mlp_net():
    with ref.name.NameManager():
        net = W.mlp_net(ref)
    ref.random.seed(11)
    net.initialize(ref.init.Xavier())
    return net


def _mlp_init():
    return {n: p.data().asnumpy()
            for n, p in _mlp_net().collect_params().items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp = _inputs()
    return inp, W.launch(tmp_path_factory.mktemp("tp"), "tp", inp)


def _placed(mesh, params, specs):
    return jax.tree_util.tree_map(
        lambda v, s: jax.device_put(jnp.asarray(v), NamedSharding(mesh, s)),
        params, specs, is_leaf=lambda x: x is None)


def _same_on_every_rank(runs, prefix):
    for got in runs[1:]:
        for k in runs[0]:
            if k.startswith(prefix):
                assert got[k].tobytes() == runs[0][k].tobytes(), k


def test_transformer_lm_tp_sp_matches_reference(world):
    inp, runs = world
    _same_on_every_rank(runs, "lm/")
    mesh = ref_mesh(W.LM_MESH, jax.devices()[:W.RANKS])
    model = JaxLM(JaxLMCfg(dtype=jnp.float32, **W.LM_CFG), mesh=mesh)
    params = _placed(mesh, W.lm_params(), model.param_specs())
    batch = NamedSharding(mesh, P("dp", "sp"))
    tokens, targets = (jax.device_put(jnp.asarray(inp[n], jnp.int32), batch)
                       for n in ("lm_tokens", "lm_targets"))
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, tokens,
                                                          targets)
    got = runs[0]
    np.testing.assert_allclose(got["lm/loss"], float(loss), rtol=LM_RTOL)
    after = jax.tree_util.tree_map(
        lambda w, g: w - jnp.asarray(W.LM_LR, w.dtype)
        * (W.LM_MOMENTUM * jnp.zeros_like(w) + g), params, grads)
    for name, g in W.flat(jax.tree_util.tree_map(np.asarray, grads)).items():
        np.testing.assert_allclose(got["lm/grad/" + name], g, rtol=LM_RTOL,
                                   atol=LM_ATOL, err_msg=name)
    for name, w in W.flat(jax.tree_util.tree_map(np.asarray, after)).items():
        np.testing.assert_allclose(got["lm/after/" + name], w, rtol=LM_RTOL,
                                   atol=LM_ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["bert", "bert_sp"])
def test_bert_tp_matches_reference(world, case):
    inp, runs = world
    _same_on_every_rank(runs, case + "/")
    axes = W.BERT_MESH if case == "bert" else W.BERT_SP_MESH
    mesh = ref_mesh(axes, jax.devices()[:W.RANKS])
    model = JaxBERT(JaxBERTCfg(dtype=jnp.float32, **W.BERT_CFG), mesh=mesh)
    params = _placed(mesh, W.bert_params(), model.param_specs())
    batch = W.bert_batch()
    args = [jnp.asarray(batch[k]) for k in W.BERT_ARGS]
    loss, grads = jax.jit(jax.value_and_grad(model.pretrain_loss))(params,
                                                                   *args)
    got = runs[0]
    np.testing.assert_allclose(got[case + "/loss"], float(loss),
                               rtol=LOSS_RTOL)
    for name, g in W.flat(jax.tree_util.tree_map(np.asarray, grads)).items():
        scale = float(np.abs(g).max())
        err = float(np.abs(got[case + "/grad/" + name] - g).max()) / scale
        assert err <= GRAD_RTOL, (name, err)


def test_spmd_trainer_param_specs_matches_reference(world):
    inp, runs = world
    _same_on_every_rank(runs, "mlp/param/")
    net = _mlp_net()
    specs = {net.prefix + n: P(*s) for n, s in W.MLP_SPECS.items()}
    tr = RefTrainer(net, ref.gluon.loss.L2Loss(), "sgd", dict(W.MLP_OPT),
                    mesh=ref_mesh(W.MLP_MESH, jax.devices()[:W.RANKS]),
                    param_specs=specs)
    losses = [float(tr.step(x, y)) for x, y in W.mlp_batches()]
    tr.sync()
    got = runs[0]
    np.testing.assert_allclose(got["mlp/loss"], losses, rtol=0,
                               atol=MLP_LOSS_ATOL)
    for name, p in net.collect_params().items():
        np.testing.assert_allclose(got["mlp/param/" + name],
                                   p.data().asnumpy(), rtol=0,
                                   atol=MLP_ATOL, err_msg=name)
        # each rank stores its block: split on tp, whole over dp
        shape = list(p.shape)
        for d, axis in enumerate(W.MLP_SPECS.get(name[len(net.prefix):],
                                                 ())):
            if axis is not None:
                shape[d] //= W.MLP_MESH[axis]
        assert list(got["mlp/shard_shape/" + name]) == shape, name
    assert all(bool(r["mlp/one_rank_bitwise"]) for r in runs)


def test_sharded_models_refuse_what_is_not_ported(world):
    """On a mesh with tp ranks SPMDTrainer's routed row-sparse table and
    its 2-bit compressed step raise, each with its reason."""
    _, runs = world
    for got in runs:
        assert "row-sparse embedding route" in str(got["mlp/routed_refused"])
        assert "data-parallel meshes" in str(got["mlp/compressed_refused"])


# ------------------------------------------- one-rank axes, no worker
def _bitwise_grads(make, loss_of):
    """The loss and gradients of ``make(mesh)`` over an all-ones mesh and
    of ``make(None)``, from the same weights: bitwise alike."""
    mesh = mt.parallel.make_mesh({"dp": 1, "tp": 1, "sp": 1}, [mt.cpu()])
    plain = make(None).init(3)
    meshed = make(mesh)
    meshed.load_state_dict(plain.state_dict())
    out = []
    for m in (plain, meshed):
        m.requires_grad_(True)
        loss = loss_of(m)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    m.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for n, g in out[0][1].items():
        assert torch.equal(g, out[1][1][n]), n


def test_one_rank_axes_are_bitwise_the_plain_transformer():
    cfg = TransformerLMConfig(dtype=torch.float32, **W.LM_CFG)
    rng = np.random.RandomState(6)
    tok = rng.randint(0, cfg.vocab_size, (W.LM_B, W.LM_S))
    _bitwise_grads(lambda mesh: TransformerLM(cfg, mesh=mesh, device="cpu"),
                   lambda m: m.loss(tok, tok))


def test_one_rank_axes_are_bitwise_the_plain_bert():
    cfg = BERTConfig(dtype=torch.float32, **W.BERT_CFG)
    batch = W.bert_batch()
    _bitwise_grads(lambda mesh: BERT(cfg, mesh=mesh, device="cpu"),
                   lambda m: m.pretrain_loss(*(batch[k]
                                               for k in W.BERT_ARGS)))


def test_shard_params_round_trip():
    """``shard_params`` on a one-rank mesh keeps every tensor whole, and
    ``gather_params`` gives the reference's tree back."""
    mesh = mt.parallel.make_mesh({"tp": 1}, [mt.cpu()])
    tree = W.lm_params()
    model = TransformerLM(TransformerLMConfig(dtype=torch.float32,
                                              **W.LM_CFG), device="cpu")
    shards = mt.convert.shard_params(tree, model.param_specs(), mesh)
    whole = params_from_reference(tree)
    assert all(torch.equal(shards[n], whole[n]) for n in whole)
    back = mt.convert.gather_params(shards, model.param_specs(), mesh)
    for name, v in W.flat(tree).items():
        assert W.flat(back)[name].tobytes() == v.tobytes(), name
