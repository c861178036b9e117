"""BatchNorm statistics over the ranks in the port (``SPMDTrainer``'s
multi-rank step and ``gluon.contrib.nn.SyncBatchNorm``) against the
reference on the CPU.

One launch of 4 gloo ranks (tests/torch_mesh_worker.py, suite ``bn``)
runs every scenario; the reference runs each on 4 of the virtual CPU
devices over the same mesh, from the same numpy weights.

- A narrow conv-SyncBatchNorm-ReLU net through ``SPMDTrainer`` (3
  momentum SGD steps) on ``{dp 4}`` and ``{dp 2, tp 2}``, with the
  shifted single-pass and the two-pass statistics, and with padded
  batches: the losses, weights and moving statistics against the
  reference's trainer within STEP_RTOL of each tensor's largest entry,
  the moving statistics bitwise alike on every rank, and the checkpoint
  rank 0 writes holding them.
- The BatchNorm op alone over ``{dp 4}`` (each rank its rows): the output,
  the batch statistics and the gradients of ``sum(out * w)`` against
  ``jax.grad`` of the reference's op over the whole batch.  With an
  identity backward for the statistics' sum, each rank's ``dx`` would
  miss the other ranks' share and this case fails.
"""
import os
import pickle
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as ref
import mxnet_tpu.name  # noqa: F401
from mxnet_tpu.ops import nn as ref_nn
from mxnet_tpu.parallel import SPMDTrainer as RefTrainer
from mxnet_tpu.parallel import make_mesh as ref_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

# the same f32 step over other summation orders: the per-rank sums of the
# statistics and of the gradients differ from XLA's in their last bits,
# and three momentum steps carry that forward
STEP_RTOL = 2e-5
# the op alone: one summation order against another
OP_RTOL = 2e-6


def _ref_net():
    with ref.name.NameManager():
        net = W.bn_net(ref)
    ref.random.seed(13)
    net.initialize(ref.init.Xavier())
    return net


def _inputs():
    inp = {"bn/init/" + n: p.data().asnumpy()
           for n, p in _ref_net().collect_params().items()}
    for s, (x, y) in enumerate(W.bn_batches()):
        inp["bn/x%d" % s], inp["bn/y%d" % s] = x, y
    inp.update({"bnop/" + k: v for k, v in W.bn_op_inputs().items()})
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("bn")
    inp = _inputs()
    return inp, W.launch(workdir, "bn", inp), workdir


def _reference_run(mesh_name, two_pass, pad):
    net = _ref_net()
    ref.config.set("bn_two_pass_stats", two_pass)
    try:
        tr = RefTrainer(net, ref.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        dict(W.BN_OPT),
                        mesh=ref_mesh(W.BN_MESHES[mesh_name],
                                      jax.devices()[:W.RANKS]))
        losses = [float(tr.step(x, y, pad=pad)) for x, y in W.bn_batches()]
        tr.sync()
    finally:
        ref.config.set("bn_two_pass_stats", False)
    return losses, {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}


def _close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("run", [r[0] for r in W.BN_RUNS])
def test_spmd_trainer_sync_batchnorm_matches_reference(world, run):
    inp, runs, _ = world
    _, mesh_name, two_pass, pad = next(r for r in W.BN_RUNS if r[0] == run)
    losses, params = _reference_run(mesh_name, two_pass, pad)
    got = runs[0]
    _close(got["bn/%s/loss" % run], np.array(losses), STEP_RTOL, "loss")
    aux = [n for n in params if "running" in n]
    assert len(aux) == 4
    prefix = "bn/%s/param/" % run
    names = sorted(k[len(prefix):] for k in got if k.startswith(prefix))
    assert len(names) == len(params)
    for pn, rn in zip(names, sorted(params)):
        _close(got[prefix + pn], params[rn], STEP_RTOL, (run, rn))
    # every rank holds the same moving statistics, bit for bit
    key = "bn/%s/aux_rank/" % run
    for r in runs[1:]:
        for k in got:
            if k.startswith(key):
                assert r[k].tobytes() == got[k].tobytes(), (run, k)
    # and every rank's weights after sync are the same too
    for r in runs[1:]:
        for k in got:
            if k.startswith(prefix):
                assert r[k].tobytes() == got[k].tobytes(), (run, k)


def test_checkpoint_holds_every_ranks_moving_statistics(world):
    _, runs, workdir = world
    with open(os.path.join(str(workdir), "bn.ckpt"), "rb") as f:
        host = pickle.load(f)
    run = W.BN_RUNS[-1][0]
    key = "bn/%s/aux_rank/" % run
    saved = {n: v for n, v in host["params"].items() if "running" in n}
    assert len(saved) == 4
    for n, v in saved.items():
        for r in runs:
            assert r[key + n].tobytes() == np.asarray(v).tobytes(), n


@pytest.mark.parametrize("mode", ["shifted", "two_pass"])
def test_batchnorm_op_over_ranks_matches_global_batch(world, mode):
    inp, runs, _ = world
    op = {k: jnp.asarray(v) for k, v in W.bn_op_inputs().items()}
    ref.config.set("bn_two_pass_stats", mode == "two_pass")
    try:
        def f(x, gamma, beta):
            y, mean, var = ref_nn._batch_norm(
                x, gamma, beta, op["mean"], op["var"], eps=1e-5,
                fix_gamma=False, training=True)
            return jnp.sum(y * op["w"]), (y, mean, var)
        (_, (y, mean, var)), (dx, dg, db) = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(op["x"], op["gamma"],
                                                op["beta"])
    finally:
        ref.config.set("bn_two_pass_stats", False)
    tag = "bnop/%s/" % mode
    rows = W.BN_OP_SHAPE[0] // W.RANKS
    got_y = np.concatenate([r[tag + "y"] for r in runs])
    got_dx = np.concatenate([r[tag + "dx"] for r in runs])
    assert all(r[tag + "y"].shape[0] == rows for r in runs)
    _close(got_y, np.asarray(y), OP_RTOL, "y")
    _close(got_dx, np.asarray(dx), OP_RTOL, "dx")
    # gamma and beta are every rank's: their gradients sum over the ranks
    _close(sum(r[tag + "dgamma"] for r in runs), np.asarray(dg), OP_RTOL,
           "dgamma")
    _close(sum(r[tag + "dbeta"] for r in runs), np.asarray(db), OP_RTOL,
           "dbeta")
    for r in runs:
        _close(r[tag + "mean"], np.asarray(mean), OP_RTOL, "mean")
        _close(r[tag + "var"], np.asarray(var), OP_RTOL, "var")
        assert r[tag + "mean"].tobytes() == runs[0][tag + "mean"].tobytes()
