"""Pipeline (``pp``) and expert (``ep``) parallelism in the port
(``parallel.pipeline``, ``parallel.moe``) against the reference on the
CPU.

One launch of 4 gloo ranks (tests/torch_mesh_worker.py, suite ``pipe``)
runs every scenario; the reference runs each on 4 of the virtual CPU
devices, over the same mesh, from the same numpy inputs.  Bounds follow
the reference's tests/test_pipeline_moe.py:

- ``pipeline_sharded`` over 4 stages: outputs at rtol 1e-5 / atol 1e-6
  (``:50-51``), the loss at rtol 1e-5 and the gradients at rtol 1e-4 /
  atol 1e-6 (``:72-75``);
- ``moe_ffn_sharded`` over ``{dp 2, ep 2}`` (top-2, capacity factor 2):
  outputs at rtol 1e-4 / atol 1e-5 (``:124``), and the same bound for the
  aux loss and the gradients of a loss over both;
- ``__graft_entry__._dryrun_pipeline_moe(4)``'s step (a 2-stage pipeline
  of top-1 MoE stages over ``{dp 1, pp 2, ep 2}``): the loss at rtol 1e-5
  and the parameters after the SGD step at rtol 1e-4 / atol 1e-6;
- ``top_k_routing`` on one rank, no worker: dispatch bitwise, combine and
  the aux loss within 1e-6.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from mxnet_tpu.parallel import (make_mesh, microbatch, moe_ffn,
                                moe_ffn_sharded, pipeline_sharded,
                                top_k_routing)
from mxnet_tpu.parallel.pipeline import pipeline_apply, shmap

from mxnet_tpu_torch.parallel import top_k_routing as port_routing

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

PIPE_FWD = dict(rtol=1e-5, atol=1e-6)
PIPE_GRAD = dict(rtol=1e-4, atol=1e-6)
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
ROUTING_ATOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp = {}
    for pre, d in (("pipe/", W.pipe_inputs()), ("moe/", W.moe_inputs()),
                   ("ppmoe/", W.ppmoe_inputs())):
        inp.update({pre + k: v for k, v in d.items()})
    return W.launch(tmp_path_factory.mktemp("pipe"), "pipe", inp)


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def test_pipeline_matches_reference(world):
    inp = W.pipe_inputs()
    mesh = make_mesh({"pp": W.PIPE_STAGES}, jax.devices()[:W.PIPE_STAGES])
    params = {k: jnp.asarray(inp[k]) for k in ("w", "b")}

    def loss(p):
        y = pipeline_sharded(mesh, _stage, p, jnp.asarray(inp["x"]),
                             n_micro=W.PIPE_M)
        return jnp.mean((y - jnp.asarray(inp["t"])) ** 2), y

    (want_loss, want_y), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    for got in world:
        np.testing.assert_allclose(got["pipe/y"], np.asarray(want_y),
                                   **PIPE_FWD)
        np.testing.assert_allclose(got["pipe/loss"], float(want_loss),
                                   rtol=LOSS_RTOL)
        for k, g in grads.items():
            np.testing.assert_allclose(got["pipe/grad/" + k], np.asarray(g),
                                       err_msg=k, **PIPE_GRAD)


def test_moe_matches_reference(world):
    inp = W.moe_inputs()
    mesh = make_mesh(W.MOE_MESH, jax.devices()[:W.RANKS])
    ws = tuple(jnp.asarray(inp[n]) for n in W.MOE_NAMES)

    def loss(ws):
        y, aux = moe_ffn_sharded(mesh, *ws, jnp.asarray(inp["x"]),
                                 k=W.MOE_K, capacity_factor=W.MOE_CF)
        return jnp.mean(y ** 2) + W.MOE_AUX_WEIGHT * aux, (y, aux)

    (_, (want_y, want_aux)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(ws)
    for got in world:
        np.testing.assert_allclose(got["moe/y"], np.asarray(want_y),
                                   **MOE_TOL)
        np.testing.assert_allclose(got["moe/aux"], float(want_aux),
                                   **MOE_TOL)
        for n, g in zip(W.MOE_NAMES, grads):
            np.testing.assert_allclose(got["moe/grad/" + n], np.asarray(g),
                                       err_msg=n, **MOE_TOL)


def _ref_pipelined_moe(inp):
    """``__graft_entry__._dryrun_pipeline_moe``'s step for 4 devices,
    returning its loss and the updated parameters."""
    mesh = make_mesh(W.PPMOE_MESH, jax.devices()[:W.RANKS])
    params = {k: jnp.asarray(inp[k]) for k in W.PPMOE_SPECS}
    xm = microbatch(jnp.asarray(inp["x"]), W.PPMOE_M)
    tm = microbatch(jnp.asarray(inp["t"]), W.PPMOE_M)

    def local(p, xs, ts):
        mine = jax.tree_util.tree_map(lambda v: v[0], p)

        def stage(sp, act):
            y, _aux = moe_ffn(sp["gate"], sp["w1"], sp["b1"], sp["w2"],
                              sp["b2"], act, axis_name="ep", k=1,
                              capacity_factor=4.0)
            return act + y

        y = pipeline_apply(stage, mine, xs, axis_name="pp",
                           vary_axes=("dp", "pp", "ep"))
        return lax.pmean(jnp.mean((y - ts) ** 2), ("dp", "ep"))

    pspec = {k: P(*s) for k, s in W.PPMOE_SPECS.items()}
    tok = P(None, "dp")

    def loss_fn(p):
        return shmap(local, mesh, (pspec, tok, tok), P())(p, xm, tm)

    @jax.jit
    def step(p):
        loss, g = jax.value_and_grad(loss_fn)(p)
        return jax.tree_util.tree_map(lambda w, gg: w - W.PPMOE_LR * gg, p,
                                      g), loss

    return step(params)


def test_pipelined_moe_step_matches_reference(world):
    after, loss = _ref_pipelined_moe(W.ppmoe_inputs())
    for got in world:
        np.testing.assert_allclose(got["ppmoe/loss"], float(loss),
                                   rtol=LOSS_RTOL)
        for k, w in after.items():
            np.testing.assert_allclose(got["ppmoe/after/" + k],
                                       np.asarray(w), err_msg=k, **PIPE_GRAD)


@pytest.mark.parametrize("k", [1, 2])
def test_top_k_routing_matches_reference(k):
    rng = np.random.RandomState(12 + k)
    logits = rng.normal(size=(24, 4)).astype(np.float32)
    logits[3] = logits[4]            # ties and repeated rows
    logits[5, :2] = logits[5, 2:4] = 0.5
    capacity = 5                      # some tokens overflow
    want = [np.asarray(a) for a in top_k_routing(jnp.asarray(logits), k,
                                                 capacity)]
    got = [a.numpy() for a in port_routing(torch.as_tensor(logits), k,
                                           capacity)]
    assert got[0].tobytes() == want[0].tobytes()
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ROUTING_ATOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=ROUTING_ATOL)
