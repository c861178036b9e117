"""Ring attention over a sequence axis in the port
(``parallel.ring_attention``) against the reference on the CPU.

One launch of 4 gloo ranks (tests/torch_mesh_worker.py, suite ``ring``)
runs ``ring_self_attention_sharded`` over ``{dp 1, tp 2, sp 2}``, causal
and not, forward and the gradients of a weighted sum; the reference runs
the same on 4 of the virtual CPU devices.  Bounds are the reference's own
(tests/test_parallel.py): forward within 2e-5 and gradients within 3e-5
(absolute and relative), against the reference's ring and its full
attention.  Every rank holds the whole result.
"""
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mxnet_tpu.parallel import make_mesh
from mxnet_tpu.parallel.ring_attention import (attention,
                                               ring_self_attention_sharded)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

# tests/test_parallel.py:28-38 (forward) and :420-450 (gradients)
FWD_TOL, GRAD_TOL = 2e-5, 3e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = W.ring_inputs()
    return inp, W.launch(tmp_path_factory.mktemp("ring"), "ring",
                         {"ring/" + k: v for k, v in inp.items()})


def _reference(inp, causal, ring):
    mesh = make_mesh(W.RING_MESH, jax.devices()[:W.RANKS])
    w = jnp.asarray(inp["w"])

    def loss(q, k, v):
        out = ring_self_attention_sharded(mesh, q, k, v, causal=causal) \
            if ring else attention(q, k, v, causal=causal)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(inp[n]) for n in "qkv"))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("ring", [True, False], ids=["vs_ring", "vs_full"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_reference(ranks, causal, ring):
    inp, runs = ranks
    want_out, want_grads = _reference(inp, causal, ring)
    tag = "causal" if causal else "full"
    for got in runs:
        np.testing.assert_allclose(got[tag + "/out"], want_out, rtol=FWD_TOL,
                                   atol=FWD_TOL)
        for n, want in zip("qkv", want_grads):
            np.testing.assert_allclose(got["%s/d%s" % (tag, n)], want,
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=n)


def test_ring_hops_and_routes(ranks):
    """Each of the 2 passes (causal and not) takes one hop of K and V
    forward and its reverse backward; on CPU tensors gloo takes the
    native route."""
    _, runs = ranks
    for got in runs:
        assert int(got["ppermute_native"]) == 4
        assert int(got["ppermute_host"]) == 0
