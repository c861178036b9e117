"""Paged generation over a mesh in the port (``TransformerLM.prefill`` and
``decode_step`` under ``tp``, ``sp`` and ``dp`` ranks, and
``convert.shard_kv`` / ``gather_kv``) against the reference on the CPU.

One launch of 4 gloo ranks (tests/torch_mesh_worker.py, suite
``decode``) runs a 2-layer, 4-head TransformerLM's prefill of two
prompts (lengths 13 and 7, padded to 16, pages of 4, one row's tail
entries the sentinel) and 8 decode steps fed with fixed tokens (teacher
forcing), on ``{tp 2, sp 2}``, ``{dp 2, tp 2}`` and ``{tp 4}``, with f32,
bf16 and int8 pages.  The reference runs the same calls on one device
(over a mesh it computes the same global arrays) from the same weights.

- Every step's global logits, on every rank, within LOGIT_RTOL of the
  reference's (of the step's largest logit).
- The pages each rank's rows own, gathered over ``tp``, against the
  reference's pool: f32 and bf16 payloads within the logits' bound of
  the pool's largest entry, int8 payloads within one step, and the int8
  scales.  Pages no row owns stay zero, so the sentinel's writes were
  dropped on every rank.
- Prefill ran ``kernels.attention`` once a layer under ``tp`` alone (and
  ring attention under ``sp``), and every decode step ran
  ``kernels.paged_attention_pool`` once a layer, over the rank's heads.
- ``gather_kv(shard_kv(pool))`` is the pool, bit for bit.
"""
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxLMCfg

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

# f32: one summation order against another (the tp sums of f32 partials,
# the ring's blockwise softmax); bf16: the same in a model whose
# activations round to 8 bits; int8: f32 on int8 pages, both packages
# quantizing the same rows (a row whose K/V rounds one step apart moves
# the logits by that step's share)
LOGIT_RTOL = {"f32": 2e-5, "bf16": 3e-2, "int8": 2e-3}
POOL_RTOL = {"f32": 2e-5, "bf16": 2e-2}


def _inputs():
    inp = {"lm/" + k: v for k, v in W.flat(W.lm_params()).items()}
    inp.update({"dec/" + k: v for k, v in W.dec_inputs().items()})
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp = _inputs()
    return inp, W.launch(tmp_path_factory.mktemp("decode"), "decode", inp)


_REFERENCE = {}


def _reference(kind):
    """The reference's logits of each step and its final pool."""
    if kind in _REFERENCE:
        return _REFERENCE[kind]
    _, dtype, quant = next(k for k in W.DEC_KINDS if k[0] == kind)
    dt = jnp.dtype(dtype)
    model = JaxLM(JaxLMCfg(dtype=dt, **W.LM_CFG))
    params = jax.tree_util.tree_map(lambda v: jnp.asarray(v, dt),
                                    W.lm_params())
    d = W.dec_inputs()
    kv = model.init_kv_pages(W.DEC_POOL, W.DEC_PSZ, quantized=quant)
    i32 = {k: jnp.asarray(v, jnp.int32) for k, v in d.items()}
    prefill = jax.jit(model.prefill, static_argnums=(5,),
                      static_argnames=("return_logits",))
    decode = jax.jit(model.decode_step, static_argnums=(5,),
                     static_argnames=("return_logits",))
    kv, _, logits = prefill(params, kv, i32["tokens"], i32["lengths"],
                            i32["table"], W.DEC_PSZ, return_logits=True)
    steps = [np.asarray(logits, np.float32)]
    for s in range(W.DEC_STEPS):
        kv, _, logits = decode(params, kv, i32["feed"][s],
                               i32["lengths"] + s, i32["table"], W.DEC_PSZ,
                               return_logits=True)
        steps.append(np.asarray(logits, np.float32))
    pool = {n: np.asarray(v.astype(jnp.float32)) for n, v in kv.items()}
    _REFERENCE[kind] = (np.stack(steps), pool)
    return _REFERENCE[kind]


def _owned_pages(rows):
    table = W.dec_inputs()["table"]
    return sorted({int(p) for r in rows for p in table[r]
                   if p < W.DEC_POOL})


def _rows_of(mesh, rank):
    """The batch rows a rank runs: its block over dp."""
    axes = W.DEC_MESHES[mesh]
    dp = axes.get("dp", 1)
    rest = int(np.prod([v for k, v in axes.items() if k != "dp"]))
    i = rank // rest
    b = W.DEC_B // dp
    return list(range(i * b, (i + 1) * b))


@pytest.mark.parametrize("kind", [k[0] for k in W.DEC_KINDS])
@pytest.mark.parametrize("mesh", sorted(W.DEC_MESHES))
def test_sharded_prefill_and_decode_match_reference(world, mesh, kind):
    _, runs = world
    want, pool = _reference(kind)
    tag = "dec/%s/%s/" % (mesh, kind)
    for rank, got in enumerate(runs):
        logits = got[tag + "logits"]
        assert logits.shape == want.shape
        for s in range(want.shape[0]):
            scale = np.abs(want[s]).max()
            err = np.abs(logits[s] - want[s]).max() / scale
            assert err <= LOGIT_RTOL[kind], (rank, s, err)
        owned = _owned_pages(_rows_of(mesh, rank))
        unused = [p for p in range(W.DEC_POOL) if p not in owned]
        for n, ref_v in pool.items():
            mine = got[tag + "pool/" + n]
            assert mine.shape == ref_v.shape, n
            a, b = mine[:, owned], ref_v[:, owned]
            if n in ("k", "v") and kind == "int8":
                assert np.abs(a - b).max() <= 1, (rank, n)
            else:
                rtol = LOGIT_RTOL["int8"] if kind == "int8" \
                    else POOL_RTOL[kind]
                err = np.abs(a - b).max() / np.abs(b).max()
                assert err <= rtol, (rank, n, err)
            assert not mine[:, unused].any(), (rank, n)
        heads = W.LM_CFG["num_heads"] // W.DEC_MESHES[mesh].get("tp", 1)
        assert int(got[tag + "local_heads"]) == heads
        L = W.LM_CFG["num_layers"]
        sp = W.DEC_MESHES[mesh].get("sp", 1)
        assert int(got[tag + "prefill_calls"]) == (0 if sp > 1 else L)
        assert int(got[tag + "decode_calls"]) == L * W.DEC_STEPS
    for got in runs[1:]:
        assert got[tag + "logits"].tobytes() == \
            runs[0][tag + "logits"].tobytes()
        assert got[tag + "ids"].tobytes() == runs[0][tag + "ids"].tobytes()


@pytest.mark.parametrize("mesh", sorted(W.DEC_MESHES))
def test_shard_kv_gather_kv_round_trip_bitwise(world, mesh):
    _, runs = world
    assert all(bool(r["dec/%s/round_trip" % mesh]) for r in runs)
