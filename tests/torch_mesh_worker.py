"""Worker of tests/test_torch_ring_attention.py,
tests/test_torch_tensor_parallel.py and tests/test_torch_pipeline_moe.py:
one rank of a 4-rank gloo group on the CPU, started by ``python -m
mxnet_tpu_torch.launch -n 4``, running every scenario of one suite.

The suites: ``ring`` (tests/test_torch_ring_attention.py), ``tp``
(tests/test_torch_tensor_parallel.py), ``pipe``
(tests/test_torch_pipeline_moe.py), ``bn``
(tests/test_torch_sync_batchnorm.py) and ``decode``
(tests/test_torch_sharded_decode.py).

Not a pytest file, and it never imports JAX: it reads its inputs from
``<workdir>/inputs.npz`` (written by the test, which computes the
reference's results in its own process) and writes each rank's results
to ``<workdir>/rank<r>.npz``.  Run::

    python -m mxnet_tpu_torch.launch -n 4 python tests/torch_mesh_worker.py WORKDIR SUITE

with SUITE one of ``ring``, ``tp``, ``pipe``, ``bn``, ``decode``.  The
functions that make
the inputs, and the sizes, are shared with the tests (numpy-only at
import).
"""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
LAUNCH_TIMEOUT_S = 240

# ring attention: tests/test_parallel.py's shapes on {dp 1, tp 2, sp 2}
RING_MESH = {"dp": 1, "tp": 2, "sp": 2}
RING_SHAPE = (2, 4, 16, 8)

# __graft_entry__.dryrun_multichip's TransformerLM (f32) and mesh for 4
LM_MESH = {"dp": 1, "tp": 2, "sp": 2}
LM_CFG = dict(vocab_size=128, num_layers=2, d_model=64, num_heads=4,
              d_ff=128, max_len=64)
LM_B, LM_S, LM_LR, LM_MOMENTUM = 2, 16, 0.01, 0.9
# a narrow BERT (tests/test_torch_bert.py's widths with 4 heads of 32)
BERT_MESH = {"dp": 2, "tp": 2}
BERT_CFG = dict(vocab_size=64, num_layers=2, d_model=128, num_heads=4,
                d_ff=256, max_len=16)
BERT_B, BERT_M = 4, 4
# the same BERT over a sequence split: rows over dp, positions over sp
BERT_SP_MESH = {"dp": 2, "sp": 2}
# SPMDTrainer with param_specs: a Gluon MLP, Dense weights split on tp
MLP_MESH = {"dp": 2, "tp": 2}
MLP_ONE_RANK_MESH = {"dp": 1, "tp": 4}
MLP_IN, MLP_HIDDEN, MLP_OUT, MLP_BATCH, MLP_STEPS = 16, 32, 8, 8, 3
MLP_OPT = {"learning_rate": 0.1, "momentum": 0.9}
MLP_SPECS = {"dense0_weight": ("tp", None), "dense0_bias": ("tp",),
             "dense1_weight": (None, "tp")}

# tests/test_pipeline_moe.py's pipeline and MoE shapes, on 4 ranks
PIPE_STAGES, PIPE_D, PIPE_B, PIPE_M = 4, 8, 16, 4
MOE_MESH = {"dp": 2, "ep": 2}
MOE_E, MOE_D, MOE_H, MOE_B, MOE_K, MOE_CF = 4, 8, 16, 32, 2, 2.0
MOE_AUX_WEIGHT = 0.01
# __graft_entry__._dryrun_pipeline_moe(4): dp 1, pp 2, ep 2
PPMOE_MESH = {"dp": 1, "pp": 2, "ep": 2}
PPMOE_D, PPMOE_H, PPMOE_ELOC, PPMOE_M, PPMOE_B, PPMOE_LR = 16, 32, 2, 2, 4, 0.1

# SyncBatchNorm through SPMDTrainer: a narrow conv-BN-ReLU net, 3 momentum
# SGD steps on each mesh, in both statistics modes and with a padded batch
BN_MESHES = {"dp4": {"dp": 4}, "dp2tp2": {"dp": 2, "tp": 2}}
# (run name, mesh, bn_two_pass_stats, pad)
BN_RUNS = (("dp4", "dp4", False, 0), ("dp4_two_pass", "dp4", True, 0),
           ("dp2tp2", "dp2tp2", False, 0), ("dp4_pad", "dp4", False, 2),
           ("dp2tp2_two_pass_pad", "dp2tp2", True, 3))
BN_B, BN_C, BN_HW, BN_CLASSES, BN_STEPS = 8, 3, 8, 5, 3
BN_OPT = {"learning_rate": 0.1, "momentum": 0.9}
# the BatchNorm op alone over {dp 4}: [B, C, H, W] rows split over dp
BN_OP_SHAPE = (8, 6, 3, 3)


def launch(workdir, suite, inputs):
    """Run ``suite`` on 4 gloo ranks over ``inputs`` (``workdir`` a
    ``pathlib.Path``): each rank's results.  Asserts that every rank
    finished."""
    np.savez(workdir / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(RANKS),
         sys.executable, os.path.abspath(__file__), str(workdir), suite],
        env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    log = proc.stdout[-3000:] + proc.stderr[-6000:]
    assert proc.returncode == 0, log
    for r in range(RANKS):
        assert "WORKER_OK rank=%d suite=%s" % (r, suite) in proc.stdout, log
    return [dict(np.load(workdir / ("rank%d.npz" % r)))
            for r in range(RANKS)]


# ------------------------------------------------------------ inputs
def ring_inputs():
    rng = np.random.RandomState(0)
    return {n: rng.normal(size=RING_SHAPE).astype(np.float32)
            for n in ("q", "k", "v", "w")}


def lm_params(seed=0):
    """TransformerLM weights in the reference's nested layout."""
    c = LM_CFG
    L, D, F, H = c["num_layers"], c["d_model"], c["d_ff"], c["num_heads"]
    rng = np.random.RandomState(seed)

    def mk(*shape):
        return rng.normal(0.0, 0.02, shape).astype(np.float32)
    return {"embed": mk(c["vocab_size"], D), "pos_embed": mk(c["max_len"], D),
            "final_norm": 1.0 + mk(D),
            "layers": {"ln1": 1.0 + mk(L, D), "wqkv": mk(L, D, 3, H, D // H),
                       "wo": mk(L, H, D // H, D), "ln2": 1.0 + mk(L, D),
                       "w1": mk(L, D, F), "w2": mk(L, F, D)}}


def bert_params(seed=1):
    c = BERT_CFG
    D, V = c["d_model"], c["vocab_size"]
    rng = np.random.RandomState(seed)

    def mk(*shape):
        return rng.normal(0.0, 0.02, shape).astype(np.float32)
    enc = {"embed": mk(V, D), "pos_embed": mk(c["max_len"], D),
           "final_norm": 1.0 + mk(D)}
    L, F, H = c["num_layers"], c["d_ff"], c["num_heads"]
    enc["layers"] = {"ln1": 1.0 + mk(L, D), "wqkv": mk(L, D, 3, H, D // H),
                     "wo": mk(L, H, D // H, D), "ln2": 1.0 + mk(L, D),
                     "w1": mk(L, D, F), "w2": mk(L, F, D)}
    enc.update({"type_embed": mk(2, D), "pooler_w": mk(D, D),
                "pooler_b": mk(D), "nsp_w": mk(D, 2), "nsp_b": mk(2),
                "mlm_w": mk(D, D), "mlm_b": mk(D), "mlm_norm": 1.0 + mk(D),
                "mlm_bias_v": mk(V)})
    return enc


def bert_batch(seed=2):
    c = BERT_CFG
    rng = np.random.RandomState(seed)
    B, S, M, V = BERT_B, c["max_len"], BERT_M, c["vocab_size"]
    w = np.ones((B, M), np.float32)
    w[0, -1] = 0.0
    return {"tokens": rng.randint(0, V, (B, S)),
            "token_types": rng.randint(0, 2, (B, S)),
            "mlm_positions": rng.randint(0, S, (B, M)),
            "mlm_labels": rng.randint(0, V, (B, M)),
            "mlm_weights": w, "nsp_labels": rng.randint(0, 2, (B,))}


BERT_ARGS = ("tokens", "token_types", "mlm_positions", "mlm_labels",
             "mlm_weights", "nsp_labels")


def mlp_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(MLP_HIDDEN, activation="relu", in_units=MLP_IN))
        net.add(nn.Dense(MLP_OUT, in_units=MLP_HIDDEN))
    return net


def mlp_batches(seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.normal(size=(MLP_BATCH, MLP_IN)).astype(np.float32),
             rng.normal(size=(MLP_BATCH, MLP_OUT)).astype(np.float32))
            for _ in range(MLP_STEPS)]


def bn_net(pkg):
    """conv (no bias, as before every BatchNorm of ResNet) ->
    SyncBatchNorm -> relu, twice, then a pooled Dense head."""
    nn = pkg.gluon.nn
    cnn = pkg.gluon.contrib.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(6, 3, padding=1, use_bias=False,
                          in_channels=BN_C))
        net.add(cnn.SyncBatchNorm(in_channels=6))
        net.add(nn.Activation("relu"))
        net.add(nn.Conv2D(8, 3, strides=2, padding=1, use_bias=False,
                          in_channels=6))
        net.add(cnn.SyncBatchNorm(in_channels=8, num_devices=4))
        net.add(nn.Activation("relu"))
        net.add(nn.GlobalAvgPool2D())
        net.add(nn.Dense(BN_CLASSES, in_units=8))
    return net


def bn_batches(seed=4):
    """Inputs with a large offset (the shifted statistics' case) and
    class labels, one batch a step."""
    rng = np.random.RandomState(seed)
    return [(rng.normal(3.0, 2.0, (BN_B, BN_C, BN_HW, BN_HW))
             .astype(np.float32),
             rng.randint(0, BN_CLASSES, (BN_B,)).astype(np.float32))
            for _ in range(BN_STEPS)]


def bn_op_inputs(seed=6):
    rng = np.random.RandomState(seed)
    c = BN_OP_SHAPE[1]
    return {"x": rng.normal(2.0, 1.5, BN_OP_SHAPE).astype(np.float32),
            "w": rng.normal(size=BN_OP_SHAPE).astype(np.float32),
            "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "beta": rng.normal(size=c).astype(np.float32),
            "mean": rng.normal(2.0, 0.1, c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}


# prefill and 8 teacher-forced decode steps of LM_CFG's TransformerLM on
# three meshes, with f32, bf16 and int8 pages (an f32 model's)
DEC_MESHES = {"tp2sp2": {"dp": 1, "tp": 2, "sp": 2},
              "dp2tp2": {"dp": 2, "tp": 2}, "tp4": {"tp": 4}}
# (page kind, model dtype, int8 pages)
DEC_KINDS = (("f32", "float32", False), ("bf16", "bfloat16", False),
             ("int8", "float32", True))
DEC_B, DEC_S, DEC_PSZ, DEC_W, DEC_STEPS = 2, 16, 4, 6, 8
DEC_LENGTHS = (13, 7)
# one spare page no row uses; the page id DEC_POOL is the sentinel
DEC_POOL = DEC_B * DEC_W + 1


def dec_inputs(seed=8):
    """Prompts (padded past their lengths), the page table (row 1's last
    two entries the sentinel: its positions never reach them) and the
    teacher-forced decode tokens."""
    rng = np.random.RandomState(seed)
    V = LM_CFG["vocab_size"]
    table = np.arange(DEC_B * DEC_W).reshape(DEC_B, DEC_W)
    table[1, 4:] = DEC_POOL
    return {"tokens": rng.randint(0, V, (DEC_B, DEC_S)),
            "lengths": np.array(DEC_LENGTHS),
            "table": table,
            "feed": rng.randint(0, V, (DEC_STEPS, DEC_B))}


def dec_pool_shape():
    c = LM_CFG
    return (c["num_layers"], DEC_POOL, DEC_PSZ, c["num_heads"],
            c["d_model"] // c["num_heads"])


def dec_zero_pool(dtype, quant):
    """A whole zero pool in the reference's layout (numpy; bf16 as its
    f32 widening)."""
    shape = dec_pool_shape()
    if quant:
        return {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
                "k_scale": np.zeros(shape[:-1], np.float32),
                "v_scale": np.zeros(shape[:-1], np.float32)}
    return {"k": np.zeros(shape, np.float32),
            "v": np.zeros(shape, np.float32)}


def pipe_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(0, 0.5, (PIPE_STAGES, PIPE_D, PIPE_D))
            .astype(np.float32),
            "b": rng.normal(0, 0.1, (PIPE_STAGES, PIPE_D)).astype(np.float32),
            "x": rng.normal(size=(PIPE_B, PIPE_D)).astype(np.float32),
            "t": rng.normal(size=(PIPE_B, PIPE_D)).astype(np.float32)}


def moe_inputs(seed=7):
    rng = np.random.RandomState(seed)
    e, d, h = MOE_E, MOE_D, MOE_H
    return {"gate_w": rng.normal(0, 0.5, (d, e)).astype(np.float32),
            "w1": rng.normal(0, 0.5, (e, d, h)).astype(np.float32),
            "b1": rng.normal(0, 0.1, (e, h)).astype(np.float32),
            "w2": rng.normal(0, 0.5, (e, h, d)).astype(np.float32),
            "b2": rng.normal(0, 0.1, (e, d)).astype(np.float32),
            "x": rng.normal(size=(MOE_B, d)).astype(np.float32)}


MOE_NAMES = ("gate_w", "w1", "b1", "w2", "b2")


def ppmoe_inputs(seed=1):
    """The dryrun's pipelined MoE parameters, inputs and targets."""
    n_pp = PPMOE_MESH["pp"]
    d, h = PPMOE_D, PPMOE_H
    e = PPMOE_ELOC * PPMOE_MESH["ep"]
    rng = np.random.RandomState(seed)
    out = {"gate": rng.normal(0, 0.5, (n_pp, d, e)),
           "w1": rng.normal(0, 0.5, (n_pp, e, d, h)),
           "b1": np.zeros((n_pp, e, h)),
           "w2": rng.normal(0, 0.5, (n_pp, e, h, d)),
           "b2": np.zeros((n_pp, e, d))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["x"] = rng.normal(size=(PPMOE_B, d)).astype(np.float32)
    out["t"] = rng.normal(size=(PPMOE_B, d)).astype(np.float32)
    return out


PPMOE_SPECS = {"gate": ("pp",), "w1": ("pp", "ep"), "b1": ("pp", "ep"),
               "w2": ("pp", "ep"), "b2": ("pp", "ep")}


def nest(flat, prefix):
    """``{prefix + "a.b": v}`` -> ``{"a": {"b": v}}``."""
    out = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


# ------------------------------------------------------------ suites
def _ring(mx, torch, inp, out):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import ring_self_attention_sharded
    mesh = mx.parallel.make_mesh(RING_MESH)
    telemetry.reset()
    for causal in (True, False):
        q, k, v = (torch.tensor(inp["ring/" + n], requires_grad=True)
                   for n in "qkv")
        o = ring_self_attention_sharded(mesh, q, k, v, causal=causal)
        (o * torch.as_tensor(inp["ring/w"])).sum().backward()
        tag = "causal" if causal else "full"
        out[tag + "/out"] = o.detach().numpy()
        for n, t in zip("qkv", (q, k, v)):
            out["%s/d%s" % (tag, n)] = t.grad.numpy()
    counts = telemetry.snapshot()["counters"]
    out["ppermute_native"] = counts.get("collectives.ppermute.native", 0)
    out["ppermute_host"] = counts.get("collectives.ppermute.host", 0)


def _lm(mx, torch, inp, out):
    from mxnet_tpu_torch.convert import gather_params, shard_params
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    mesh = mx.parallel.make_mesh(LM_MESH)
    model = TransformerLM(TransformerLMConfig(dtype=torch.float32, **LM_CFG),
                          mesh=mesh)
    specs = model.param_specs()
    model.load_state_dict(shard_params(nest(inp, "lm/"), specs, mesh))
    model.requires_grad_(True)
    loss = model.loss(inp["lm_tokens"], inp["lm_targets"])
    loss.backward()
    model.allreduce_grads()
    grads = gather_params({n: p.grad for n, p in model.named_parameters()},
                          specs, mesh)
    with torch.no_grad():
        # the dryrun's momentum step from a zero momentum
        for p in model.parameters():
            m = LM_MOMENTUM * torch.zeros_like(p) + p.grad
            p.copy_(p - torch.tensor(LM_LR, dtype=p.dtype) * m)
    after = gather_params(model.state_dict(), specs, mesh)
    out["lm/loss"] = float(loss.detach())
    out.update({"lm/grad/" + n: v for n, v in flat(grads).items()})
    out.update({"lm/after/" + n: v for n, v in flat(after).items()})


def _bert(mx, torch, inp, out):
    from mxnet_tpu_torch.convert import gather_params, shard_params
    from mxnet_tpu_torch.models import BERT, BERTConfig
    mesh = mx.parallel.make_mesh(BERT_MESH)
    model = BERT(BERTConfig(dtype=torch.float32, **BERT_CFG), mesh=mesh)
    specs = model.param_specs()
    model.load_state_dict(shard_params(nest(inp, "bert/"), specs, mesh))
    model.requires_grad_(True)
    loss = model.pretrain_loss(*(inp["bert_batch/" + k] for k in BERT_ARGS))
    loss.backward()
    model.allreduce_grads()
    grads = gather_params({n: p.grad for n, p in model.named_parameters()},
                          specs, mesh)
    out["bert/loss"] = float(loss.detach())
    out.update({"bert/grad/" + n: v for n, v in flat(grads).items()})
    # over {dp 2, sp 2}: ring attention in the encoder, the heads on the
    # sequence gathered whole
    mesh = mx.parallel.make_mesh(BERT_SP_MESH)
    model = BERT(BERTConfig(dtype=torch.float32, **BERT_CFG), mesh=mesh)
    specs = model.param_specs()
    model.load_state_dict(shard_params(nest(inp, "bert/"), specs, mesh))
    model.requires_grad_(True)
    loss = model.pretrain_loss(*(inp["bert_batch/" + k] for k in BERT_ARGS))
    loss.backward()
    model.allreduce_grads()
    grads = gather_params({n: p.grad for n, p in model.named_parameters()},
                          specs, mesh)
    out["bert_sp/loss"] = float(loss.detach())
    out.update({"bert_sp/grad/" + n: v for n, v in flat(grads).items()})


def _raised(exc, fn, *args, **kwargs):
    """The message of the ``exc`` that ``fn`` raises (it must)."""
    try:
        fn(*args, **kwargs)
    except exc as e:
        return str(e)
    raise AssertionError("%s did not raise %s" % (fn, exc.__name__))


def _mlp_trainer(mx, mesh, init, specs):
    import mxnet_tpu_torch.name  # noqa: F401  (loaded lazily)
    from mxnet_tpu_torch.convert import gluon_params_from_reference
    from mxnet_tpu_torch.parallel import SPMDTrainer
    with mx.name.NameManager():
        net = mlp_net(mx)
    net.initialize(ctx=mx.cpu())
    gluon_params_from_reference(net, init)
    specs = {net.prefix + n: s for n, s in (specs or {}).items()}
    return net, SPMDTrainer(net, mx.gluon.loss.L2Loss(), "sgd",
                            dict(MLP_OPT), mesh=mesh, param_specs=specs)


def _spmd(mx, torch, inp, out):
    init = {k[len("mlp/init/"):]: v for k, v in inp.items()
            if k.startswith("mlp/init/")}
    batches = [(inp["mlp/x%d" % s], inp["mlp/y%d" % s])
               for s in range(MLP_STEPS)]
    mesh = mx.parallel.make_mesh(MLP_MESH)
    net, tr = _mlp_trainer(mx, mesh, init, MLP_SPECS)
    losses = [float(tr.step(x, y)) for x, y in batches]
    shapes = {n: tuple(v.shape) for n, v in tr.params.items()}
    tr.sync()
    out["mlp/loss"] = np.array(losses, np.float32)
    for n, p in net.collect_params().items():
        out["mlp/param/" + n] = p.data().asnumpy()
        out["mlp/shard_shape/" + n] = np.array(shapes[n])
    # {dp 1, tp 4} against a rank-local trainer: the gathers are exact and
    # K1's plain version is elementwise, so the weights are bitwise
    net4, tr4 = _mlp_trainer(mx, mx.parallel.make_mesh(MLP_ONE_RANK_MESH),
                             init, MLP_SPECS)
    net1, tr1 = _mlp_trainer(
        mx, mx.parallel.make_mesh({"dp": 1}, [mx.cpu()]), init, None)
    l4 = [tr4.step(x, y) for x, y in batches]
    l1 = [tr1.step(x, y) for x, y in batches]
    tr4.sync()
    tr1.sync()
    same = all(torch.equal(a, b) for a, b in zip(l4, l1)) and all(
        np.array_equal(p4.data().asnumpy(), p1.data().asnumpy())
        for p4, p1 in zip(net4.collect_params().values(),
                          net1.collect_params().values()))
    out["mlp/one_rank_bitwise"] = same
    _refusals(mx, torch, init, batches, out)


def _refusals(mx, torch, init, batches, out):
    """What a mesh with tp ranks still refuses: the routed row-sparse
    table and the 2-bit compressed step."""
    import mxnet_tpu_torch.name  # noqa: F401  (loaded lazily)
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.parallel import SPMDTrainer
    nn = mx.gluon.nn
    with mx.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Embedding(16, 4, sparse_grad=True))
            net.add(nn.Dense(2, in_units=4, flatten=False))
    net.initialize(ctx=mx.cpu())
    tr = SPMDTrainer(net, mx.gluon.loss.L2Loss(), "sgd", dict(MLP_OPT),
                     mesh=mx.parallel.make_mesh(MLP_MESH))
    ids = np.arange(MLP_BATCH * 2).reshape(MLP_BATCH, 2) % 16
    out["mlp/routed_refused"] = _raised(
        NotImplementedError, tr.step, ids.astype(np.float32),
        np.zeros((MLP_BATCH, 2, 2), np.float32))
    _, tr = _mlp_trainer(mx, mx.parallel.make_mesh(
        {"dcn": 2, "dp": 1, "tp": 2}), init, None)
    config.set("kvstore.grad_compress", "2bit")
    try:
        out["mlp/compressed_refused"] = _raised(
            NotImplementedError, tr.step, *batches[0])
    finally:
        config.set("kvstore.grad_compress", "")


def _pipeline(mx, torch, inp, out):
    from mxnet_tpu_torch.parallel import pipeline_sharded
    mesh = mx.parallel.make_mesh({"pp": PIPE_STAGES})
    params = {k: torch.tensor(inp["pipe/" + k], requires_grad=True)
              for k in ("w", "b")}

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    y = pipeline_sharded(mesh, stage, params,
                         torch.as_tensor(inp["pipe/x"]), PIPE_M)
    loss = torch.mean((y - torch.as_tensor(inp["pipe/t"])) ** 2)
    loss.backward()
    out["pipe/y"] = y.detach().numpy()
    out["pipe/loss"] = float(loss.detach())
    for k, v in params.items():
        out["pipe/grad/" + k] = v.grad.numpy()


def _moe(mx, torch, inp, out):
    from mxnet_tpu_torch.parallel import moe_ffn_sharded
    mesh = mx.parallel.make_mesh(MOE_MESH)
    ws = [torch.tensor(inp["moe/" + n], requires_grad=True)
          for n in MOE_NAMES]
    y, aux = moe_ffn_sharded(mesh, *ws, torch.as_tensor(inp["moe/x"]),
                             k=MOE_K, capacity_factor=MOE_CF)
    (torch.mean(y ** 2) + MOE_AUX_WEIGHT * aux).backward()
    out["moe/y"] = y.detach().numpy()
    out["moe/aux"] = float(aux.detach())
    for n, w in zip(MOE_NAMES, ws):
        out["moe/grad/" + n] = w.grad.numpy()


def _ppmoe(mx, torch, inp, out):
    """The dryrun's pipelined MoE step: a 2-stage pipeline whose stages
    are top-1 MoE FFNs over ep, the loss averaged over dp and ep."""
    from mxnet_tpu_torch.parallel import collectives as coll
    from mxnet_tpu_torch.parallel import microbatch, moe_ffn, pipeline_apply
    mesh = mx.parallel.make_mesh(PPMOE_MESH)
    params = {k: torch.tensor(inp["ppmoe/" + k], requires_grad=True)
              for k in PPMOE_SPECS}
    # a stage's parameters: the gate is every (dp, ep) rank's, an expert
    # every dp rank's; their gradients sum over the ranks that use them
    mine = {k: coll.shard(v, mesh, PPMOE_SPECS[k],
                          sum_axes=("dp", "ep"))[0]
            for k, v in params.items()}
    xm = coll.shard(microbatch(torch.as_tensor(inp["ppmoe/x"]), PPMOE_M),
                    mesh, (None, "dp"))
    tm = coll.shard(microbatch(torch.as_tensor(inp["ppmoe/t"]), PPMOE_M),
                    mesh, (None, "dp"))

    def stage(sp, act):
        y, _aux = moe_ffn(sp["gate"], sp["w1"], sp["b1"], sp["w2"],
                          sp["b2"], act, axis_name="ep", k=1,
                          capacity_factor=4.0, mesh=mesh)
        return act + y

    y = pipeline_apply(stage, mine, xm, axis_name="pp",
                       vary_axes=("dp", "pp", "ep"), mesh=mesh)
    loss = coll.pmean(torch.mean((y - tm) ** 2), mesh, ("dp", "ep"))
    loss.backward()
    out["ppmoe/loss"] = float(loss.detach())
    with torch.no_grad():
        for k, v in params.items():
            out["ppmoe/after/" + k] = (v - PPMOE_LR * v.grad).numpy()


# the running group's workdir (main sets it)
_WORKDIR = [None]


def _bn_trainer(mx, mesh, init):
    import mxnet_tpu_torch.name  # noqa: F401  (loaded lazily)
    from mxnet_tpu_torch.convert import gluon_params_from_reference
    from mxnet_tpu_torch.parallel import SPMDTrainer
    with mx.name.NameManager():
        net = bn_net(mx)
    net.initialize(ctx=mx.cpu())
    gluon_params_from_reference(net, init)
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    return net, SPMDTrainer(net, loss, "sgd", dict(BN_OPT), mesh=mesh)


def _sync_bn(mx, torch, inp, out):
    """SPMDTrainer over each BN_RUNS entry; each rank's own aux tensors
    (to be held bitwise across ranks) and, after ``sync``, the weights;
    rank 0's checkpoint of the last run."""
    from mxnet_tpu_torch import config
    init = {k[len("bn/init/"):]: v for k, v in inp.items()
            if k.startswith("bn/init/")}
    batches = [(inp["bn/x%d" % s], inp["bn/y%d" % s])
               for s in range(BN_STEPS)]
    meshes = {k: mx.parallel.make_mesh(v) for k, v in BN_MESHES.items()}
    for run, mesh_name, two_pass, pad in BN_RUNS:
        config.set("bn_two_pass_stats", two_pass)
        try:
            net, tr = _bn_trainer(mx, meshes[mesh_name], init)
            losses = [float(tr.step(x, y, pad=pad)) for x, y in batches]
        finally:
            config.set("bn_two_pass_stats", False)
        for n in tr.fn.aux:
            out["bn/%s/aux_rank/%s" % (run, n)] = tr.params[n].numpy()
        tr.sync()
        out["bn/%s/loss" % run] = np.array(losses, np.float32)
        for n, p in net.collect_params().items():
            out["bn/%s/param/%s" % (run, n)] = p.data().asnumpy()
    tr.save_checkpoint(os.path.join(_WORKDIR[0], "bn.ckpt"))
    # the op alone: this rank's rows of the global batch, the statistics
    # over the four ranks, the gradients of sum(out * w)
    from mxnet_tpu_torch.ops import nn as nn_ops
    from mxnet_tpu_torch.parallel.collectives import local_block
    mesh = meshes["dp4"]
    for two_pass in (False, True):
        config.set("bn_two_pass_stats", two_pass)
        x = local_block(torch.as_tensor(inp["bnop/x"]), mesh, ("dp",))
        w = local_block(torch.as_tensor(inp["bnop/w"]), mesh, ("dp",))
        x = x.clone().requires_grad_(True)
        gamma, beta = (torch.tensor(inp["bnop/" + n], requires_grad=True)
                       for n in ("gamma", "beta"))
        prev = nn_ops.set_batch_stats_context((mesh, ("dp",)))
        try:
            y, mean, var = nn_ops._batch_norm(
                x, gamma, beta, torch.as_tensor(inp["bnop/mean"]),
                torch.as_tensor(inp["bnop/var"]), eps=1e-5, fix_gamma=False,
                training=True)
        finally:
            nn_ops.set_batch_stats_context(prev)
            config.set("bn_two_pass_stats", False)
        (y * w).sum().backward()
        tag = "bnop/%s/" % ("two_pass" if two_pass else "shifted")
        out[tag + "y"] = y.detach().numpy()
        out[tag + "mean"] = mean.detach().numpy()
        out[tag + "var"] = var.detach().numpy()
        out[tag + "dx"] = x.grad.numpy()
        out[tag + "dgamma"] = gamma.grad.numpy()
        out[tag + "dbeta"] = beta.grad.numpy()


def _count_calls(module, name, counts, key):
    """Wrap ``module.name`` so each call adds one to ``counts[key]``;
    returns the original."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        counts[key] = counts.get(key, 0) + 1
        return orig(*args, **kwargs)
    setattr(module, name, wrapper)
    return orig


def _decode(mx, torch, inp, out):
    """prefill + DEC_STEPS decode steps on each DEC_MESHES x DEC_KINDS:
    the global logits of each, every rank's pool gathered over tp, the
    kernel entries' call counts; and shard_kv / gather_kv round trips."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.convert import gather_kv, shard_kv, shard_params
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    d = {k: inp["dec/" + k] for k in ("tokens", "lengths", "table",
                                      "feed")}
    for mesh_name, axes in DEC_MESHES.items():
        mesh = mx.parallel.make_mesh(axes)
        for kind, dtype, quant in DEC_KINDS:
            tag = "dec/%s/%s/" % (mesh_name, kind)
            model = TransformerLM(TransformerLMConfig(dtype=dtype, **LM_CFG),
                                  mesh=mesh)
            model.load_state_dict(shard_params(nest(inp, "lm/"),
                                               model.param_specs(), mesh))
            kv = shard_kv(dec_zero_pool(dtype, quant), mesh)
            if not quant:
                kv = {n: v.to(model.cfg.dtype) for n, v in kv.items()}
            assert tuple(kv["k"].shape) == tuple(model.init_kv_pages(
                DEC_POOL, DEC_PSZ, quant)["k"].shape)
            counts = {}
            origs = [_count_calls(kernels, n, counts, n)
                     for n in ("attention", "paged_attention_pool")]
            try:
                kv, ids, logits = model.prefill(
                    kv, d["tokens"], d["lengths"], d["table"], DEC_PSZ,
                    return_logits=True)
                out[tag + "prefill_calls"] = counts.pop("attention", 0)
                steps = [logits.float().numpy()]
                for s in range(DEC_STEPS):
                    kv, ids, logits = model.decode_step(
                        kv, d["feed"][s], d["lengths"] + s, d["table"],
                        DEC_PSZ, return_logits=True)
                    steps.append(logits.float().numpy())
                out[tag + "decode_calls"] = counts.pop(
                    "paged_attention_pool", 0)
            finally:
                for n, o in zip(("attention", "paged_attention_pool"),
                                origs):
                    setattr(kernels, n, o)
            out[tag + "logits"] = np.stack(steps)
            out[tag + "ids"] = ids.numpy()
            out[tag + "local_heads"] = kv["k"].shape[3]
            for n, v in gather_kv(kv, mesh).items():
                out[tag + "pool/" + n] = v.float().numpy()
        # shard_kv / gather_kv round trip, bitwise, per dtype
        rng = np.random.RandomState(9)
        shape = dec_pool_shape()
        whole = {"k": torch.as_tensor(rng.normal(size=shape)).to(
                     torch.bfloat16),
                 "v": torch.as_tensor(rng.normal(size=shape)
                                      .astype(np.float32)),
                 "k_scale": torch.as_tensor(rng.randint(
                     -127, 128, shape).astype(np.int8))}
        back = gather_kv(shard_kv(whole, mesh), mesh)
        out["dec/%s/round_trip" % mesh_name] = all(
            back[n].dtype == v.dtype and torch.equal(back[n], v)
            for n, v in whole.items())


SUITES = {"ring": (_ring,), "tp": (_lm, _bert, _spmd),
          "pipe": (_pipeline, _moe, _ppmoe), "bn": (_sync_bn,),
          "decode": (_decode,)}


def main(workdir, suite):
    import torch
    import mxnet_tpu_torch as mx
    rank = int(os.environ["MXTPU_PROCESS_ID"])
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    _WORKDIR[0] = workdir
    out = {}
    with mx.cpu():
        mx.parallel.initialize()
        for scenario in SUITES[suite]:
            scenario(mx, torch, inp, out)
        mx.parallel.barrier()
    np.savez(os.path.join(workdir, "rank%d.npz" % rank), **out)
    print("WORKER_OK rank=%d suite=%s" % (rank, suite), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
