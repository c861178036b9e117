"""The row-sparse embedding path of the port (``parallel/embedding.py``,
``Optimizer.step_rows``, ``SPMDTrainer``'s sparse route) against the
reference on one device.

Bounds: ``dedup_ids``, the lookup, ``update_unique`` / ``step_rows``
(SGD with and without momentum, Adam) are bitwise the reference's (the
reference's ``step_rows`` compiled, the step count a Python int, as the
port takes Adam's bias correction); ``ShardedEmbedding`` bitwise with SGD
and within 1e-6 with Adam (its program traces the step count);
``SPMDTrainer`` at vocab 1000, dim 8, batch 16, 4 slots over 3 steps (the
second pad-masked): SGD losses and parameters within 1e-7, Adam within
1e-6 (the reference's traced step takes the bias correction in f32, the
port in Python floats); the sparse route against the port's own dense
route: first-step gradients bitwise, all within 1e-7 after 3 steps.  Rows
no batch touched stay bitwise unchanged on the sparse route, signed zeros
included.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as ref
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu.parallel import SPMDTrainer as RefTrainer
from mxnet_tpu.parallel import embedding as ref_emb
from mxnet_tpu.parallel import make_mesh as ref_mesh
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
from mxnet_tpu_torch.parallel import embedding as pemb

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gluon as G  # noqa: E402

VOCAB, DIM, BATCH, SLOTS, STEPS = 1000, 8, 16, 4, 3
TRAIN_ATOL = {"sgd": 1e-7, "adam": 1e-6}
OPTS = {"sgd": {"learning_rate": 0.05},
        "sgd_mom": {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01},
        "adam": {"learning_rate": 0.01, "wd": 0.01}}


def _bits(a):
    return np.asarray(a).tobytes()


# ------------------------------------------------------------- dedup_ids
DEDUP_CASES = {
    "ragged": (np.array([[5, 3, 5, 9], [1, 3, 7, 7], [2, 0, 0, 9]]), 12, 50),
    "all_identical": (np.full((4, 3), 5), 12, 50),
    "sentinel_padded": (np.array([[4, 50, 50], [2, 4, 50]]), 6, 50),
    "cap_cuts_ids": (np.array([5, 3, 5, 9, 1, 3, 7, 7, 2]), 4, 100),
    "size_above_count": (np.array([9, 1, 9]), 8, 10),
    "zipf": (np.minimum(np.random.RandomState(0).zipf(1.5, (64, 8)), VOCAB)
             - 1, 512, VOCAB),
}


@pytest.mark.parametrize("case", sorted(DEDUP_CASES))
def test_dedup_ids_bitwise(case):
    ids, size, sentinel = DEDUP_CASES[case]
    ids = ids.astype(np.int32)
    pu, pi = pemb.dedup_ids(torch.from_numpy(ids), size, sentinel)
    ru, ri = ref_emb.dedup_ids(jnp.asarray(ids), size, sentinel)
    assert pu.dtype == torch.int32 and pu.shape == (size,)
    assert _bits(pu.numpy()) == _bits(ru)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


def test_unique_capacity_follows_the_knob():
    assert pemb.unique_capacity(64) == 64
    mt.config.set("embedding.unique_size", 8)
    try:
        assert pemb.unique_capacity(64) == 8
        assert pemb.unique_capacity(5) == 5
    finally:
        mt.config.unset("embedding.unique_size")
    with pytest.raises(ValueError):
        mt.config.set("embedding.unique_size", -1)
    assert mt.config.get("embedding.unique_size") == 0


# ------------------------------------------------------ lookup and update
def _table(rows=60, dim=DIM, seed=1):
    t = np.random.RandomState(seed).randn(rows, dim).astype(np.float32)
    t[7] = -0.0   # signed zeros must survive untouched
    t[9, :3] = -0.0
    return t


def test_lookup_unique_bitwise_with_sentinels():
    t = _table()
    uniq = np.array([0, 3, 7, 9, 59, 60, 60, 61], np.int32)
    got = pemb.lookup_unique(torch.from_numpy(t), torch.from_numpy(uniq))
    want = ref_emb.lookup_unique(jnp.asarray(t), jnp.asarray(uniq))
    assert _bits(got.numpy()) == _bits(want)


def _ref_update(opt_name, t, state, uniq, g, lr, wd, step):
    opt = ref.optimizer.create(opt_name.split("_")[0],
                               **{k: v for k, v in OPTS[opt_name].items()
                                  if k == "momentum"})
    f = jax.jit(lambda t_, s_, u_, g_, lr_, wd_: ref_emb.update_unique(
        opt, t_, s_, u_, g_, lr_, wd_, step))
    w, s = f(jnp.asarray(t), state, jnp.asarray(uniq), jnp.asarray(g),
             np.float32(lr), np.float32(wd))
    return np.asarray(w), s


@pytest.mark.parametrize("opt_name", ["sgd", "sgd_mom", "adam"])
def test_update_unique_bitwise_and_untouched_rows(opt_name):
    """Two row-sparse steps with sentinel padding: touched rows and their
    state bitwise the reference's; every other row, and the -0.0 ones,
    unchanged bit for bit."""
    t = _table()
    rng = np.random.RandomState(2)
    kw = OPTS[opt_name]
    popt = mt.optimizer.create(opt_name.split("_")[0],
                               **{k: v for k, v in kw.items()
                                  if k == "momentum"})
    pt = torch.from_numpy(t.copy())
    pstate = popt.create_state(0, pt)
    rstate = None
    if opt_name == "sgd_mom":
        rstate = jnp.zeros_like(jnp.asarray(t))
    elif opt_name == "adam":
        rstate = (jnp.zeros_like(jnp.asarray(t)),
                  jnp.zeros_like(jnp.asarray(t)))
    rt = t
    for step in (1, 2):
        uniq = np.array([2, 5, 11, 40, 60, 60], np.int32)  # 2 sentinels
        g = rng.randn(6, DIM).astype(np.float32)
        pemb.update_unique(popt, pt, pstate, torch.from_numpy(uniq),
                           torch.from_numpy(g), kw["learning_rate"],
                           kw.get("wd", 0.0), step)
        rt, rstate = _ref_update(opt_name, rt, rstate, uniq, g,
                                 kw["learning_rate"], kw.get("wd", 0.0),
                                 step)
        assert _bits(pt.numpy()) == _bits(rt), step
    if opt_name != "sgd":
        pst = pstate if opt_name == "adam" else (pstate,)
        rst = rstate if opt_name == "adam" else (rstate,)
        for a, b in zip(pst, rst):
            assert _bits(a.numpy()) == _bits(b)
    untouched = np.setdiff1d(np.arange(60), [2, 5, 11, 40])
    assert _bits(pt.numpy()[untouched]) == _bits(t[untouched])


@pytest.mark.parametrize("opt_name", ["sgd_mom", "adam"])
def test_step_rows_drops_out_of_range_rows(opt_name):
    """Rows outside the table (either side) are dropped, even where they
    repeat; the state of the real rows is written once."""
    t = _table(20)
    popt = mt.optimizer.create(opt_name.split("_")[0],
                               **{k: v for k, v in OPTS[opt_name].items()
                                  if k == "momentum"})
    w = torch.from_numpy(t.copy())
    state = popt.create_state(0, w)
    rows = torch.tensor([-3, 4, 20, 20, 13, 99])
    g = torch.ones(6, DIM)
    popt.step_rows(w, rows, g, state, 0.1, 0.0, 1)
    keep = np.setdiff1d(np.arange(20), [4, 13])
    assert _bits(w.numpy()[keep]) == _bits(t[keep])
    assert not np.array_equal(w.numpy()[[4, 13]], t[[4, 13]])
    for s in (state if isinstance(state, tuple) else (state,)):
        assert not s.numpy()[keep].any() and s.numpy()[[4, 13]].all()
    # no row in range at all: nothing changes
    before = w.clone()
    popt.step_rows(w, torch.tensor([20, 21]), torch.ones(2, DIM), state,
                   0.1, 0.0, 2)
    assert _bits(w.numpy()) == _bits(before.numpy())


# ------------------------------------------------------ ShardedEmbedding
@pytest.mark.parametrize("opt,atol", [("sgd", 0.0), ("adam", 1e-6)])
def test_sharded_embedding_matches_reference_with_telemetry(opt, atol):
    """Lookups bitwise; SGD updates bitwise, Adam's within 1e-6 (the
    reference's program traces the step count, so its bias correction is
    f32 arithmetic)."""
    ids = (np.minimum(np.random.RandomState(4).zipf(1.5, (BATCH, SLOTS)),
                      VOCAB) - 1).astype(np.int32)
    ids[-2:] = VOCAB  # sentinel-padded tail
    grad = np.random.RandomState(5).randn(BATCH, SLOTS, DIM).astype(
        np.float32)
    remb = ref_emb.ShardedEmbedding(VOCAB, DIM, mesh=ref_mesh(
        {"dp": 1}, jax.devices()[:1]), optimizer=opt)
    with mt.cpu():
        pe = pemb.ShardedEmbedding(VOCAB, DIM, mesh=make_mesh(
            {"dp": 1}, [mt.cpu()]), optimizer=opt)
    pe.set_table(np.asarray(remb.table))
    telemetry.reset()
    for _ in range(2):
        got = pe.lookup(ids)
        np.testing.assert_allclose(got.numpy(), np.asarray(remb.lookup(ids)),
                                   rtol=0, atol=atol)
        pe.update(ids, grad, 0.01)
        remb.update(ids, grad, 0.01)
        np.testing.assert_allclose(pe.table.numpy(), np.asarray(remb.table),
                                   rtol=0, atol=atol)
    snap = telemetry.snapshot()
    assert snap["counters"]["embedding.gathered_rows"] == 2 * ids.size
    assert snap["counters"]["embedding.rows_touched"] == 2 * ids.size
    n_unique = np.unique(ids[ids < VOCAB]).size
    assert snap["gauges"]["embedding.unique_ratio"] == n_unique / ids.size
    with pytest.raises(ValueError, match="step_rows"):
        pemb.ShardedEmbedding(10, 2, mesh=make_mesh({"dp": 1}, [mt.cpu()]),
                              optimizer="adagrad")


# ---------------------------------------------------------- SPMDTrainer
def _net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Embedding(VOCAB, DIM, sparse_grad=True))
        net.add(nn.Flatten())
        net.add(nn.Dense(16, activation="relu", in_units=SLOTS * DIM))
        net.add(nn.Dense(1, in_units=16))
    return net


def _batches():
    rng = np.random.RandomState(0)
    ids = [(np.minimum(rng.zipf(1.5, (BATCH, SLOTS)), VOCAB) - 1).astype(
        np.int32) for _ in range(STEPS)]
    ids[1][-3:] = ids[1][:3]      # wrap-padded tail, masked with pad=3
    labels = [rng.randn(BATCH, 1).astype(np.float32) for _ in range(STEPS)]
    return ids, labels, [0, 3, 0]


def _strip(name):
    return name.split("_", 1)[1]


def _run(pkg, sparse, opt, init=None):
    """3 steps of either package's SPMDTrainer: ``(losses, params,
    initial values)``; the port's start from ``init`` (the reference's)."""
    ids, labels, pads = _batches()
    pkg.config.set("embedding.sharded", sparse)
    try:
        if pkg is ref:
            rb, pb = G.build(_net)
            net = rb
            mesh = ref_mesh({"dp": 1}, jax.devices()[:1])
        else:
            with mt.name.NameManager():
                net = _net(mt)
            net.initialize(ctx=mt.cpu())
            mt.convert.gluon_params_from_reference(net, init)
            mesh = make_mesh({"dp": 1}, [mt.cpu()])
        start = {k: p.data().asnumpy() for k, p in
                 net.collect_params().items()}
        tr = (RefTrainer if pkg is ref else SPMDTrainer)(
            net, pkg.gluon.loss.L2Loss(), opt.split("_")[0], dict(OPTS[opt]),
            mesh=mesh)
        losses = [float(np.asarray(tr.step(d, l, pad=p)))
                  for d, l, p in zip(ids, labels, pads)]
        tr.sync()
    finally:
        pkg.config.unset("embedding.sharded") if pkg is mt else \
            pkg.config.set("embedding.sharded", True)
    params = {_strip(k): p.data().asnumpy() for k, p in
              net.collect_params().items()}
    return np.array(losses, np.float32), params, start


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_trainer_routes_match_reference(sparse, opt):
    rl, rp, init = _run(ref, sparse, opt)
    pl, pp, _ = _run(mt, sparse, opt, init)
    atol = TRAIN_ATOL[opt]
    np.testing.assert_allclose(pl, rl, rtol=0, atol=atol)
    for name in rp:
        np.testing.assert_allclose(pp[name], rp[name], rtol=0, atol=atol,
                                   err_msg=name)
    if sparse:  # the lazy update leaves every other row as it was
        touched = np.unique(np.concatenate([b.ravel()
                                            for b in _batches()[0]]))
        untouched = np.setdiff1d(np.arange(VOCAB), touched)
        table0 = next(v for k, v in init.items()
                      if k.endswith("embedding0_weight"))
        assert _bits(pp["embedding0_weight"][untouched]) == \
            _bits(table0[untouched])


def _spied_run(sparse, init):
    """``_run`` of the port that also keeps the first step's gradients
    and unique ids."""
    seen = []
    orig = SPMDTrainer._forward_backward

    def spy(self, *a):
        out = orig(self, *a)
        if not seen:
            seen.append((out[2], out[3], out[4]))
        return out
    SPMDTrainer._forward_backward = spy
    try:
        return _run(mt, sparse, "sgd", init), seen[0]
    finally:
        SPMDTrainer._forward_backward = orig


def test_trainer_sparse_route_against_dense_route():
    """Flipping ``embedding.sharded`` flips only the gradient routing.
    First step (same weights): the MLP's gradients bitwise, and the delta
    gradient of each unique id bitwise the dense table gradient's row
    (zero elsewhere).  After 3 steps everything within 1e-7: the routes
    round the table update differently (K1 contracts ``w - lr g`` into one
    fma in the dense route, ``step_rows`` rounds twice as the reference's
    does), and later forwards see those ulps."""
    _, _, init = _run(ref, True, "sgd")
    telemetry.reset()
    (sl, sp, _), (sg, sdelta, srecs) = _spied_run(True, init)
    snap = telemetry.snapshot()["counters"]
    assert snap["embedding.rows_touched"] == STEPS * BATCH * SLOTS
    assert snap["embedding.gathered_rows"] == STEPS * BATCH * SLOTS
    (dl, dp, _), (dg, _, drecs) = _spied_run(False, init)
    assert not drecs
    # dense route leaves: [table, *mlp]; sparse: [*mlp] + the delta
    for a, b in zip(sg, dg[1:]):
        assert _bits(a.numpy()) == _bits(b.numpy())
    (uniq,), (delta,) = srecs.values(), sdelta.values()
    real = uniq.numpy() < VOCAB
    table_grad = dg[0].numpy()
    assert _bits(delta.numpy()[real]) == \
        _bits(table_grad[uniq.numpy()[real]])
    others = np.setdiff1d(np.arange(VOCAB), uniq.numpy()[real])
    assert not table_grad[others].any()
    np.testing.assert_allclose(sl, dl, rtol=0, atol=1e-7)
    for name in sp:
        np.testing.assert_allclose(sp[name], dp[name], rtol=0, atol=1e-7,
                                   err_msg=name)


def test_trainer_sparse_route_builds_no_table_gradient():
    """The routed table enters the forward undifferentiated: its tensor
    never requires grad, and each step's gradient leaf is the
    ``[capacity, dim]`` delta."""
    ids, labels, _ = _batches()
    with mt.cpu():
        net = _net(mt)
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        tr = SPMDTrainer(net, mt.gluon.loss.L2Loss(), "sgd",
                         {"learning_rate": 0.1},
                         mesh=make_mesh({"dp": 1}, [mt.cpu()]))
        seen = []
        orig = tr._forward_backward

        def spy(train, aux, tables, deltas, *a):
            seen.append(({n: t.requires_grad for n, t in tables.items()},
                         {n: tuple(d.shape) for n, d in deltas.items()}))
            return orig(train, aux, tables, deltas, *a)
        tr._forward_backward = spy
        tr.step(ids[0], labels[0])
    (tables, deltas), = seen
    assert list(tables.values()) == [False]
    assert list(deltas.values()) == [(BATCH * SLOTS, DIM)]


def test_trainer_sentinel_rows_never_touch_table():
    """A batch whose tail rows carry the sentinel id reads and writes no
    row for them."""
    with mt.cpu():
        net = _net(mt)
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        tr = SPMDTrainer(net, mt.gluon.loss.L2Loss(), "sgd",
                         {"learning_rate": 0.1},
                         mesh=make_mesh({"dp": 1}, [mt.cpu()]))
        ids = np.full((BATCH, SLOTS), VOCAB, np.int32)
        ids[:2] = 4
        name = next(n for n in tr.fn.params if n.endswith("embedding0_weight"))
        tr.step(ids, np.ones((BATCH, 1), np.float32), pad=BATCH - 2)
        t0 = tr.params[name].numpy().copy()
        loss = float(tr.step(ids, np.ones((BATCH, 1), np.float32),
                             pad=BATCH - 2))
        t1 = tr.params[name].numpy()
    assert np.isfinite(loss)
    assert _bits(t1[4]) != _bits(t0[4])
    untouched = np.setdiff1d(np.arange(VOCAB), [4])
    assert _bits(t1[untouched]) == _bits(t0[untouched])


def test_trainer_sparse_route_needs_a_lazy_optimizer():
    with mt.cpu():
        net = _net(mt)
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        tr = SPMDTrainer(net, mt.gluon.loss.L2Loss(), "adagrad",
                         {"learning_rate": 0.1},
                         mesh=make_mesh({"dp": 1}, [mt.cpu()]))
        with pytest.raises(ValueError, match="step_rows"):
            tr.step(np.zeros((BATCH, SLOTS), np.int32),
                    np.zeros((BATCH, 1), np.float32))


def test_pad_masked_loss_needs_per_sample_losses():
    with mt.cpu():
        net = _net(mt)
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        tr = SPMDTrainer(net, lambda out, label: ((out - label) ** 2).mean(),
                         "sgd", {"learning_rate": 0.1},
                         mesh=make_mesh({"dp": 1}, [mt.cpu()]))
        ids, labels, _ = _batches()
        with pytest.raises(ValueError, match="per-sample"):
            tr.step(ids[0], labels[0], pad=2)
