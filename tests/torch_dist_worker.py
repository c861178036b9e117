"""Worker of tests/test_torch_dist.py: one rank of a gloo group on the
CPU, started by ``python -m mxnet_tpu_torch.launch -n N``.

Not a pytest file, and it never imports JAX: it reads its inputs from
``<workdir>/inputs.npz`` (written by the test, which computes the
reference's results in its own process) and writes each rank's results
to ``<workdir>/rank<r>_<scenario>.npz``.  Run::

    python -m mxnet_tpu_torch.launch -n 2 python tests/torch_dist_worker.py WORKDIR

The model builders here are shared with the test (numpy-only at import).
"""
import os
import sys

import numpy as np

# the data-parallel DLRM-style model, at test size
VOCAB, DIM, HIDDEN, SLOTS, STEPS, LR = 1000, 8, 16, 4, 3, 0.05
# the compressed step's exact-arithmetic model: Dense(1) over 4 features
DCN_FEAT, DCN_LR, DCN_THRESHOLD = 4, 0.25, 0.5


def dlrm_net(pkg, vocab=VOCAB, dim=DIM, hidden=HIDDEN):
    """``Embedding(sparse_grad=True)`` -> ``Flatten`` -> ``Dense(relu)``
    -> ``Dense(1)``, as ``bench.py``'s ``dlrm_embedding_config``."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Embedding(vocab, dim, sparse_grad=True))
        net.add(nn.Flatten())
        net.add(nn.Dense(hidden, activation="relu", in_units=SLOTS * dim))
        net.add(nn.Dense(1, in_units=hidden))
    return net


def dcn_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(1, in_units=DCN_FEAT))
    return net


def global_batches(n_ranks, seed=0, steps=STEPS):
    """Seeded Zipf id batches of ``4 * n_ranks`` rows, their labels and
    the pad of each step (the second step's last 3 rows are fill)."""
    rng = np.random.RandomState(seed)
    rows = 4 * n_ranks
    ids = [np.minimum(rng.zipf(1.5, (rows, SLOTS)), VOCAB).astype(np.int32)
           - 1 for _ in range(steps)]
    labels = [rng.randn(rows, 1).astype(np.float32) for _ in range(steps)]
    pads = [0, 3, 0][:steps]
    return ids, labels, pads


def dcn_batches(n_ranks, exact, seed=1, steps=STEPS):
    """Features, labels and initial weights of the compressed step: with
    ``exact``, small dyadic values, so every product and sum of the step
    is exact in f32 and the step is bitwise in either package."""
    rng = np.random.RandomState(seed)
    rows = 4 * n_ranks
    if exact:
        xs = [rng.randint(-2, 3, (rows, DCN_FEAT)).astype(np.float32) / 2
              for _ in range(steps)]
        ys = [rng.randint(-4, 5, (rows, 1)).astype(np.float32) / 4
              for _ in range(steps)]
        w = rng.randint(-8, 9, (1, DCN_FEAT)).astype(np.float32) / 8
        b = np.array([0.125], np.float32)
    else:
        xs = [rng.randn(rows, DCN_FEAT).astype(np.float32)
              for _ in range(steps)]
        ys = [rng.randn(rows, 1).astype(np.float32) for _ in range(steps)]
        w = rng.randn(1, DCN_FEAT).astype(np.float32) * 0.5
        b = np.array([0.1], np.float32)
    return xs, ys, {"weight": w, "bias": b}


def _strip(name):
    return name.split("_", 1)[1]


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _kvstore(mx, rank, n):
    """The dist_sync contract of tests/dist_worker.py (value-exact
    sums, pushpull, host_allreduce, row_sparse_pull over dense rows,
    2-bit compression with error feedback) and gluon.Trainer over
    dist_sync with compression_params."""
    from mxnet_tpu_torch import parallel, telemetry
    from mxnet_tpu_torch.parallel.compression import (two_bit_compress,
                                                      two_bit_decompress)
    import torch
    kv = mx.kv.create("dist_sync")   # bootstraps the rendezvous itself
    assert (kv.rank, kv.num_workers) == (rank, n), (kv.rank, kv.num_workers)
    shapes = {"3": (4, 4), "5": (7, 3), "9": (2, 5, 2)}
    for k, shp in shapes.items():
        kv.init(k, mx.nd.ones(shp))
    kv.barrier()
    expect = float(sum(r + 1 for r in range(n)))
    for _ in range(3):
        for k, shp in shapes.items():
            kv.push(k, mx.nd.ones(shp) * (rank + 1))
            out = mx.nd.zeros(shp)
            kv.pull(k, out=out)
            np.testing.assert_array_equal(out.asnumpy(), expect)
        kv.barrier()
    for k, shp in shapes.items():
        val = mx.nd.ones(shp) * (rank + 1)
        kv.pushpull(k, val, out=val)
        np.testing.assert_array_equal(val.asnumpy(), expect)
    total = parallel.host_allreduce(np.full((3, 2), rank + 1.0, np.float32))
    np.testing.assert_array_equal(total, expect)
    # row_sparse_pull over dense rows: every rank pushes its own row and a
    # shared one; the pull gathers only the requested rows
    rows, dim = 4 * n + 4, 3
    kv.init("emb", mx.nd.zeros((rows, dim)))
    grad = np.zeros((rows, dim), np.float32)
    grad[0] = grad[4 + rank] = rank + 1.0
    kv.push("emb", mx.nd.array(grad))
    out = mx.nd.zeros((rows, dim))
    kv.row_sparse_pull("emb", out=out,
                       row_ids=mx.nd.array([0, 4 + rank, 4 + rank]))
    got = out.asnumpy()
    np.testing.assert_array_equal(got[0], expect)
    np.testing.assert_array_equal(got[4 + rank], rank + 1.0)
    untouched = np.setdiff1d(np.arange(rows), [0, 4 + rank])
    assert not got[untouched].any()
    kv.barrier()
    # 2-bit compression: every rank pushes the same sub-threshold
    # gradient; each round pulls n * threshold * code, the codes following
    # the one-worker error-feedback recursion
    thr = 0.5
    kv.set_gradient_compression({"type": "2bit", "threshold": thr})
    kv.init("c", mx.nd.zeros((6,)))
    g = torch.full((6,), 0.3)
    res = torch.zeros(6)
    fired = 0
    for rnd in range(4):
        codes, res = two_bit_compress(g, res, thr)
        want = n * two_bit_decompress(codes, thr).numpy()
        kv.push("c", mx.nd.array(g.numpy()))
        out = mx.nd.zeros((6,))
        kv.pull("c", out=out)
        np.testing.assert_array_equal(out.asnumpy(), want,
                                      err_msg="round %d" % rnd)
        fired += int(want.any())
        kv.barrier()
    assert 1 <= fired < 4, fired
    snap = telemetry.snapshot()
    assert snap["counters"]["kvstore.compressed_bytes"] > 0, snap
    assert snap["gauges"]["kvstore.compression_ratio"] >= 8.0, snap
    # gluon.Trainer over dist_sync with compression: update_on_kvstore,
    # so the store sums every rank's codes and the updater steps on it
    w = mx.gluon.Parameter("w", shape=(5,))
    w.initialize(mx.init.Zero(), ctx=mx.cpu())
    tr = mx.gluon.Trainer([w], "sgd", {"learning_rate": 1.0},
                          kvstore="dist_sync",
                          compression_params={"type": "2bit",
                                              "threshold": 0.25})
    base = np.array([0.1, -0.2, 0.3, -0.05, 0.26], np.float32)
    res = [torch.zeros(5) for _ in range(n)]
    want = np.zeros(5, np.float32)
    for _ in range(3):
        with mx.autograd.record():
            y = (w.data() * mx.nd.array(base * (rank + 1))).sum()
        y.backward()
        tr.step(1)
        tot = torch.zeros(5, dtype=torch.int32)
        for r in range(n):
            c, res[r] = two_bit_compress(torch.tensor(base * (r + 1)),
                                         res[r], 0.25)
            tot += c.to(torch.int32)
        want = want - 1.0 * (tot.float().numpy() * np.float32(0.25))
        np.testing.assert_array_equal(w.data().asnumpy(), want)
    assert tr._update_on_kvstore
    kv.barrier()
    # a mesh over every rank works; one over more devices than ranks
    # raises, and so does one over fewer (but more than one)
    mesh = parallel.make_mesh({"dp": n})
    assert mesh.size == n and mesh.device.type == "cpu"
    for bad in ({"dp": n + 1}, {"dp": n, "tp": 2}):
        try:
            parallel.make_mesh(bad)
        except RuntimeError:
            pass
        else:
            raise AssertionError("make_mesh(%r) did not raise" % (bad,))


def _lookup(mx, rank, n, workdir):
    """The sharded lookup (each rank's shard, summed over the axis) is
    bitwise the one-rank lookup of the whole table, -0.0 rows and
    sentinel ids included; writes this rank's answer."""
    import torch
    from mxnet_tpu_torch.parallel import embedding as pemb
    from mxnet_tpu_torch.parallel import make_mesh
    rng = np.random.RandomState(3)
    rows = 8 * n
    full = torch.tensor(rng.randn(rows, DIM).astype(np.float32))
    full[5] = -0.0
    ids = torch.tensor(np.concatenate([rng.randint(0, rows, 20), [5, rows,
                                                                  rows + 7]]))
    uniq, _ = pemb.dedup_ids(ids, ids.numel(), rows)
    mesh = make_mesh({"dp": n})
    shard = full[rank * 8:(rank + 1) * 8]
    got = pemb.lookup_unique(shard, uniq, mesh, "dp")
    want = pemb.lookup_unique(full, uniq)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    # ShardedEmbedding over the ranks against a rank-local one: every
    # rank passes the same ids and gradients
    sharded = pemb.ShardedEmbedding(rows, DIM, mesh=mesh, optimizer="sgd")
    local = pemb.ShardedEmbedding(rows, DIM, optimizer="sgd",
                                  mesh=make_mesh({"dp": 1}, [mx.cpu()]))
    assert sharded.axis == "dp" and local.axis is None
    for emb in (sharded, local):
        emb.set_table(full)
    grad = torch.tensor(rng.randn(ids.numel(), DIM).astype(np.float32))
    for _ in range(2):
        a, b = sharded.lookup(ids), local.lookup(ids)
        assert a.numpy().tobytes() == b.numpy().tobytes()
        sharded.update(ids, grad, 0.1)
        local.update(ids, grad, 0.1)
    assert sharded.table.numpy().tobytes() == \
        local.table[rank * 8:(rank + 1) * 8].numpy().tobytes()
    # shard_batch: this rank's rows of the global batch
    batch = np.arange(8 * n, dtype=np.float32).reshape(4 * n, 2)
    mine = mx.parallel.shard_batch(mesh, {"x": batch})["x"]
    assert mine.numpy().tobytes() == batch[4 * rank:4 * (rank + 1)].tobytes()
    np.savez(os.path.join(workdir, "rank%d_lookup.npz" % rank),
             table=full.numpy(), uniq=uniq.numpy(), rows=got.numpy())


def _train(mx, rank, n, workdir, inputs, sparse, opt):
    """3 SPMDTrainer steps of the DLRM-style model over ``{"dp": n}`` on
    the global batches; writes the losses and the synced parameters."""
    from mxnet_tpu_torch import config, convert
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    tag = "%s_%s" % ("sparse" if sparse else "dense", opt)
    config.set("embedding.sharded", sparse)
    try:
        with mx.name.NameManager():
            net = dlrm_net(mx)
        net.initialize(ctx=mx.cpu())
        convert.gluon_params_from_reference(
            net, {k[len("init/"):]: inputs[k] for k in inputs
                  if k.startswith("init/")})
        optp = {"learning_rate": LR if opt == "sgd" else 0.01}
        tr = SPMDTrainer(net, mx.gluon.loss.L2Loss(), opt, optp,
                         mesh=make_mesh({"dp": n}))
        losses = []
        for s in range(STEPS):
            losses.append(float(tr.step(inputs["ids%d" % s],
                                        inputs["labels%d" % s],
                                        pad=int(inputs["pads"][s]))))
        routed = tr._routed()
        shard = {n_: tuple(tr.params[n_].shape) for n_ in routed}
        # a checkpoint of the sharded trainer, gathered whole and written
        # by rank 0, restores every rank's shard and state bitwise
        ckpt = os.path.join(workdir, "%s.ckpt" % tag)
        tr.save_checkpoint(ckpt)
        back = SPMDTrainer(net, mx.gluon.loss.L2Loss(), opt, optp,
                           mesh=make_mesh({"dp": n}))
        assert back.load_checkpoint(ckpt) == STEPS
        restored = all(
            back.params[k].detach().numpy().tobytes()
            == tr.params[k].detach().numpy().tobytes() for k in tr.params)
        restored &= all(
            a.numpy().tobytes() == b.numpy().tobytes()
            for k in tr.opt_state
            for a, b in zip(_leaves(back.opt_state[k]),
                            _leaves(tr.opt_state[k])))
        tr.sync()
    finally:
        config.unset("embedding.sharded")
    out = {"loss": np.array(losses, np.float32),
           "checkpoint_restored": np.array(restored)}
    for name, p in net.collect_params().items():
        out["param/" + _strip(name)] = p.data().asnumpy()
    for name, shp in shard.items():
        out["shard/" + _strip(name)] = np.array(shp)
    np.savez(os.path.join(workdir, "rank%d_%s.npz" % (rank, tag)), **out)


def _dcn(mx, rank, n, workdir, inputs, exact):
    """3 compressed steps on a ``{"dcn": n}`` mesh; writes the losses,
    parameters and each step's residuals."""
    from mxnet_tpu_torch import config, convert
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    tag = "dcn_exact" if exact else "dcn_random"
    pre = tag + "/"
    config.set("kvstore.grad_compress", "2bit")
    config.set("kvstore.grad_compression_threshold", DCN_THRESHOLD)
    try:
        with mx.name.NameManager():
            net = dcn_net(mx)
        net.initialize(ctx=mx.cpu())
        convert.gluon_params_from_reference(
            net, {k[len(pre + "init/"):]: inputs[k] for k in inputs
                  if k.startswith(pre + "init/")})
        tr = SPMDTrainer(net, mx.gluon.loss.L2Loss(), "sgd",
                         {"learning_rate": DCN_LR},
                         mesh=make_mesh({"dcn": n}))
        out = {}
        for s in range(STEPS):
            out["loss%d" % s] = tr.step(inputs[pre + "x%d" % s],
                                        inputs[pre + "y%d" % s]).numpy()
            for name, r in tr._dcn_residuals.items():
                out["res%d/%s" % (s, _strip(name))] = r.numpy()
            for name, c in zip(tr.fn.trainable, tr._dcn_codes):
                out["codes%d/%s" % (s, _strip(name))] = c.numpy()
        tr.sync()
    finally:
        config.unset("kvstore.grad_compress")
        config.unset("kvstore.grad_compression_threshold")
    for name, p in net.collect_params().items():
        out["param/" + _strip(name)] = p.data().asnumpy()
    np.savez(os.path.join(workdir, "rank%d_%s.npz" % (rank, tag)), **out)


def main(workdir):
    import mxnet_tpu_torch as mx
    import mxnet_tpu_torch.name  # noqa: F401  (loaded lazily)
    rank = int(os.environ["MXTPU_PROCESS_ID"])
    n = int(os.environ["MXTPU_NUM_PROCESSES"])
    with mx.cpu():
        _kvstore(mx, rank, n)
        if os.environ.get("MXTPU_TEST_DIE_RANK") == str(rank):
            # failure fixture: this rank dies; the launcher must end the
            # job promptly instead of leaving the others in a collective
            print("WORKER_DYING rank=%d" % rank, flush=True)
            os._exit(17)
        mx.parallel.barrier()
        _lookup(mx, rank, n, workdir)
        inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
        for sparse in (True, False):
            _train(mx, rank, n, workdir, inputs, sparse, "sgd")
        _train(mx, rank, n, workdir, inputs, True, "adam")
        for exact in (True, False):
            _dcn(mx, rank, n, workdir, inputs, exact)
        mx.parallel.barrier()
    print("WORKER_OK rank=%d/%d" % (rank, n), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
