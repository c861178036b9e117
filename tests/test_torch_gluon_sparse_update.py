"""``gluon.Trainer`` over an ``Embedding(sparse_grad=True)`` weight, in
the port against the reference on the CPU.

The reference gives such a weight a row-sparse gradient over the ids its
lookups read, and its optimizers' lazy route (``step_rows``) updates
those rows only: a row no lookup read sees no weight decay and no
momentum or moment decay, and a looked-up row whose gradient is zero
still does.  Both nets start from the same weights and take two steps
(ids ``[1, 2, 2]``, then ``[3, 1, 1]`` with a zero head on the position
of id 3).  Rows never looked up must be bitwise their initial values in
both packages; looked-up rows are held within ``ROW_RTOL`` of the
tensor's largest value: the reference's eager ``step_rows`` rounds
``wd * w`` and ``momentum * m`` apart, where the port's contracts them,
as its compiled step does (ROADMAP queue 3's kept properties), so the two
are an ulp or so apart.
"""
import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu.name  # noqa: F401
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu_torch.convert import gluon_params_from_reference

VOCAB, DIM = 10, 4
IDS = [np.array([1, 2, 2], np.float32), np.array([3, 1, 1], np.float32)]
LOOKED_UP = (1, 2, 3)
# a few ulps of f32 at the table's scale
ROW_RTOL = 1e-6
OPTIMIZERS = {
    "sgd_momentum_wd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 0.01}),
    "adam": ("adam", {"learning_rate": 0.01}),
    "sgd_plain": ("sgd", {"learning_rate": 0.1}),
}


def _heads():
    rng = np.random.RandomState(3)
    heads = [rng.randn(3, DIM).astype(np.float32) for _ in IDS]
    heads[1][0] = 0.0   # id 3 is looked up with a zero gradient
    return heads


def _train(pkg, opt, init=None, **trainer_kw):
    """Two steps of ``pkg``'s ``gluon.Trainer``: ``(initial values by
    name, final table)`` as numpy; the port's net starts from ``init``
    (the reference's initial values)."""
    ctx = mt.cpu() if pkg is mt else ref.cpu()
    name, params = OPTIMIZERS[opt]
    with pkg.name.NameManager():
        emb = pkg.gluon.nn.Embedding(VOCAB, DIM, sparse_grad=True)
    with ctx:
        if pkg is ref:
            ref.random.seed(0)
            emb.initialize(ref.init.Uniform(0.5))
        else:
            emb.initialize(ctx=mt.cpu())
            gluon_params_from_reference(emb, init)
        start = {n: p.data().asnumpy().copy()
                 for n, p in emb.collect_params().items()}
        tr = pkg.gluon.Trainer(emb.collect_params(), name, dict(params),
                               **trainer_kw)
        for ids, head in zip(IDS, _heads()):
            x = pkg.nd.array(ids)
            with pkg.autograd.record():
                out = emb(x)
                loss = (out * pkg.nd.array(head)).sum()
            loss.backward()
            tr.step(1)
        return start, emb.weight.data().asnumpy()


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_lazy_rows_match_reference(opt):
    r_init, r_end = _train(ref, opt)
    p_init, p_end = _train(mt, opt, r_init)
    (r_start,), (p_start,) = r_init.values(), p_init.values()
    assert p_start.tobytes() == r_start.tobytes()
    untouched = [i for i in range(VOCAB) if i not in LOOKED_UP]
    for end in (r_end, p_end):
        assert end[untouched].tobytes() == r_start[untouched].tobytes()
    moved = [i for i in LOOKED_UP if not np.array_equal(r_end[i],
                                                        r_start[i])]
    # id 3's row has a zero gradient: only weight decay moves it
    assert moved == ([1, 2, 3] if opt == "sgd_momentum_wd" else [1, 2])
    scale = float(np.abs(r_end).max())
    err = float(np.abs(p_end - r_end).max()) / scale
    assert err <= ROW_RTOL, (opt, err)


def test_lazy_rows_refuse_the_kvstore_update():
    """``update_on_kvstore`` would update the rows densely from the
    store's sum: the port raises with the reason."""
    with mt.cpu():
        emb = mt.gluon.nn.Embedding(VOCAB, DIM, sparse_grad=True)
        emb.initialize(ctx=mt.cpu())
        tr = mt.gluon.Trainer(emb.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore="local",
                              update_on_kvstore=True)
        with mt.autograd.record():
            loss = emb(mt.nd.array(IDS[0])).sum()
        loss.backward()
        with pytest.raises(NotImplementedError, match="update_on_kvstore"):
            tr.step(1)


def test_rows_are_forgotten_after_each_step():
    """The rows noted under ``record()`` are the union of every lookup
    since the last step, deduplicated, and a step consumes them."""
    with mt.cpu():
        emb = mt.gluon.nn.Embedding(VOCAB, DIM, sparse_grad=True)
        emb.initialize(ctx=mt.cpu())
        emb(mt.nd.array(IDS[0]))          # not recorded: no rows
        assert emb.weight.take_rows() is None
        with mt.autograd.record():
            emb(mt.nd.array(IDS[0]))
            emb(mt.nd.array(IDS[1]))
        rows = emb.weight.take_rows()
        assert rows[rows >= 0].tolist() == [1, 2, 3]
        assert emb.weight.take_rows() is None
