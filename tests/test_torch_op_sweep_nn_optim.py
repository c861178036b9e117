"""The port's ``ops/nn``, ``ops/optim_ops`` and ``ops/linalg`` against the
reference, op by op (the machinery and tolerances of
``tests/test_torch_op_sweep.py``, which holds the other modules): the
reference sweep's inputs and ``chip_smoke.py``'s cases, forward and
gradients.  Then the update ops
over option sets (weight decay, clipping, rescaling, f16 and bf16
weights over f32 masters), ``Dropout``'s deterministic part given a mask
and its draws, the MXNet conventions the port follows where the
reference does not (CTC's ``blank_label="last"``, ``Deconvolution``'s
``target_shape``, bilinear ``UpSampling``), and a ``mx.sym`` graph of new
ops through both packages' ``Executor``."""
import numpy as np
import pytest

import jax.numpy as jnp

import mxnet_tpu as ref
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import apply_op as ref_apply
from mxnet_tpu_torch.ops.registry import apply_op as port_apply

import _torch_ops as T
import test_op_sweep as ref_sweep

MODULES = ("nn", "optim_ops", "linalg")
SPEC_OPS = [n for n in T.slice_ops(*MODULES) if n in ref_sweep.SPECS]
CARD = T.chip_cases(MODULES)


def test_every_op_of_these_modules_is_swept():
    ops = set(T.slice_ops(*MODULES))
    assert ops == set(SPEC_OPS)
    assert ops == {c.partition("@")[0] for c in CARD}


@pytest.mark.parametrize("name", SPEC_OPS)
def test_op_matches_reference_on_sweep_inputs(name):
    arrays, attrs = T.spec_inputs(ref_sweep, name)
    T.check_op(name, arrays, attrs,
               T.chip_smoke.INDEX_INPUTS.get(name, ()))


@pytest.mark.parametrize("case", sorted(CARD))
def test_op_matches_reference_on_card_cases(case):
    op, arrays, attrs, dtypes = CARD[case]
    T.check_op(op, arrays, attrs, T.chip_smoke.INDEX_INPUTS.get(op, ()),
               dtypes)


# ------------------------------------------------------ update op options
# (op, the number of (weight, grad, states...) inputs, attrs); the
# multi-tensor ops take two groups
_UPDATES = [
    ("sgd_update", 2, {"lr": 0.1}),
    ("sgd_mom_update", 3, {"lr": 0.1, "momentum": 0.9}),
    ("nag_mom_update", 3, {"lr": 0.1, "momentum": 0.9}),
    ("adam_update", 4, {"lr": 0.01}),
    ("ftml_update", 5, {"lr": 0.01, "t": 3}),
    ("rmsprop_update", 3, {"lr": 0.01, "clip_weights": 0.5}),
    ("rmspropalex_update", 5, {"lr": 0.01}),
    ("ftrl_update", 4, {"lr": 0.1}),
    ("signsgd_update", 2, {"lr": 0.1}),
    ("signum_update", 3, {"lr": 0.1, "momentum": 0.9, "wd_lh": 0.01}),
    ("lamb_update_phase1", 4, {"t": 3}),
    ("_sparse_adagrad_update", 3, {"lr": 0.1}),
    ("_contrib_group_adagrad_update", 3, {"lr": 0.1}),
]
_MP = [
    ("mp_sgd_update", 3, {"lr": 0.1}),
    ("mp_sgd_mom_update", 4, {"lr": 0.1, "momentum": 0.9}),
    ("mp_nag_mom_update", 4, {"lr": 0.1, "momentum": 0.9}),
]
_MULTI = [
    ("multi_sgd_update", 2, {}),
    ("multi_sgd_mom_update", 3, {"momentum": 0.9}),
    ("multi_mp_sgd_update", 3, {}),
    ("multi_mp_sgd_mom_update", 4, {"momentum": 0.9}),
]
_OPTIONS = {
    "wd_rescale": {"wd": 0.01, "rescale_grad": 0.7},
    "clip": {"clip_gradient": 0.05, "rescale_grad": 2.0},
}
# low-precision weights and gradients over f32 masters and states: the
# rescale is a power of two (exact in any dtype), since XLA may keep a
# bf16 product in f32 before its cast where PyTorch rounds it
_LOW = {"f16": ("float16", {"wd": 0.01, "rescale_grad": 0.5}),
        "bf16": ("bfloat16", {"clip_gradient": 0.05, "rescale_grad": 2.0})}


def _update_inputs(name, n, rng):
    """Weight, gradient, then states in [0.01, 0.1) (most pass through a
    square root); an mp op's f32 master is the weight itself."""
    w = (rng.randn(4, 3) * 0.5).astype(np.float32)
    g = (rng.randn(4, 3) * 0.2).astype(np.float32)
    states = [rng.uniform(0.01, 0.1, (4, 3)).astype(np.float32)
              for _ in range(n - 2)]
    if name == "_contrib_group_adagrad_update":
        states = [states[0][:, :1].copy()]
    if name.startswith("mp_") or name.startswith("multi_mp_"):
        states[-1] = w.copy()
    return [w, g] + states


_CASES = [(n, k, a, o, None) for n, k, a in _UPDATES + _MP for o in _OPTIONS]
_CASES += [(n, k, a, o, low) for n, k, a in _MP for o, low in _LOW.items()]
_CASES += [(n, k, a, o, None) for n, k, a in _MULTI for o in _OPTIONS]
_CASES += [(n, k, a, o, low) for n, k, a in _MULTI if "_mp_" in n
           for o, low in _LOW.items()]


@pytest.mark.parametrize("name,n,attrs,opt,low", _CASES,
                         ids=["%s-%s" % (c[0], c[3]) for c in _CASES])
def test_update_op_matches_reference_over_options(name, n, attrs, opt, low):
    rng = np.random.RandomState(sum(map(ord, name + opt)))
    attrs = dict(attrs)
    if low is not None:
        dtype, opts = low
    else:
        dtype, opts = None, _OPTIONS[opt]
    if name.startswith("multi_"):
        arrays = _update_inputs(name[len("multi_"):], n, rng) \
            + _update_inputs(name[len("multi_"):], n, rng)
        attrs.update(lrs=(0.1, 0.05), wds=(opts.get("wd", 0.0), 0.02),
                     num_weights=2,
                     **{k: v for k, v in opts.items() if k != "wd"})
        low_inputs = (0, 1, n, n + 1)
    else:
        arrays = _update_inputs(name, n, rng)
        attrs.update(opts)
        low_inputs = (0, 1)
    dtypes = [dtype if i in low_inputs else None for i in range(len(arrays))]
    with mt.cpu():
        got = port_apply(name, *[mt.nd.array(a, dtype=d)
                                 for a, d in zip(arrays, dtypes)], **attrs)
    want = ref_apply(name, *[ref.nd.array(a, dtype=d)
                             for a, d in zip(arrays, dtypes)], **attrs)
    got, want = T._outs(got), T._outs(want)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        T.assert_same(name, "output %d" % k, g.asnumpy(), w.asnumpy())
    if low is not None:
        # each low-precision weight is the cast of its new f32 master
        n_w = 2 if name.startswith("multi_") else 1
        for wk, mk in zip(range(n_w), range(len(got) - n_w, len(got))):
            np.testing.assert_array_equal(
                got[wk].asnumpy().astype(np.float32),
                got[mk].asnumpy().astype(dtype).astype(np.float32))


@pytest.mark.parametrize("name", ["_multi_adamw_update",
                                  "_multi_mp_adamw_update"])
def test_multi_adamw_skips_the_step_on_a_bad_scale(name):
    rng = np.random.RandomState(4)
    per = 5 if "_mp_" in name else 4
    group = [rng.randn(6).astype(np.float32) for _ in range(per)]
    group[3] = np.abs(group[3])
    for scale in (1.0, 0.5, float("nan"), float("inf"), 0.0):
        arrays = group + [np.asarray([scale], np.float32)]
        attrs = {"lrs": (0.1,), "wds": (0.01,), "etas": (1.0,),
                 "clip_gradient": 0.3}
        with mt.cpu():
            got = port_apply(name, *[mt.nd.array(a) for a in arrays],
                             **attrs)
        want = ref_apply(name, *[ref.nd.array(a) for a in arrays], **attrs)
        for k, (g, w) in enumerate(zip(got, want)):
            T.assert_same(name, "output %d at scale %s" % (k, scale),
                          g.asnumpy(), w.asnumpy())


# ------------------------------------------------------------ Dropout
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_deterministic_part_matches_reference_given_a_mask(dtype):
    """``where(mask, x / keep, 0)`` in the input's dtype, bit for bit, for
    a mask both packages receive."""
    from mxnet_tpu_torch.ops.nn import dropout_apply
    import torch
    rng = np.random.RandomState(0)
    x = rng.randn(64, 96).astype(np.float32)
    mask = rng.rand(64, 96) < 0.9
    for p in (0.1, 0.5, 0.3):
        keep = 1.0 - p
        with mt.cpu():
            xt = mt.nd.array(x, dtype=dtype)._data
            got = mt.nd.NDArray(dropout_apply(xt, torch.as_tensor(mask),
                                              keep), ctx=mt.cpu()).asnumpy()
        xj = ref.nd.array(x, dtype=dtype)._data
        want = np.asarray(jnp.where(mask, xj / keep, 0.0).astype(xj.dtype))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.astype(np.float32),
                                      want.astype(np.float32))


def test_dropout_draws_in_training_only_and_repeats_from_a_seed():
    x = np.random.RandomState(1).randn(200, 300).astype(np.float32) + 3.0
    with mt.cpu():
        nd = mt.nd.array(x)
        np.testing.assert_array_equal(mt.nd.Dropout(nd, p=0.1).asnumpy(), x)
        mt.random.seed(7)
        a = mt.nd.Dropout(nd, p=0.1, training=True).asnumpy()
        mt.random.seed(7)
        b = mt.nd.Dropout(nd, p=0.1, training=True).asnumpy()
        c = mt.nd.Dropout(nd, p=0.1, mode="always").asnumpy()
        ax = mt.nd.Dropout(nd, p=0.5, axes=(1,), training=True).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    kept = a != 0
    n = kept.size
    assert abs(kept.mean() - 0.9) <= 5 * np.sqrt(0.9 * 0.1 / n)
    np.testing.assert_array_equal(a[kept], (x / np.float32(0.9))[kept])
    # a mask shared along axis 1: whole rows kept or dropped
    rows = (ax != 0).mean(axis=1)
    assert set(np.unique(rows)) <= {0.0, 1.0}
    ref.random.seed(7)
    r = ref_apply("Dropout", ref.nd.array(x), p=0.1, training=True)
    rk = r.asnumpy() != 0
    assert abs(kept.mean() - rk.mean()) <= 6 * np.sqrt(2 * 0.09 / n)


# --------------------------------------------- MXNet's conventions
def test_ctc_blank_last_is_blank_first_with_the_classes_rotated():
    """``blank_label="last"`` reserves class V-1 (tokens 0..V-2, -1
    pads): the same loss as the reference's ``"first"`` with the last
    class moved to the front and the tokens shifted up by one."""
    rng = np.random.RandomState(3)
    data = rng.randn(6, 3, 5).astype(np.float32)
    label = np.asarray([[0, 2, 1], [3, 3, -1], [1, -1, -1]], np.float32)
    with mt.cpu():
        d = mt.nd.array(data)
        d.attach_grad()
        with mt.autograd.record():
            loss = mt.nd.CTCLoss(d, mt.nd.array(label), blank_label="last")
        loss.backward()
    rot = np.concatenate([data[..., -1:], data[..., :-1]], axis=-1)
    shifted = np.where(label >= 0, label + 1, -1).astype(np.float32)
    rd = ref.nd.array(rot)
    rd.attach_grad()
    with ref.autograd.record():
        want = ref.nd.CTCLoss(rd, ref.nd.array(shifted))
    want.backward()
    T.assert_same("CTCLoss", "loss", loss.asnumpy(), want.asnumpy())
    g = rd.grad.asnumpy()
    T.assert_same("CTCLoss", "gradient", d.grad.asnumpy(),
                  np.concatenate([g[..., 1:], g[..., :1]], axis=-1))


def test_deconvolution_target_shape_sets_the_output_size():
    """MXNet derives pad and adj from ``target_shape``; without it the
    port matches the reference at that pad and adj."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 2, 5, 5).astype(np.float32)
    w = rng.randn(2, 3, 4, 4).astype(np.float32)
    with mt.cpu():
        for tgt in ((10, 10), (11, 11), (12, 9)):
            out = mt.nd.Deconvolution(mt.nd.array(x), mt.nd.array(w),
                                      kernel=(4, 4), stride=(2, 2),
                                      num_filter=3, target_shape=tgt)
            assert out.shape[2:] == tgt
        got = mt.nd.Deconvolution(mt.nd.array(x), mt.nd.array(w),
                                  kernel=(4, 4), stride=(2, 2), num_filter=3,
                                  target_shape=(11, 11)).asnumpy()
    # 2 * (5 - 1) + 4 - 11 = 1: pad 1, adj 1
    want = ref.nd.Deconvolution(ref.nd.array(x), ref.nd.array(w),
                                kernel=(4, 4), stride=(2, 2), num_filter=3,
                                pad=(1, 1), adj=(1, 1)).asnumpy()
    T.assert_same("Deconvolution", "output", got, want)


def test_bilinear_upsampling_is_mxnets_grouped_deconvolution():
    """``UpSampling(x, w, sample_type="bilinear")`` is MXNet's: a
    deconvolution by ``w`` per channel, stride ``s``, kernel ``2s - s %
    2``, pad ``ceil((s - 1) / 2)``; held against the reference's
    Deconvolution channel by channel."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    for s in (2, 3):
        k = 2 * s - s % 2
        w = rng.randn(3, 1, k, k).astype(np.float32)
        with mt.cpu():
            got = mt.nd.UpSampling(mt.nd.array(x), mt.nd.array(w), scale=s,
                                   sample_type="bilinear",
                                   num_filter=3).asnumpy()
        for c in range(3):
            want = ref.nd.Deconvolution(
                ref.nd.array(x[:, c:c + 1]), ref.nd.array(w[c:c + 1]),
                kernel=(k, k), stride=(s, s), pad=((s - 1 + 1) // 2,) * 2,
                num_filter=1).asnumpy()
            T.assert_same("UpSampling", "channel %d" % c, got[:, c:c + 1],
                          want)


def test_new_ops_in_a_symbol_graph_match_reference_executor():
    """LayerNorm, broadcast_maximum, topk and Dropout (inference) in one
    ``mx.sym`` graph, evaluated by both packages' ``Executor``."""
    rng = np.random.RandomState(8)
    feeds = {"x": rng.randn(4, 16).astype(np.float32),
             "g": rng.uniform(0.5, 1.5, 16).astype(np.float32),
             "b": rng.randn(16).astype(np.float32) * 0.1,
             "y": rng.randn(4, 16).astype(np.float32)}

    def graph(mx):
        x, g, b, y = (mx.sym.Variable(n) for n in ("x", "g", "b", "y"))
        ln = mx.sym.LayerNorm(x, g, b, name="ln")
        mx_ = mx.sym.broadcast_maximum(ln, y, name="bmax")
        dr = mx.sym.Dropout(mx_, p=0.5, name="drop")
        tk = mx.sym.topk(dr, k=3, ret_typ="value", name="topk")
        return mx.sym.Group([dr, tk])

    with mt.cpu():
        ex = graph(mt).bind(mt.cpu(), {k: mt.nd.array(v)
                                       for k, v in feeds.items()})
        got = [o.asnumpy() for o in ex.forward(is_train=False)]
    rex = graph(ref).bind(ref.cpu(), {k: ref.nd.array(v)
                                      for k, v in feeds.items()})
    want = [o.asnumpy() for o in rex.forward(is_train=False)]
    assert len(got) == len(want) == 2
    for k, (g, w) in enumerate(zip(got, want)):
        T.assert_same("symbol graph", "output %d" % k, g, w)
