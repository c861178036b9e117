"""The multi-tensor Adam update (K3) and its routes, on the CPU.

``cuda_kernels.fused_adam_step_multi`` updates a whole list of tensors in
one launch of ``csrc/adam_step.cu`` on the card; here its plain version
runs tensor by tensor.  Held, with inputs made by numpy from a seed:

* the plain multi version against the reference's Pallas
  ``fused_adam_step`` in interpret mode, tensor by tensor: bitwise;
* the launch table K1 and K3 share (``LaunchTable``), read on the host:
  first blocks, rebuilds, the columns rewritten at each launch;
* the checks: a tensor the kernel cannot take is named by its index;
* ``Updater`` / ``update_multi_precision`` called with lists against the
  same calls per index: bitwise;
* a small ``SPMDTrainer`` under Adam against the reference's, from the
  same weights, within the tolerances stated there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JLoss
from mxnet_tpu.gluon.model_zoo.vision.resnet import BottleneckV1 as JBlock
from mxnet_tpu.gluon.model_zoo.vision.resnet import ResNetV1 as JResNet
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel import SPMDTrainer as JTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import gluon_params_to_reference
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import BottleneckV1
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import ResNetV1
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.optimizer.optimizer import _bias_corrected_lr
from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh

B1, B2, EPS = 0.9, 0.999, 1e-8
#: a mixed list: a 2-D tensor, a vector, a count that is not a multiple
#: of 4
SHAPES = [(37, 13), (256,), (5, 3, 7)]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _lists(shapes, seed=4):
    rng = np.random.RandomState(seed)
    ws = [(rng.randn(*s) * 0.02).astype(np.float32) for s in shapes]
    gs = [rng.randn(*s).astype(np.float32) for s in shapes]
    ms = [(rng.randn(*s) * 0.1).astype(np.float32) for s in shapes]
    vs = [(np.abs(rng.randn(*s)) * 0.01).astype(np.float32) for s in shapes]
    return ws, gs, ms, vs


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("varied", [False, True], ids=["same", "per-tensor"])
@pytest.mark.parametrize("t", [1, 1000])
@pytest.mark.parametrize("grad", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("cast", ["float32", "bfloat16", "float16"])
def test_multi_plain_bitwise_with_pallas(cast, grad, t, varied):
    """``fused_adam_step_multi`` on CPU tensors (its plain version, tensor
    by tensor) equals the reference's Pallas ``fused_adam_step`` in
    interpret mode bit for bit on every tensor's master, m, v and cast;
    with one lr_t and wd for the list, or a different pair per tensor."""
    ws, gs, ms, vs = _lists(SHAPES)
    n = len(SHAPES)
    lrs = [1e-3, 5e-4, 2e-3] if varied else [1e-3] * n
    ts = [t, t + 7, max(t - 1, 1)] if varied else [t] * n
    lr_ts = [float(_bias_corrected_lr(lr, B1, B2, ti))
             for lr, ti in zip(lrs, ts)]
    wds = [0.01, 0.0, 1e-4] if varied else [0.01] * n
    tdt = getattr(torch, cast)
    tw, tm, tv = ([torch.from_numpy(x.copy()) for x in xs]
                  for xs in (ws, ms, vs))
    tg = [torch.from_numpy(g).to(getattr(torch, grad)) for g in gs]
    outs = [None if cast == "float32" else torch.empty(s, dtype=tdt)
            for s in SHAPES]
    before = dict(ck.LAUNCHES)
    ck.fused_adam_step_multi(tw, tg, tm, tv, lr_ts, wds, B1, B2, EPS,
                             outs=outs)
    assert ck.LAUNCHES == before, "a CPU tensor must not launch a kernel"
    for i in range(n):
        lp, nw, (nm, nv) = pk.fused_adam_step(
            jnp.asarray(ws[i]), jnp.asarray(gs[i]).astype(getattr(jnp, grad)),
            jnp.asarray(ms[i]), jnp.asarray(vs[i]), np.float32(lr_ts[i]),
            wds[i], B1, B2, EPS, out_dtype=getattr(jnp, cast))
        got_lp = tw[i] if outs[i] is None else outs[i]
        for want, got in ((nw, tw[i]), (nm, tm[i]), (nv, tv[i]),
                          (lp, got_lp)):
            np.testing.assert_array_equal(
                _bits(got.float().numpy()),
                _bits(jnp.asarray(want, jnp.float32)), err_msg=str(i))


def test_one_entry_form_is_the_multi_form():
    """``fused_adam_step`` (the reference's single-tensor entry) is a
    one-entry list: the same bits as the multi form, allocating new
    tensors by default and writing in place through ``out``."""
    ws, gs, ms, vs = _lists([(9, 5)])
    w, g, m, v = (torch.from_numpy(x[0].copy()) for x in (ws, gs, ms, vs))
    lp, nw, (nm, nv) = ck.fused_adam_step(w, g, m, v, 1e-3, 0.01, B1, B2,
                                          EPS, out_dtype=torch.float16)
    assert nw is not w and lp.dtype == torch.float16
    np.testing.assert_array_equal(w.numpy(), ws[0])
    out = torch.empty(9, 5, dtype=torch.float16)
    ck.fused_adam_step_multi([w], [g], [m], [v], [1e-3], [0.01], B1, B2,
                             EPS, outs=[out])
    for a, b in ((lp, out), (nw, w), (nm, m), (nv, v)):
        assert torch.equal(a, b)


# --------------------------------------------------------- launch table
def _table_tensors(shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.randn(s, generator=g) for s in shapes]
    return (ws, [torch.zeros_like(w) for w in ws],
            [torch.zeros_like(w) for w in ws],
            [torch.randn(w.shape, generator=g).bfloat16() for w in ws])


def test_table_first_blocks_are_prefix_sums():
    """Each entry's first block is the sum of the chunk counts before it,
    the total is the grid, and the pointer and count columns hold each
    tensor's, for K3's record and K1's."""
    shapes = [(3,), (8192,), (8193,), (40, 1000), (1,)]
    ws, ms, vs, gs = _table_tensors(shapes)
    outs = [None, ws[1].bfloat16(), None, ws[3].half(), None]
    for layout, cols in ((ck.ADAM_LAYOUT, (ws, ms, vs, outs)),
                         (ck.SGD_LAYOUT, (ws, ms, outs))):
        host, blocks = ck.LaunchTable().write(layout, cols, gs,
                                              [1e-3] * 5, [0.0] * 5)
        chunks = [-(-int(np.prod(s)) // layout.chunk) for s in shapes]
        assert chunks == [1, 1, 2, 5, 1]
        np.testing.assert_array_equal(host["block0"],
                                      np.cumsum([0] + chunks[:-1]))
        assert blocks == sum(chunks) == 10
        np.testing.assert_array_equal(host["n"],
                                      [int(np.prod(s)) for s in shapes])
        for name, col in zip(layout.columns, cols):
            np.testing.assert_array_equal(
                host[name], [t.data_ptr() if t is not None else 0
                             for t in col])
        assert layout.record.itemsize == 64


def test_table_rebuilds_when_a_tensor_is_reallocated():
    """The in-place tensors' columns are written once and kept across
    launches; a reallocated m, a new cast tensor or the other kernel's
    launch rebuilds the table, and new grads alone do not."""
    ws, ms, vs, gs = _table_tensors([(64,), (7, 9)])
    outs = [ws[0].bfloat16(), None]
    table = ck.LaunchTable()
    cols = (ws, ms, vs, outs)
    table.write(ck.ADAM_LAYOUT, cols, gs, [1e-3] * 2, [0.0] * 2)
    table.write(ck.ADAM_LAYOUT, cols, [g.clone() for g in gs], [1e-3] * 2,
                [0.0] * 2)
    assert table.rebuilds == 1
    ms[1] = torch.zeros(7, 9)
    host, _ = table.write(ck.ADAM_LAYOUT, cols, gs, [1e-3] * 2, [0.0] * 2)
    assert table.rebuilds == 2 and host["m"][1] == ms[1].data_ptr()
    outs[1] = ws[1].half()
    host, _ = table.write(ck.ADAM_LAYOUT, cols, gs, [1e-3] * 2, [0.0] * 2)
    assert table.rebuilds == 3 and host["out"][1] == outs[1].data_ptr()
    assert host["flags"][1] & 32      # the f16 cast's bit
    host, _ = table.write(ck.SGD_LAYOUT, (ws, ms, outs), gs, [0.1] * 2,
                          [0.0] * 2)
    assert table.rebuilds == 4 and host.dtype == ck.SGD_LAYOUT.record


def test_table_rewrites_grad_lr_wd_and_flags_each_launch():
    """The grad pointer, lr, wd and flags are rewritten at every launch:
    the grad's dtype bit and the 4-lane alignment follow the grad given,
    a misaligned in-place tensor keeps its entry off the vector path."""
    ws, ms, vs, gs = _table_tensors([(64,), (16,)])
    outs = [ws[0].bfloat16(), None]
    table = ck.LaunchTable()
    cols = (ws, ms, vs, outs)
    host, _ = table.write(ck.ADAM_LAYOUT, cols, gs, [1e-3, 2e-3],
                          [0.01, 0.0])
    assert list(host["flags"]) == [1 | 2 | 8, 1 | 8]
    np.testing.assert_array_equal(host["lr"], np.float32([1e-3, 2e-3]))
    np.testing.assert_array_equal(host["wd"], np.float32([0.01, 0.0]))
    g16 = [g.half() for g in gs]
    g16[1] = torch.zeros(17, dtype=torch.float16)[1:]   # 2 bytes off
    host, _ = table.write(ck.ADAM_LAYOUT, cols, g16, [3e-3, 4e-3],
                          [0.0, 0.5])
    assert table.rebuilds == 1
    assert list(host["flags"]) == [16 | 2 | 8, 16]
    assert list(host["g"]) == [g.data_ptr() for g in g16]
    np.testing.assert_array_equal(host["lr"], np.float32([3e-3, 4e-3]))
    np.testing.assert_array_equal(host["wd"], np.float32([0.0, 0.5]))
    vs[0] = torch.zeros(65)[1:]                          # 4 bytes off
    host, _ = table.write(ck.ADAM_LAYOUT, cols, gs, [1e-3] * 2, [0.0] * 2)
    assert list(host["flags"]) == [1 | 2, 1 | 8]


# --------------------------------------------------------------- checks
def test_a_tensor_the_kernel_cannot_take_is_named():
    """Off the CPU, a list holding a tensor the kernel cannot take raises
    ``KernelUnsupportedError`` naming its index and why; nothing falls
    back to the plain version."""
    w = _meta(3, 5)

    def call(ws, gs, ms, vs, outs=None):
        ck.fused_adam_step_multi(ws, gs, ms, vs, [1e-3] * len(ws),
                                 [0.0] * len(ws), B1, B2, EPS, outs=outs)
    with pytest.raises(mt.KernelUnsupportedError,
                       match="tensor 2 of 3: master/m/v must be f32"):
        call([w, w, w.half()], [w] * 3, [w] * 3, [w] * 3)
    with pytest.raises(mt.KernelUnsupportedError,
                       match="tensor 1 of 2: grad must be"):
        call([w, w], [w, w.double()], [w] * 2, [w] * 2)
    with pytest.raises(mt.KernelUnsupportedError,
                       match="tensor 0 of 1: a cast must be bf16 or f16"):
        call([w], [w], [w], [w], outs=[_meta(3, 5)])
    with pytest.raises(mt.KernelUnsupportedError,
                       match="tensor 1 of 2: shapes differ"):
        call([w, w], [w, w[:2]], [w] * 2, [w] * 2)
    # every tensor passes the checks: the next refusal is the device
    with pytest.raises(mt.KernelUnsupportedError, match="tensor 0 of 2.*CUDA"):
        call([w, w], [w.bfloat16(), w.half()], [w] * 2, [w] * 2,
             outs=[w.bfloat16(), None])
    with pytest.raises(ValueError, match="one grad"):
        ck.fused_adam_step_multi([w], [], [w], [w], [1e-3], [0.0], B1, B2,
                                 EPS)


# ----------------------------------------------- lists against per index
class _Tier:
    def __init__(self, on):
        self.on = on

    def __enter__(self):
        jmx.config.set("kernels.enabled", self.on)
        mt.config.set("kernels.enabled", self.on)

    def __exit__(self, *exc):
        jmx.config.unset("kernels.enabled")
        mt.config.unset("kernels.enabled")


#: bf16 and f16 weights over f32 masters, and an f32 weight (no master:
#: ``update``), with lr/wd multipliers
_MP_SHAPES = [(33, 17), (64,), (5, 7), (12,)]
_MP_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.bfloat16]


def _optimizer(name):
    kw = {"wd": 0.01, "multi_precision": True,
          "param_idx2name": {0: "a_weight", 1: "b_weight", 2: "c_weight",
                             3: "d_bias"}}
    if name == "sgd":
        kw.update(learning_rate=0.1, momentum=0.9)
    o = mt.optimizer.create(name, **kw)
    o.set_lr_mult({"b_weight": 0.5})
    return o


def _mp_run(name, tier, mode, steps=3):
    """``steps`` updates of the _MP_SHAPES weights through an Updater,
    called per index or with lists (``mode``); the weights, the state
    tensors and the ``kernels.fused_step`` count."""
    rng = np.random.RandomState(3)
    w0 = [(rng.randn(*s) * 0.05).astype(np.float32) for s in _MP_SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in _MP_SHAPES]
             for _ in range(steps)]
    upd = mt.optimizer.get_updater(_optimizer(name))
    ws = [mt.nd.array(w, ctx=mt.cpu()).astype(str(dt)[6:])
          for w, dt in zip(w0, _MP_DTYPES)]
    tt.reset()
    with _Tier(tier):
        for gstep in grads:
            gs = [mt.nd.array(g, ctx=mt.cpu()).astype(str(dt)[6:])
                  for g, dt in zip(gstep, _MP_DTYPES)]
            if mode == "lists":
                upd(list(range(len(ws))), gs, ws)
            else:
                for i, (g, w) in enumerate(zip(gs, ws)):
                    upd(i, g, w)
    flat = [w._data for w in ws]
    for i in range(len(ws)):
        s = upd.states[i]
        stack = [s]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                flat.append(x)
            elif isinstance(x, (tuple, list)):
                stack.extend(x)
    return flat, tt.snapshot()["counters"].get("kernels.fused_step", 0)


@pytest.mark.parametrize("tier", [True, False], ids=["tier-on", "tier-off"])
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_updater_lists_match_per_index_calls(name, tier):
    """An ``Updater`` called with lists of indices, grads and weights (one
    ``update_multi_precision`` call, one launch on the card) gives the
    bits of one call per index: the low-precision weights, the masters
    and the states, and one ``kernels.fused_step`` per tensor updated
    through its master."""
    per, per_count = _mp_run(name, tier, "per-index")
    lists, list_count = _mp_run(name, tier, "lists")
    assert len(per) == len(lists)
    for a, b in zip(per, lists):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert per_count == list_count == (3 * 3 if tier else 0)


def test_update_multi_precision_lists_bitwise_with_reference():
    """``Adam.update_multi_precision`` over lists (tier on: one
    ``step_fused_multi`` call a step) against the reference's per-index
    calls (its Pallas kernel in interpret mode): the bf16 weights, masters,
    m and v bit for bit over 3 steps, per-tensor lr multipliers and step
    counts included (index 1 starts one step later)."""
    rng = np.random.RandomState(5)
    shapes = [(33, 17), (40,), (3, 5, 7)]
    w0 = [(rng.randn(*s) * 0.02).astype(np.float32) for s in shapes]
    kw = {"learning_rate": 1e-3, "wd": 0.01, "multi_precision": True,
          "param_idx2name": {0: "a_weight", 1: "b_weight", 2: "c_weight"}}
    jo = jmx.optimizer.Adam(**kw)
    to = mt.optimizer.create("adam", **kw)
    for o in (jo, to):
        o.set_lr_mult({"c_weight": 0.25})
    jw = [jmx.nd.array(w, dtype="bfloat16") for w in w0]
    tw = [torch.from_numpy(w).to(torch.bfloat16) for w in w0]
    js = [jo.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    with _Tier(True):
        for step in range(3):
            gs = [rng.randn(*s).astype(np.float32) for s in shapes]
            idx = [0, 2] if step == 0 else [0, 1, 2]
            for i in idx:
                jo.update_multi_precision(
                    i, jw[i], jmx.nd.array(gs[i], dtype="bfloat16"), js[i])
            to.update_multi_precision(
                idx, [tw[i] for i in idx],
                [torch.from_numpy(gs[i]).to(torch.bfloat16) for i in idx],
                [ts[i] for i in idx])
    assert to._index_update_count == {0: 3, 1: 2, 2: 3}
    for i in range(3):
        pairs = [(jw[i]._data, tw[i]), (js[i][0]._data, ts[i][0]),
                 (js[i][1][0]._data, ts[i][1][0]),
                 (js[i][1][1]._data, ts[i][1][1])]
        for want, got in pairs:
            want = np.asarray(jnp.asarray(want, jnp.float32))
            np.testing.assert_array_equal(_bits(got.float().numpy()),
                                          _bits(want), err_msg=str(i))


def test_step_fused_multi_takes_per_tensor_step_counts():
    """``Adam.step_fused_multi`` with one step count per tensor equals the
    per-tensor ``step_fused`` calls bit for bit."""
    ws, gs, ms, vs = _lists(SHAPES, seed=6)
    o = mt.optimizer.Adam(learning_rate=2e-3)
    ts, lrs, wds = [1, 5, 1000], [2e-3, 1e-3, 2e-3], [0.0, 0.01, 0.0]
    a = [[torch.from_numpy(x.copy()) for x in xs] for xs in (ws, ms, vs)]
    b = [[torch.from_numpy(x.copy()) for x in xs] for xs in (ws, ms, vs)]
    g = [torch.from_numpy(x) for x in gs]
    o.step_fused_multi(a[0], g, list(zip(a[1], a[2])), lrs, wds, ts)
    for i in range(len(SHAPES)):
        o.step_fused(b[0][i], g[i], (b[1][i], b[2][i]), lrs[i], wds[i],
                     ts[i], out_dtype=torch.float32,
                     out=(b[0][i], b[0][i], (b[1][i], b[2][i])))
    for xa, xb in zip(sum(a, []), sum(b, [])):
        assert torch.equal(xa, xb)


# ---------------------------------------------------- SPMDTrainer, Adam
LAYERS, CHANNELS = [1, 1, 1, 1], [8, 16, 24, 32, 48]
ADAM = {"learning_rate": 1e-3, "wd": 1e-4}
STEPS = 3
# f32 on both sides; the packages' convolutions and BatchNorm reductions
# sum in different orders, so the gradients differ in their last bits.
# Measured with 1, 2, 4 and 8 CPU threads:
# * the losses: at most 1.5e-6 of the reference's over the 3 steps;
#   bounded at 1e-5;
# * the masters: an Adam step moves a weight by about lr whatever the
#   gradient's size, so where a gradient is rounding noise (a conv bias
#   that feeds a BatchNorm has an exact gradient of 0) the two packages
#   move it by up to lr in unrelated directions: after 3 steps
#   |port - reference| <= 2 x 3 x lr = 6e-3 for any element (measured
#   3.3e-3).  Every other master (no conv bias) is held within
#   ADAM_MASTER_RTOL of its tensor's largest |value|: measured at most
#   2.4e-5, the BatchNorm betas, which start at 0 and are three steps
#   (~3 lr) in size; bounded at 1e-4.
ADAM_LOSS_RTOL = 1e-5
ADAM_MASTER_RTOL = 1e-4


def test_spmd_trainer_adam_tracks_reference():
    """The port's ``SPMDTrainer`` under Adam (kernel tier on: one
    ``step_fused_multi`` call a step, the plain K3 here; the reference's
    Pallas kernel in interpret mode) against the reference's from the
    same weights over STEPS steps on one batch: the losses, and the
    masters within the bounds stated above."""
    mt.random.seed(0)
    tnet = ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=10,
                    thumbnail=True)
    tnet.initialize(mt.init.Xavier(), ctx=mt.cpu())
    jnet = JResNet(JBlock, LAYERS, CHANNELS, classes=10, thumbnail=True)
    jnet.initialize(jmx.init.Zero())
    x = np.zeros((1, 3, 32, 32), np.float32)
    tnet(mt.nd.array(x, ctx=mt.cpu()))
    jnet(jmx.nd.array(x))
    jp = jnet.collect_params()
    for name, val in gluon_params_to_reference(tnet, jnet.prefix).items():
        jp[name].set_data(jmx.nd.array(val))
    rng = np.random.RandomState(1)
    data = rng.uniform(size=(4, 3, 32, 32)).astype(np.float32)
    label = rng.randint(0, 10, (4,)).astype(np.float32)
    tt.reset()
    with _Tier(True):
        tr = SPMDTrainer(tnet, SoftmaxCrossEntropyLoss(), "adam", dict(ADAM),
                         mesh=make_mesh({"dp": -1}, [mt.cpu()]))
        jr = JTrainer(jnet, JLoss(), "adam", dict(ADAM),
                      mesh=jmake_mesh({"dp": -1}, jax.devices()[:1]))
        losses = np.asarray([(float(tr.step(data, label)),
                              float(jr.step(data, label)))
                             for _ in range(STEPS)])
    assert tt.snapshot()["counters"].get("kernels.fused_step", 0) == 1
    rel = np.abs(losses[:, 0] - losses[:, 1]) / np.abs(losses[:, 1])
    assert rel.max() <= ADAM_LOSS_RTOL, (rel, losses)
    assert losses[-1, 0] < losses[0, 0], losses
    tpre, jpre = tnet.prefix, jnet.prefix
    worst_weight, worst_any = 0.0, 0.0
    for n in jr.fn.trainable:
        want = np.asarray(jr.params[n], np.float64)
        got = tr.params[tpre + n[len(jpre):]].detach().double().numpy()
        diff = float(np.abs(got - want).max())
        worst_any = max(worst_any, diff)
        if not ("conv" in n and n.endswith("_bias")):
            worst_weight = max(worst_weight,
                               diff / float(np.abs(want).max()))
    assert worst_weight <= ADAM_MASTER_RTOL, worst_weight
    assert worst_any <= 2 * STEPS * ADAM["learning_rate"], worst_any
