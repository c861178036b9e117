"""The port's NDArray autograd tape held against the reference's, on the
CPU: each case of ``tests/test_autograd.py`` runs on both packages from
the same numpy inputs, and every gradient and output it returns must
agree (f32, ``rtol=1e-6, atol=1e-6``: both sides run the same f32 ops on
the same values; PyTorch's and XLA's CPU ``exp``/``sin``/``log`` may
differ in the last ulp).  The port's values are also held to the
reference test's expected numbers where it states them.  Last, the tape
must leave ``SPMDTrainer``'s own ``torch.autograd`` path alone.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _tape
from mxnet_tpu_torch import autograd as tag

RTOL = ATOL = 1e-6

PKGS = {"port": (mt, tag), "reference": (jmx, jag)}


def _run(pkg, case):
    mx, ag = PKGS[pkg]
    if pkg == "port":
        with mt.cpu():
            return case(mx, ag)
    return case(mx, ag)


def _np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


# ------------------------------------------------------------------ cases
def simple_grad(mx, ag):
    x = mx.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with ag.record():
        y = (x * x).sum()
    y.backward()
    return {"grad": x.grad, "y": y}


def grad_accumulate_add(mx, ag):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with ag.record():
            y = (x * 3).sum()
        y.backward()
    return {"grad": x.grad}


def multi_use(mx, ag):
    x = mx.nd.array([2.0])
    x.attach_grad()
    with ag.record():
        y = x * x + x
    y.backward()
    return {"grad": x.grad}


def chain_rule_through_ops(mx, ag):
    x = mx.nd.array([0.5, 1.0])
    x.attach_grad()
    with ag.record():
        y = mx.nd.exp(mx.nd.sin(x)).sum()
    y.backward()
    return {"grad": x.grad, "y": y}


def head_grad(mx, ag):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with ag.record():
        y = x * 2
    y.backward(mx.nd.array([1.0, 10.0]))
    return {"grad": x.grad}


def detach_blocks(mx, ag):
    x = mx.nd.array([1.0])
    x.attach_grad()
    with ag.record():
        y = x * 2
        z = y.detach() * x
    z.backward()
    return {"grad": x.grad}


def stop_gradient_op(mx, ag):
    x = mx.nd.array([3.0])
    x.attach_grad()
    with ag.record():
        y = mx.nd.BlockGrad(x * 2) + x
    y.backward()
    return {"grad": x.grad}


def is_recording_training(mx, ag):
    flags = [ag.is_recording()]
    with ag.record():
        flags += [ag.is_recording(), ag.is_training()]
        with ag.pause():
            flags.append(ag.is_recording())
    flags.append(ag.is_recording())
    with ag.train_mode():
        flags.append(ag.is_training())
    with ag.predict_mode():
        flags.append(ag.is_training())
    return {"flags": [float(f) for f in flags]}


def grad_function(mx, ag):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with ag.record():
        y = mx.nd.relu(x * -1 + 1.5)
    y.backward()
    return {"grad": x.grad}


def retain_graph(mx, ag):
    x = mx.nd.array([2.0])
    x.attach_grad()
    with ag.record():
        y = x * x
    y.backward(retain_graph=True)
    g1 = x.grad.asscalar()
    y.backward()
    with ag.record():
        z = x * x
    z.backward()
    with pytest.raises(RuntimeError):
        z.backward()
    return {"g1": [g1], "grad": x.grad}


def autograd_grad_api(mx, ag):
    x = mx.nd.array([3.0])
    x.attach_grad()
    with ag.record():
        y = x * x
    (g,) = ag.grad(y, [x])
    return {"g": g, "grad_untouched": x.grad}


def custom_function(mx, ag):
    class Sigmoid(ag.Function):
        def forward(self, x):
            with ag.pause():
                y = mx.nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = mx.nd.array([0.0, 1.0])
    x.attach_grad()
    f = Sigmoid()
    with ag.record():
        y = f(x)
    y.backward(mx.nd.ones((2,)))
    return {"grad": x.grad, "y": y}


def grad_through_softmax_fc(mx, ag):
    rng = np.random.RandomState(7)
    x = mx.nd.array(rng.rand(4, 8).astype("float32"))
    w = mx.nd.array(rng.rand(3, 8).astype("float32") * 0.1)
    w.attach_grad()
    with ag.record():
        out = mx.nd.softmax(mx.nd.FullyConnected(x, w, None, no_bias=True,
                                                 num_hidden=3))
        loss = -mx.nd.log(out + 1e-8).sum()
    loss.backward()
    return {"grad": w.grad, "loss": loss}


def not_recorded_outside_record(mx, ag):
    """Outside record() nothing is taped: backward on such an output
    raises, and the leaf's grad stays zero."""
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * x
    with pytest.raises(ValueError):
        y.backward()
    return {"grad": x.grad, "y": y}


# the reference test's own expected values
EXPECTED = {
    simple_grad: {"grad": [2, 4, 6]},
    grad_accumulate_add: {"grad": [6, 6]},
    multi_use: {"grad": [5.0]},
    chain_rule_through_ops: {
        "grad": np.cos([0.5, 1.0]) * np.exp(np.sin([0.5, 1.0]))},
    head_grad: {"grad": [2, 20]},
    detach_blocks: {"grad": [2.0]},
    stop_gradient_op: {"grad": [1.0]},
    is_recording_training: {"flags": [0, 1, 1, 0, 0, 1, 0]},
    grad_function: {"grad": [-1.0, 0.0]},
    retain_graph: {"g1": [4.0], "grad": [4.0]},
    autograd_grad_api: {"g": [6.0], "grad_untouched": [0.0]},
    custom_function: {"grad": (1 / (1 + np.exp(-np.array([0.0, 1.0])))) * (
        1 - 1 / (1 + np.exp(-np.array([0.0, 1.0]))))},
    grad_through_softmax_fc: {},
    not_recorded_outside_record: {"grad": [0.0, 0.0]},
}


@pytest.mark.parametrize("case", list(EXPECTED), ids=lambda c: c.__name__)
def test_case_matches_reference(case):
    ours = _run("port", case)
    theirs = _run("reference", case)
    assert set(ours) == set(theirs)
    for key in ours:
        np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for key, want in EXPECTED[case].items():
        np.testing.assert_allclose(_np(ours[key]), want, rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_softmax_fc_grad_is_nonzero():
    g = _np(_run("port", grad_through_softmax_fc)["grad"])
    assert g.shape == (3, 8) and np.abs(g).sum() > 0


def test_create_graph_gives_second_order():
    """``autograd.grad(create_graph=True)``: d/dx of (d/dx x^3) = 6x."""
    with mt.cpu():
        x = mt.nd.array([1.5, -2.0])
        x.attach_grad()
        with tag.record():
            y = (x * x * x).sum()
            (g,) = tag.grad(y, [x], create_graph=True)
            z = g.sum()
        z.backward()
        np.testing.assert_allclose(g.asnumpy(), 3 * np.array([1.5, -2.0])
                                   ** 2, rtol=1e-6)
        np.testing.assert_allclose(x.grad.asnumpy(), [9.0, -12.0],
                                   rtol=1e-6)


def test_grad_req_write_overwrites_and_null_skips():
    with mt.cpu():
        x = mt.nd.array([1.0, 2.0])
        x.attach_grad()
        n = mt.nd.array([3.0, 4.0])
        n.attach_grad(grad_req="null")
        for _ in range(2):
            with tag.record():
                y = (x * n).sum()
            y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), [3.0, 4.0])
        assert n.grad is None


def test_spmd_trainer_path_is_untouched_by_the_tape():
    """The trap: SPMDTrainer's functionalized forward runs with recording
    off on tensors that require grad but are not on the tape; their
    PyTorch history must flow through every op as before."""
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    wrapped = mt.nd.NDArray(w, ctx=mt.cpu())
    with tag.pause():
        y = (mt.nd.exp(wrapped) * wrapped).sum()
    (g,) = torch.autograd.grad(y._data, [w])
    want = np.exp([1.0, 2.0]) * (1 + np.array([1.0, 2.0]))
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)


def test_marked_tensor_pickles_and_is_marked_again():
    """A marked leaf's tensor saves with ``torch.save``; loaded, no NDArray
    owns it, and an array given that tensor is made a leaf again at its
    next recorded use."""
    import io
    with mt.cpu():
        x = mt.nd.array([1.0, 2.0])
        x.attach_grad()
        with tag.record():
            (x * x).sum()
        buf = io.BytesIO()
        torch.save(x._data, buf)
        buf.seek(0)
        x._data = torch.load(buf)
        assert _tape._owner(x._data) is None
        with tag.record():
            y = (x * x).sum()
        y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 4.0])
