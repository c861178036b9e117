"""``mxnet_tpu_torch.runtime`` and its knobs held against
``mxnet_tpu.runtime`` on the CPU: the same knob names, defaults and
refusals, the same feature names, the same tuning grid; ``scan_stack``
over stacked weights with each remat policy.
"""
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import runtime as jrt

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import runtime as rt


@pytest.mark.parametrize("name,env,default", [
    ("runtime.stack_mode", "MXNET_TPU_STACK_MODE", "scan"),
    ("runtime.remat", "MXNET_TPU_REMAT", ""),
])
def test_knobs_match_the_reference(name, env, default):
    for cfg in (mt.config, jmx.config):
        knob = cfg._KNOBS[name]
        assert (knob.env, knob.type, knob.default) == (env, str, default)
        assert cfg.get(name) == default


@pytest.mark.parametrize("name,good,bad", [
    ("runtime.stack_mode", ["scan", "unroll"], ["loop", "", "jit"]),
    ("runtime.remat", ["", "dots", "full"], ["all", "checkpoint"]),
])
def test_knob_validation_matches_the_reference(name, good, bad):
    """Both packages take the same values and refuse the same others
    with ValueError; a refused value drops the override, so the knob
    reads its default again."""
    for cfg in (mt.config, jmx.config):
        try:
            for value in good:
                cfg.set(name, value)
                assert cfg.get(name) == value
            for value in bad:
                cfg.set(name, good[-1])
                with pytest.raises(ValueError, match=name):
                    cfg.set(name, value)
                assert cfg.get(name) == cfg._KNOBS[name].default
        finally:
            cfg.unset(name)


def test_stack_tuning_reads_the_knobs_and_refuses_a_bad_env(monkeypatch):
    assert rt.stack_tuning() == ("scan", "")
    mt.config.set("runtime.remat", "dots")
    try:
        assert rt.stack_tuning() == ("scan", "dots")
    finally:
        mt.config.unset("runtime.remat")
    monkeypatch.setenv("MXNET_TPU_STACK_MODE", "loop")
    with pytest.raises(ValueError, match="stack_mode"):
        rt.stack_tuning()


def test_stack_candidates_are_the_reference_grid():
    assert rt.stack_candidates() == jrt.stack_candidates()


def test_feature_names_match_the_reference():
    ours, theirs = rt.Features(), jrt.Features()
    assert set(ours) == set(theirs)
    assert [f.name for f in rt.feature_list()] == list(ours)
    # what this machine has: no CUDA device in the CPU tests
    cuda = torch.cuda.is_available()
    assert rt.is_enabled("gpu") == cuda and rt.is_enabled("CUDA") == cuda
    assert rt.is_enabled("CPU") and not rt.is_enabled("PALLAS")
    assert rt.is_enabled("CUDNN") == torch.backends.cudnn.is_available()
    assert rt.is_enabled("NATIVE_IO") is False
    with pytest.raises(RuntimeError, match="does not exist"):
        rt.is_enabled("NO_SUCH_FEATURE")
    assert "CPU" in repr(ours)


def test_checkpoint_policy_names():
    assert rt.checkpoint_policy("") is None
    assert callable(rt.checkpoint_policy("dots"))
    assert callable(rt.checkpoint_policy("full"))
    with pytest.raises(ValueError, match="remat"):
        rt.checkpoint_policy("everything")


def _stack(seed=0, L=3, D=8):
    g = torch.Generator().manual_seed(seed)
    xs = {"w": torch.randn(L, D, D, generator=g),
          "b": torch.randn(L, D, generator=g)}
    x = torch.randn(4, D, generator=g)
    return x, xs


def _body(carry, lp):
    h = torch.tanh(carry @ lp["w"] + lp["b"])
    return h, h.sum(dim=-1)


@pytest.mark.parametrize("remat", ["", "dots", "full"])
@pytest.mark.parametrize("mode", ["scan", "unroll"])
def test_scan_stack_is_the_layer_loop_under_every_policy(mode, remat):
    """``scan_stack`` gives the plain loop's carry, stacked ys and
    gradients bitwise, whatever the two knobs say."""
    x, xs = _stack()
    want_ws = {k: v.clone().requires_grad_(True) for k, v in xs.items()}
    carry, ys = x, []
    for i in range(3):
        carry, y = _body(carry, {k: v[i] for k, v in want_ws.items()})
        ys.append(y)
    want_ys = torch.stack(ys)
    (carry.sum() + want_ys.sum()).backward()
    ws = {k: v.clone().requires_grad_(True) for k, v in xs.items()}
    mt.config.set("runtime.stack_mode", mode)
    mt.config.set("runtime.remat", remat)
    try:
        got, got_ys = rt.scan_stack(_body, x, ws)
        (got.sum() + got_ys.sum()).backward()
    finally:
        mt.config.unset("runtime.stack_mode")
        mt.config.unset("runtime.remat")
    assert torch.equal(got, carry) and torch.equal(got_ys, want_ys)
    for k in ws:
        assert torch.equal(ws[k].grad, want_ws[k].grad), k


def test_scan_stack_without_ys_and_without_autograd():
    x, xs = _stack()
    out, ys = rt.scan_stack(lambda c, lp: (_body(c, lp)[0], None), x, xs)
    assert ys is None and out.shape == x.shape
    mt.config.set("runtime.remat", "full")
    try:
        with torch.no_grad():
            again, _ = rt.scan_stack(lambda c, lp: (_body(c, lp)[0], None),
                                     x, xs)
    finally:
        mt.config.unset("runtime.remat")
    assert torch.equal(again, out)


def test_dots_policy_saves_the_products_and_recomputes_the_rest():
    """Under 'dots' the backward recomputes the layer's elementwise ops
    but not its matrix products: counted on the aten ops that run during
    ``backward()``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    def run(remat):
        x, xs = _stack()
        ws = {k: v.clone().requires_grad_(True) for k, v in xs.items()}
        mt.config.set("runtime.remat", remat)
        try:
            out, _ = rt.scan_stack(lambda c, lp: (_body(c, lp)[0], None),
                                   x, ws)
        finally:
            mt.config.unset("runtime.remat")
        with Count() as c:
            out.sum().backward()
        return c.ops

    mm = torch.ops.aten.mm.default
    tanh = torch.ops.aten.tanh.default
    none, dots, full = run(""), run("dots"), run("full")
    assert tanh not in none
    assert tanh in dots and tanh in full
    # 'full' recomputes each layer's product once more than 'dots'
    assert full.count(mm) == dots.count(mm) + 3
    assert dots.count(mm) == none.count(mm)
