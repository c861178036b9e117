"""The port's optimizers held against the reference's, on the CPU.

Every registered optimizer takes 3 steps of the same seeded numpy grads
on the same numpy weights (three small tensors, one of them 1-D)
through both packages' ``Updater`` (the route of ``gluon.Trainer`` and
``KVStore``), and through both packages' symbolic Module (the fused step
where the optimizer may run fused).

Bounds:

* ``Updater``: bitwise for every optimizer whose reference step is a
  chain of elementwise f32 ops (the port takes a quotient or square root
  correctly rounded, as XLA does).  ``LARS`` and ``GroupAdaGrad`` reduce
  (a norm, a row mean), and the two libraries sum in other orders: they
  are held at ``rtol=1e-6`` (``REDUCING``).  ``SGLD`` is held bitwise on
  its deterministic part with the noise replaced by zeros in both
  packages, and its noise by its moments (the RNG streams differ).
* Module: at the reference's own bound between its jitted and eager
  Module routes (``rtol=1e-4, atol=1e-5``, ``tests/test_module.py``):
  the jitted step contracts and reorders f32 ops and takes its step
  count as a traced f32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import config as jconfig

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.optimizer import optimizer as popt
from test_torch_module import _train

SHAPES = ((4, 5), (7,), (3, 2, 2))
STEPS = 3

# (registered name, constructor arguments); wd, rescale_grad and clipping
# vary across the cases
CASES = [
    ("signum", {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 0.01,
                "wd": 1e-3}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-3}),
    ("signsgd", {"learning_rate": 0.01}),
    ("ftml", {"learning_rate": 0.05, "wd": 1e-3}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.01,
              "wd": 1e-3}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9, "batch_scale": 4,
               "warmup_epochs": 1, "updates_per_epoch": 4}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("dcasgd", {"learning_rate": 0.1}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("sgld", {"learning_rate": 0.01, "wd": 1e-3}),
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-3,
                 "clip_gradient": 0.5}),
    ("rmsprop", {"learning_rate": 0.01, "rescale_grad": 0.5}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_weights": 0.9, "wd": 1e-3}),
    ("adadelta", {"wd": 1e-3}),
    ("ftrl", {"learning_rate": 0.1, "wd": 1e-3}),
    ("adamax", {"wd": 1e-3}),
    ("nadam", {"wd": 1e-3}),
    ("test", {"rescale_grad": 0.5}),
    ("groupadagrad", {"learning_rate": 0.1}),
]
IDS = ["%s-%d" % (n, i) for i, (n, _) in enumerate(CASES)]
REDUCING = {"lars", "groupadagrad"}
NEW = {"signum", "signsgd", "ftml", "lars", "lbsgd", "dcasgd", "nag",
       "sgld", "ccsgd", "adagrad", "rmsprop", "adadelta", "ftrl", "adamax",
       "nadam", "test", "groupadagrad"}


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(STEPS)]
    return ws, gs


def _run(lib, name, kwargs):
    ws, gs = _inputs()
    upd = lib.optimizer.get_updater(lib.optimizer.create(name, **kwargs))
    arrs = [lib.nd.array(w) for w in ws]
    for step in gs:
        for i, (w, g) in enumerate(zip(arrs, step)):
            upd(i, lib.nd.array(g), w)
    return [a.asnumpy() for a in arrs], upd


def _zero_sgld_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(popt.SGLD, "_noise",
                        lambda self, w: torch.zeros_like(w))


def _builtin(registry, module):
    """The registry's names of the package's own optimizers (other test
    files register theirs at run time)."""
    return {n for n, k in registry.items() if k.__module__ == module}


def test_every_reference_optimizer_is_registered():
    assert _builtin(jmx.optimizer.Optimizer.opt_registry,
                    "mxnet_tpu.optimizer.optimizer") \
        == _builtin(mt.optimizer.Optimizer.opt_registry,
                    "mxnet_tpu_torch.optimizer.optimizer")
    assert {n for n, _ in CASES} == NEW


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_updater_matches_reference(name, kwargs, monkeypatch):
    if name == "sgld":
        _zero_sgld_noise(monkeypatch)
    want, _ = _run(jmx, name, kwargs)
    got, _ = _run(mt, name, kwargs)
    for g, w in zip(got, want):
        if name in REDUCING:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.view(np.int32))


def test_sgld_noise_moments():
    """SGLD's update less its deterministic part is N(0, lr): mean and
    std over 10^5 draws within 5 standard errors."""
    lr = 0.04
    opt = mt.optimizer.create("sgld", learning_rate=lr)
    w = torch.zeros(100000)
    g = torch.ones(100000)
    mt.random.seed(3)
    new, _ = opt.step(w, g, None, lr, 0.0, 1)
    noise = (new - (w - lr / 2 * g)).double()
    sd = lr ** 0.5
    se = sd / len(noise) ** 0.5
    assert abs(float(noise.mean())) < 5 * se
    assert abs(float(noise.std()) - sd) < 5 * sd / (2 * len(noise)) ** 0.5


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_module_step_matches_reference(name, kwargs, monkeypatch):
    """3 Module steps of the test MLP (``tests/test_torch_module.py``):
    the fused route where the optimizer may run fused (the eager route
    for LBSGD and Nadam, which keep host state), in both packages.  The
    reference's GroupAdaGrad cannot be traced (its step asserts on the
    traced wd), so it is held against the reference's eager route."""
    if name == "sgld":
        _zero_sgld_noise(monkeypatch)
    kw = dict(kwargs)
    lr = kw.pop("learning_rate", 0.01)
    ref_route = "off" if name == "groupadagrad" else "auto"
    want = _train(jmx, jconfig, ref_route, name, lr=lr, **kw)
    got = _train(mt, tconfig, "auto", name, lr=lr, **kw)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("name,kwargs", CASES[:4] + CASES[10:13],
                         ids=IDS[:4] + IDS[10:13])
def test_trainer_by_name_and_multi_precision(name, kwargs):
    """``gluon.Trainer`` finds each optimizer by name, and a bf16 weight
    updates through its f32 master: the master is the f32 weight's
    update, the weight its cast."""
    ws, gs = _inputs()
    p32 = mt.gluon.Parameter("w32", shape=SHAPES[0])
    p16 = mt.gluon.Parameter("w16", shape=SHAPES[0], dtype="bfloat16")
    for p in (p32, p16):
        p.initialize()
        p.set_data(mt.nd.array(ws[0]).astype(p.dtype))
    # both multi_precision: under it an f32 weight is its own master,
    # which takes the fused kernel's route (ccSGD) as the bf16 master does
    t32 = mt.gluon.Trainer([p32], name, dict(kwargs, multi_precision=True))
    t16 = mt.gluon.Trainer([p16], name, dict(kwargs,
                                             multi_precision=True))
    w16 = torch.from_numpy(ws[0]).bfloat16().float().numpy()
    p32.set_data(mt.nd.array(w16))
    for step in gs:
        g = torch.from_numpy(step[0]).bfloat16().float()
        for p in (p32, p16):
            p.grad()._data.copy_(g.to(p.grad()._data.dtype))
        t32.step(1)
        t16.step(1)
    master = t16._updaters[0].states[0][0]
    np.testing.assert_array_equal(master.numpy(), p32.data().asnumpy())
    np.testing.assert_array_equal(
        p16.data()._data.float().numpy(),
        torch.from_numpy(master.numpy()).bfloat16().float().numpy())


def test_group_adagrad_refuses_weight_decay():
    opt = mt.optimizer.create("groupadagrad", wd=0.1)
    with pytest.raises(ValueError, match="Weight decay"):
        opt.update(0, torch.zeros(2, 3), torch.ones(2, 3),
                   opt.create_state(0, torch.zeros(2, 3)))


SPMD_CASES = [("nag", {"learning_rate": 0.1, "momentum": 0.9}),
              ("rmsprop", {"learning_rate": 0.01, "centered": True}),
              ("adadelta", {"wd": 1e-3}),
              ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9})]


@pytest.mark.parametrize("name,kwargs", SPMD_CASES,
                         ids=[c[0] for c in SPMD_CASES])
def test_spmd_trainer_step_matches_reference(name, kwargs):
    """2 ``SPMDTrainer`` steps of a small MLP through ``optimizer.step``
    (ccSGD through K1's plain version), against the reference's jitted
    trainer at the Module bound."""
    from test_torch_persistence import _spmd_pair, _spmd_batch
    jtr, ttr = _spmd_pair(name, kwargs)
    for i in range(2):
        jloss = float(jtr.step(*_spmd_batch(i)))
        tloss = float(ttr.step(*(torch.from_numpy(a)
                                 for a in _spmd_batch(i))))
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    jtr.sync()
    ttr.sync()
    jp = {n[len(jtr.block.prefix):]: p.data().asnumpy()
          for n, p in jtr.block.collect_params().items()}
    for n, p in ttr.block.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jp[n[len(ttr.block.prefix):]],
                                   rtol=1e-4, atol=1e-5, err_msg=n)
