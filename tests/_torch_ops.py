"""Shared machinery of the op-library parity tests
(``test_torch_op_sweep*.py``): run one op through the port on the CPU and
through the reference on the same numpy inputs, forward and, for a
differentiable op, the input gradients under each package's autograd with
the same seeded head gradient, and compare."""
import os
import sys

import numpy as np

import mxnet_tpu as ref
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import _REGISTRY as REF_OPS
from mxnet_tpu.ops.registry import apply_op as ref_apply
from mxnet_tpu_torch.ops.registry import apply_op as port_apply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 2.0 ** -7

# Ops held looser than RTOL/ATOL, each with its reason, as (rtol, atol):
# none needs it (the factorisations and CTC's recursion meet RTOL/ATOL
# at these sizes).
LOOSER = {}

# Ops whose forward is exact (data movement, comparisons, rounding,
# selection, creation): compared bit for bit.  The card phase's list,
# less linspace: XLA may fuse its two products into one rounding.
EXACT = chip_smoke.EXACT_OPS - {"_linspace"}

RANDOM = chip_smoke.RANDOM_CASE_OPS


def slice_ops(*modules):
    """The reference's canonical op names registered by ``modules``."""
    return sorted({op.name for op in REF_OPS.values()
                   if op.fn.__module__.rsplit(".", 1)[-1] in modules})


def module_of(name):
    return REF_OPS[name].fn.__module__.rsplit(".", 1)[-1]


def _outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _asnumpy(x):
    return x.asnumpy()


def _is_float(a):
    return a.dtype.kind == "f" or a.dtype.name == "bfloat16"


def run_port(name, arrays, attrs, index_inputs=(), dtypes=None, seed=0):
    """The port on the CPU: (outputs, input gradients or None, heads);
    ``dtypes`` gives each input's dtype (None: the array's own)."""
    dtypes = dtypes or [None] * len(arrays)
    with mt.cpu():
        nds = [mt.nd.array(a, dtype=dt) for a, dt in zip(arrays, dtypes)]
        op = mt.ops.registry.get(name)
        diff = [i for i, a in enumerate(arrays)
                if i not in index_inputs and _is_float(a)]
        if not (op.differentiable and diff) or name in RANDOM:
            return [_asnumpy(o) for o in _outs(port_apply(op, *nds, **attrs))], \
                None, None
        for i in diff:
            nds[i].attach_grad()
        with mt.autograd.record():
            outs = _outs(port_apply(op, *nds, **attrs))
        rng = np.random.RandomState(seed + 1)
        heads = [np.asarray(rng.randn(*o.shape) * 0.5, np.float32)
                 for o in outs]
        if name == "linalg_syevd":
            # the eigenvalues' gradient only: an eigenvector's sign is
            # the solver's, so is the gradient through it
            heads[0] = np.zeros_like(heads[0])
        mt.autograd.backward(outs, [mt.nd.array(h, dtype=o.dtype)
                                    for h, o in zip(heads, outs)])
        return [_asnumpy(o) for o in outs], \
            {i: _asnumpy(nds[i].grad) for i in diff}, heads


def run_ref(name, arrays, attrs, index_inputs=(), dtypes=None, heads=None):
    """The reference on the same inputs and head gradients."""
    dtypes = dtypes or [None] * len(arrays)
    nds = [ref.nd.array(a, dtype=dt) for a, dt in zip(arrays, dtypes)]
    if heads is None:
        return [_asnumpy(o) for o in _outs(ref_apply(name, *nds, **attrs))], None
    diff = [i for i, a in enumerate(arrays)
            if i not in index_inputs and _is_float(a)]
    for i in diff:
        nds[i].attach_grad()
    with ref.autograd.record():
        outs = _outs(ref_apply(name, *nds, **attrs))
    ref.autograd.backward(outs, [ref.nd.array(h, dtype=o.dtype)
                                 for h, o in zip(heads, outs)])
    return [_asnumpy(o) for o in outs], {i: _asnumpy(nds[i].grad) for i in diff}


def assert_same(name, what, got, want, exact=False, tol=None):
    """``got`` (port) against ``want`` (reference): the same shape and
    dtype, equal bits where ``exact`` or integral, else within ``tol``."""
    assert got.shape == want.shape, (name, what, got.shape, want.shape)
    assert got.dtype == want.dtype, (name, what, got.dtype, want.dtype)
    g = got.astype(np.float64)
    w = want.astype(np.float64)
    if exact or not _is_float(got):
        np.testing.assert_array_equal(g, w, err_msg="%s %s" % (name, what))
        return
    rtol, atol = tol or LOOSER.get(name, (RTOL, ATOL))
    if got.dtype.name == "bfloat16":
        # one bf16 ulp: XLA may keep a bf16 chain in f32 between ops
        rtol, atol = max(rtol, BF16_RTOL), max(atol, BF16_RTOL * float(
            np.abs(w).max(initial=0.0)))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                               err_msg="%s %s" % (name, what))


def _syevd_view(outs):
    """``linalg_syevd``'s outputs compared through the reconstruction
    ``U^T diag(lam) U`` and the eigenvalues (a row's sign is free)."""
    u, lam = outs
    return [np.swapaxes(u, -1, -2) @ (lam[..., :, None] * u), lam]


def check_op(name, arrays, attrs, index_inputs=(), dtypes=None, seed=0):
    """One op, port against reference, forward and gradients."""
    outs, grads, heads = run_port(name, arrays, attrs, index_inputs, dtypes,
                                  seed)
    routs, rgrads = run_ref(name, arrays, attrs, index_inputs, dtypes,
                            heads)
    assert len(outs) == len(routs), (name, len(outs), len(routs))
    if name in RANDOM:
        for o, r in zip(outs, routs):
            assert o.shape == r.shape and o.dtype == r.dtype, (
                name, o.shape, o.dtype, r.shape, r.dtype)
        return
    if name == "linalg_syevd":
        outs, routs = _syevd_view(outs), _syevd_view(routs)
    exact = name in EXACT
    for k, (o, r) in enumerate(zip(outs, routs)):
        assert_same(name, "output %d" % k, o, r, exact=exact)
    if grads is not None:
        assert sorted(grads) == sorted(rgrads), name
        for i in grads:
            assert_same(name, "gradient of input %d" % i, grads[i],
                        rgrads[i])


def spec_inputs(sweep, name):
    """``sweep.SPECS[name]``'s inputs and attrs, its generator reseeded
    for this op and then put back as it was."""
    s = sweep.SPECS[name]
    state = sweep.RNG.get_state()
    sweep.RNG.seed(sum(map(ord, name)) % 2 ** 31)
    try:
        b = s["inputs"]
        return (b() if callable(b) else list(b)), s["attrs"]
    finally:
        sweep.RNG.set_state(state)


def chip_cases(modules):
    """chip_smoke.OP_CASES of ``modules``: {case name: (op, arrays,
    attrs, dtypes)} with inputs built as the card phase builds them."""
    out = {}
    for i, (case, inputs, attrs) in enumerate(chip_smoke.OP_CASES):
        op = case.partition("@")[0]
        if module_of(op) in modules:
            arrays, dtypes = chip_smoke.case_inputs(np, i)
            out[case] = (op, arrays, attrs, dtypes)
    return out
