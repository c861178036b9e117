"""The port's op library against the reference, op by op: every op of
``ops/tensor``, ``ops/misc`` and ``ops/random_ops`` runs
under ``with mx.cpu():`` on the inputs of the reference's own sweep
(``tests/test_op_sweep.py`` ``SPECS``) and on the small cases of
``chip_smoke.py``'s ``OP_CASES`` (the cases the card runs), and is held
against the reference's ``apply_op`` on the same numpy inputs: forward,
and the input gradients through each package's autograd with the same
head gradient.  Exact ops are compared bit for bit, f32 at rtol 1e-5 /
atol 1e-6 (``_torch_ops.LOOSER`` lists each looser op and why).  The
samplers are held by distribution against the reference's at fixed
seeds.  ``tests/test_torch_op_sweep_nn_optim.py`` does the same for
``ops/nn``, ``ops/optim_ops`` and ``ops/linalg`` (the files split the ops
so that ``--dist loadfile`` spreads them over two workers)."""
import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import apply_op as ref_apply
from mxnet_tpu_torch.ops.registry import apply_op as port_apply

import _torch_ops as T
import test_op_sweep as ref_sweep

MODULES = ("tensor", "misc", "random_ops")
SPEC_OPS = [n for n in T.slice_ops(*MODULES) if n in ref_sweep.SPECS]
CARD = T.chip_cases(MODULES)


def _spec_inputs(name):
    """A SPECS entry's inputs, drawn from the sweep's own generator
    reseeded for this op (its state is put back, so the reference's sweep
    sees the draws it would see alone)."""
    return T.spec_inputs(ref_sweep, name)


def test_every_op_of_these_modules_is_swept():
    ops = set(T.slice_ops(*MODULES)) - {"_copy_to_device"}
    assert ops <= set(SPEC_OPS)
    assert ops | {"_copy_to_device"} == {c.partition("@")[0] for c in CARD}


@pytest.mark.parametrize("name", SPEC_OPS)
def test_op_matches_reference_on_sweep_inputs(name):
    arrays, attrs = _spec_inputs(name)
    T.check_op(name, arrays, attrs,
               T.chip_smoke.INDEX_INPUTS.get(name, ()))


@pytest.mark.parametrize("case", sorted(CARD))
def test_op_matches_reference_on_card_cases(case):
    op, arrays, attrs, dtypes = CARD[case]
    T.check_op(op, arrays, attrs, T.chip_smoke.INDEX_INPUTS.get(op, ()),
               dtypes)


# ------------------------------------------------------------ the samplers
N_DRAWS = 20000

# (op, attrs, input arrays): each sampler at parameters away from its
# edges; the _like twins on a (100, 200) f32 input
SAMPLERS = [
    ("_random_uniform", {"low": -1.0, "high": 3.0}, []),
    ("_random_normal", {"loc": 1.0, "scale": 2.0}, []),
    ("_random_gamma", {"alpha": 2.5, "beta": 0.5}, []),
    ("_random_exponential", {"lam": 2.0}, []),
    ("_random_poisson", {"lam": 4.0}, []),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}, []),
    ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     []),
    ("_random_randint", {"low": -3, "high": 9}, []),
] + [(n + "_like", a, [np.zeros((100, 200), np.float32)]) for n, a in (
    ("_random_uniform", {"low": -1.0, "high": 3.0}),
    ("_random_normal", {"loc": 1.0, "scale": 2.0}),
    ("_random_gamma", {"alpha": 2.5, "beta": 0.5}),
    ("_random_exponential", {"lam": 2.0}),
    ("_random_poisson", {"lam": 4.0}),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}),
    ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5}))]
_PARAMS = {
    "sample_uniform": [[-1.0, 2.0], [0.0, 5.0]],
    "sample_normal": [[1.0, -2.0], [2.0, 0.5]],
    "sample_gamma": [[2.5, 1.0], [0.5, 2.0]],
    "sample_exponential": [[2.0, 0.5]],
    "sample_poisson": [[4.0, 0.5]],
    "sample_negative_binomial": [[3.0, 1.0], [0.4, 0.7]],
    "sample_generalized_negative_binomial": [[2.0, 5.0], [0.5, 0.2]],
}
SAMPLERS += [(n, {"shape": (N_DRAWS // 2,)},
              [np.asarray(p, np.float32) for p in ps])
             for n, ps in _PARAMS.items()]


def _draw(pkg, apply, name, attrs, arrays, seed):
    pkg.random.seed(seed)
    attrs = dict(attrs)
    if not arrays:
        attrs["shape"] = (N_DRAWS,)
    nds = [pkg.nd.array(a) for a in arrays]
    return apply(name, *nds, **attrs).asnumpy()


def _moments(x, axis):
    x = x.astype(np.float64)
    n = x.shape[axis]
    mean = x.mean(axis=axis)
    var = x.var(axis=axis)
    m4 = ((x - np.expand_dims(mean, axis)) ** 4).mean(axis=axis)
    return mean, var, np.sqrt(var / n), np.sqrt(np.maximum(m4 - var ** 2,
                                                           0) / n)


@pytest.mark.parametrize("name,attrs,arrays", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_matches_reference_distribution(name, attrs, arrays):
    """The port's and the reference's draws at a fixed seed each (the two
    streams differ): the same shape and dtype, and means and variances
    (per parameter element for the sample_* ops) within 6 standard errors
    of their difference."""
    with mt.cpu():
        got = _draw(mt, port_apply, name, attrs, arrays, 3)
    want = _draw(ref, ref_apply, name, attrs, arrays, 3)
    assert got.shape == want.shape and got.dtype == want.dtype
    axis = -1 if name.startswith("sample_") else None
    if axis is None:
        got, want, axis = got.reshape(-1), want.reshape(-1), 0
    gm, gv, gsm, gsv = _moments(got, axis)
    wm, wv, wsm, wsv = _moments(want, axis)
    assert np.all(np.abs(gm - wm) <= 6 * np.hypot(gsm, wsm)), (gm, wm)
    assert np.all(np.abs(gv - wv) <= 6 * np.hypot(gsv, wsv)), (gv, wv)


def test_sample_multinomial_matches_reference_frequencies():
    probs = np.asarray([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1]],
                       np.float32)
    with mt.cpu():
        mt.random.seed(5)
        got = port_apply("sample_multinomial", mt.nd.array(probs),
                         shape=(N_DRAWS,)).asnumpy()
        mt.random.seed(5)
        idx, logp = port_apply("sample_multinomial", mt.nd.array(probs),
                               shape=(8,), get_prob=True)
    ref.random.seed(5)
    want = ref_apply("sample_multinomial", ref.nd.array(probs),
                     shape=(N_DRAWS,)).asnumpy()
    assert got.shape == want.shape == (2, N_DRAWS)
    assert got.dtype == want.dtype
    for row in range(2):
        fg = np.bincount(got[row], minlength=4) / N_DRAWS
        fw = np.bincount(want[row], minlength=4) / N_DRAWS
        se = np.sqrt(probs[row] * (1 - probs[row]) / N_DRAWS)
        assert np.all(np.abs(fg - fw) <= 6 * np.sqrt(2) * se)
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(probs)[np.arange(2)[:, None], idx.asnumpy()],
        rtol=T.RTOL)


def test_same_seed_same_draws_and_shuffle_is_a_permutation():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    with mt.cpu():
        for name, attrs, arrays in SAMPLERS[:8]:
            a = _draw(mt, port_apply, name, attrs, arrays, 9)
            b = _draw(mt, port_apply, name, attrs, arrays, 9)
            np.testing.assert_array_equal(a, b)
        mt.random.seed(1)
        s1 = port_apply("shuffle", mt.nd.array(x)).asnumpy()
        mt.random.seed(1)
        s2 = port_apply("shuffle", mt.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(np.sort(s1[:, 0]), x[:, 0])
    np.testing.assert_array_equal(s1 - s1[:, :1], x - x[:, :1])


def test_sample_unique_zipfian_draws_distinct_sorted_classes():
    with mt.cpu():
        mt.random.seed(2)
        samples, counts = port_apply("_sample_unique_zipfian",
                                     range_max=1000, shape=(3, 20))
    s, c = samples.asnumpy(), counts.asnumpy()
    ref.random.seed(2)
    rs, rc = ref_apply("_sample_unique_zipfian", range_max=1000,
                       shape=(3, 20))
    assert s.shape == rs.shape and s.dtype == rs.dtype
    assert c.shape == rc.shape and c.dtype == rc.dtype
    flat = s.reshape(-1)
    assert np.all(np.diff(flat) > 0) and flat.min() >= 0 \
        and flat.max() < 1000
    # every count is the same number of trials times the class's
    # probability, and the trials cover at least the classes drawn
    trials = c.reshape(-1) / (np.log1p(1.0 / (flat + 1)) / np.log(1000))
    assert np.allclose(trials, trials[0], rtol=1e-5)
    assert trials[0] >= flat.size - 1e-3


# ------------------------------------------------------------ devices
def test_creation_ops_and_samplers_follow_the_current_context():
    """Ops without an array input write to ``mx.current_context()``: the
    CPU inside ``with mx.cpu():``, else gpu(0), which raises here (no
    CUDA device) instead of running on the CPU."""
    names = ("_zeros", "_ones", "_full", "_arange", "_linspace", "_eye",
             "_random_uniform", "_random_normal", "_random_randint")
    attrs = {"_arange": {"start": 0, "stop": 4},
             "_linspace": {"start": 0.0, "stop": 1.0, "num": 4},
             "_eye": {"N": 3}}
    with mt.cpu():
        for n in names:
            out = port_apply(n, **attrs.get(n, {"shape": (2, 3)}))
            assert out.context == mt.cpu(), n
    if mt.num_gpus() == 0:
        for n in names:
            with pytest.raises(mt.MXNetErrorNoDevice):
                port_apply(n, **attrs.get(n, {"shape": (2, 3)}))


def test_histogram_with_explicit_edges_and_range():
    x = np.random.RandomState(0).randn(200).astype(np.float32)
    edges = np.asarray([-3.0, -1.0, 0.0, 0.5, 2.0], np.float32)
    with mt.cpu():
        got = port_apply("_histogram", mt.nd.array(x),
                         bins=mt.nd.array(edges))
        got_r = port_apply("_histogram", mt.nd.array(x), bin_cnt=7,
                           range=(-1.0, 1.5))
    want = ref_apply("_histogram", ref.nd.array(x), bins=ref.nd.array(edges))
    want_r = ref_apply("_histogram", ref.nd.array(x), bin_cnt=7,
                       range=(-1.0, 1.5))
    for g, w in zip(list(got) + list(got_r), list(want) + list(want_r)):
        T.assert_same("_histogram", "output", g.asnumpy(), w.asnumpy())
