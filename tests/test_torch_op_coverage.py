"""The coverage gate of the port's op library, array API and Gluon
surface: what the reference has and the port does not is an explicit
list here, grouped by the ROADMAP slice that will port it, so nothing is
missing silently."""
import pytest

import mxnet_tpu as ref
import mxnet_tpu.operator  # noqa: F401  (registers the reference's Custom)
import mxnet_tpu.gluon.model_zoo.model_store  # noqa: F401
import mxnet_tpu.gluon.model_zoo.vision  # noqa: F401
import mxnet_tpu.compat, mxnet_tpu.image, mxnet_tpu.recordio  # noqa: F401
import mxnet_tpu.resilience, mxnet_tpu.gluon.data  # noqa: F401
import mxnet_tpu.gluon.contrib.data  # noqa: F401
import mxnet_tpu.models.ssd  # noqa: F401
import mxnet_tpu.parallel  # noqa: F401
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.models.ssd  # noqa: F401
import mxnet_tpu_torch.gluon.model_zoo.model_store  # noqa: F401
import mxnet_tpu_torch.gluon.model_zoo.vision  # noqa: F401
from mxnet_tpu.ops.registry import _REGISTRY
from mxnet_tpu_torch.ops.registry import _REGISTRY as PORT_OPS

# the reference's built-in ops: its op library, the symbol module's two
# and CustomOp's (ops other tests register at run time are not part of
# the library)
REF_OPS = {n: op for n, op in _REGISTRY.items()
           if op.fn.__module__.startswith("mxnet_tpu.ops")
           or op.fn.__module__ in ("mxnet_tpu.symbol.symbol",
                                   "mxnet_tpu.operator")}

# the reference's canonical op names the port does not register yet, by
# the reference module that registers them and the slice (ROADMAP queue 1)
# that ports them
UNPORTED_OPS = {
    # slice 16 (the rest)
    "contrib_extra": {
        "_contrib_allclose", "_contrib_arange_like",
        "_contrib_count_sketch", "_contrib_edge_id", "_contrib_getnnz",
        "_contrib_hawkesll", "_contrib_index_array", "_contrib_index_copy",
        "_contrib_quadratic"},
    # slice 16 (CustomOp, `operator.py`)
    "operator": {"Custom"},
}
SLICE_OF_MODULE = {"contrib_extra": "16", "operator": "16"}

# the array API names the reference has and the port does not, by slice
UNPORTED_API = {
    "NDArray": {"to_dlpack_for_read": "16", "to_dlpack_for_write": "16",
                "as_np_ndarray": "16"},
    "nd": {"dgl": "16", "from_dlpack": "16", "from_jax": "16",
           "sparse": "16", "to_dlpack_for_read": "16",
           "to_dlpack_for_write": "16"},
    "random": {},
    # the DGL graph functions the reference's nd.contrib imports
    "nd.contrib": {"dgl_adjacency": "16",
                   "dgl_csr_neighbor_non_uniform_sample": "16",
                   "dgl_csr_neighbor_uniform_sample": "16",
                   "dgl_graph_compact": "16", "dgl_subgraph": "16"},
}

_RESILIENCE_REST = ("CheckpointManager", "MANIFEST_SCHEMA",
                    "NonFiniteStepError", "all_finite", "clear_preempt",
                    "configure_preemption", "exit_on_preempt",
                    "flush_sinks", "guarded_streak", "manifest_path",
                    "maybe_abort_nonfinite", "nanguard_mode",
                    "nonfinite_stats", "note_finite", "poison_batch",
                    "preempt_requested", "report_nonfinite",
                    "reset_nanguard", "select_tree", "verify_checkpoint",
                    "write_manifest")
# the Gluon, model-zoo, initializer, optimizer, Module, data-pipeline and
# persistence names the reference has and the port does not, by surface
# and slice; a surface is a module's public names (its __all__ where it
# lists them, so that its own imports do not count) or a class's public
# attributes
UNPORTED_SURFACE = {
    "gluon": {},
    "gluon.rnn": {},
    "gluon.contrib": {"estimator": "16"},
    "gluon.contrib.nn": {},
    "gluon.contrib.cnn": {},
    "gluon.contrib.rnn": {},
    "gluon.contrib.data": {},
    "gluon.data": {},
    "gluon.data.vision": {},
    "gluon.data.vision.transforms": {},
    "rnn": {},
    "module": {},
    "module.BucketingModule": {},
    "module.SequentialModule": {},
    "module.PythonLossModule": {},
    "gluon.nn": {},
    "gluon.loss": {},
    "gluon.utils": {},
    "gluon.Block": {},
    "gluon.HybridBlock": {},
    "gluon.SymbolBlock": {},
    "gluon.ParameterDict": {},
    "gluon.Parameter": {"row_sparse_data": "16",
                        "list_row_sparse_data": "16"},
    "gluon.Constant": {"row_sparse_data": "16",
                       "list_row_sparse_data": "16"},
    "gluon.Trainer": {},
    "gluon.model_zoo.vision": {},
    "gluon.model_zoo.model_store": {},
    "initializer": {},
    "optimizer": {},
    "optimizer.Updater": {},
    "model": {},
    "model.FeedForward": {},
    "compat": {},
    "recordio": {},
    "recordio.MXIndexedRecordIO": {},
    "io": {"LibSVMIter": "16"},
    "io.DevicePrefetcher": {},
    "image": {},
    "image.ImageIter": {},
    "models.ssd": {},
    "sym.contrib": {},
    "resilience": dict.fromkeys(_RESILIENCE_REST, "14"),
    "parallel": {},
    "parallel.SPMDTrainer": {},
    "kvstore.KVStore": {},
}


def _canonical(registry):
    return {op.name for op in registry.values()}


def _module(name):
    return REF_OPS[name].fn.__module__.rsplit(".", 1)[-1]


def test_unported_ops_are_exactly_the_listed_ones():
    missing = {n for n in _canonical(REF_OPS) if n not in PORT_OPS}
    by_module = {}
    for n in missing:
        by_module.setdefault(_module(n), set()).add(n)
    assert by_module == UNPORTED_OPS
    assert set(SLICE_OF_MODULE) == set(UNPORTED_OPS)


def test_every_name_of_a_ported_op_resolves_to_it():
    """Each of the reference's names (aliases included) whose op the port
    has resolves in the port to the op of the same canonical name; the
    six modules of the op library are ported under every name."""
    for name, op in REF_OPS.items():
        if op.name in PORT_OPS:
            assert name in PORT_OPS, name
            assert PORT_OPS[name].name == op.name, (name, op.name)
    library = {"tensor", "nn", "misc", "linalg", "random_ops", "optim_ops",
               "pallas_kernels"}
    for name, op in REF_OPS.items():
        if op.fn.__module__.rsplit(".", 1)[-1] in library:
            assert name in PORT_OPS, name


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


def test_unported_array_api_is_exactly_the_listed_names():
    assert _public(ref.nd.NDArray) - _public(mt.nd.NDArray) \
        == set(UNPORTED_API["NDArray"])
    ref_nd = {n for n in dir(ref.nd) if not n.startswith("_")}
    port_nd = {n for n in ref_nd if hasattr(mt.nd, n)}
    assert ref_nd - port_nd == set(UNPORTED_API["nd"])
    ref_random = {n for n in ref.random.__all__}
    assert {n for n in ref_random if not hasattr(mt.random, n)} \
        == set(UNPORTED_API["random"])
    assert {n for n in _public(ref.nd.contrib)
            if not hasattr(mt.nd.contrib, n)} \
        == set(UNPORTED_API["nd.contrib"])
    for name in ("foreach", "while_loop", "cond"):
        assert callable(getattr(mt.nd.contrib, name))


def _owner(pkg, path):
    obj = pkg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _surface(obj):
    return set(obj.__all__) if hasattr(obj, "__all__") else _public(obj)


@pytest.mark.parametrize("surface", sorted(UNPORTED_SURFACE))
def test_unported_gluon_surface_is_exactly_the_listed_names(surface):
    """Each name of the surface in the reference exists in the port,
    apart from the listed ones, which do not."""
    port = _owner(mt, surface)
    missing = {n for n in _surface(_owner(ref, surface))
               if not hasattr(port, n)}
    assert missing == set(UNPORTED_SURFACE[surface])
