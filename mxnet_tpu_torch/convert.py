"""Carry the reference package's weights into the port.

``params_from_reference`` takes the JAX parameter pytree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``; tensors are taken as
they are) and returns a state dict
for the port's module (``TransformerLM.load_state_dict``), so both
packages compute from the same weights and their random generators never
have to agree.  ``params_to_reference`` is its inverse, so weights the
port has updated can be compared with the reference's.

``gluon_params_from_reference`` does the same for a Gluon Block: the
reference Block's parameters (trainable and aux) as ``{name: numpy}``
go onto the port's Block, matched by name; ``gluon_params_to_reference``
gives them back under the reference's names.  Every family of the model
zoo builds the reference's names, shapes and order (the zoo tests hold
them), so these two carry any of them, and ``save_parameters`` files
carry them too.
``shard_params`` takes the reference's tree, its PartitionSpecs
(``model.param_specs()``) and a mesh and gives this rank's blocks, for a
model built over the mesh; ``gather_params`` gathers every rank's blocks
back into the whole tree (every rank calls it).  ``shard_kv`` and
``gather_kv`` do the same for a paged KV pool, whose heads split over
``tp``.
``symbol_params_from_reference`` / ``symbol_params_to_reference`` carry
a symbolic Module's ``(arg_params, aux_params)`` across, as numpy.
``oneshot_from_reference`` carries a reference one-shot deploy artifact
(``-params.npz`` and ``-meta.json``; its StableHLO program is not read)
to the port's artifact for the same Block, f32 or int8.
"""
from __future__ import annotations

import os

import numpy as _np
import torch

__all__ = ["params_from_reference", "params_to_reference",
           "shard_params", "gather_params", "shard_kv", "gather_kv",
           "gluon_params_from_reference", "gluon_params_to_reference",
           "symbol_params_from_reference", "symbol_params_to_reference",
           "oneshot_from_reference"]


def _tensor(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = _np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: widen exactly, then narrow exactly
        return torch.from_numpy(a.astype(_np.float32)).to(torch.bfloat16)
    return torch.from_numpy(_np.ascontiguousarray(a))


def params_from_reference(np_tree):
    """Nested ``{"embed", "pos_embed", "final_norm", "layers": {...}}``
    numpy tree -> flat ``{"embed": t, ..., "layers.wqkv": t, ...}`` CPU
    tensors, layouts unchanged."""
    return {n: _tensor(v) for n, v in _leaves(np_tree).items()}


def _leaves(tree, prefix=""):
    """The leaves of a nested dict under dotted names."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


def params_to_reference(state_dict):
    """Flat ``{"embed": t, ..., "layers.wqkv": t, ...}`` tensors (a
    ``state_dict``) -> the nested numpy tree of the reference, layouts
    unchanged.  bf16 and f16 tensors come out as float32 (numpy has no
    bf16; the widening is exact)."""
    out = {}
    for name, t in state_dict.items():
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.numpy()
    return out


def _flat_specs(specs):
    """Nested PartitionSpecs -> ``{"layers.wqkv": spec, ...}``; a None
    spec (the reference's replicated leaf) is ``()``."""
    return {n: tuple(v) if v is not None else ()
            for n, v in _leaves(specs).items()}


def shard_params(np_tree, specs, mesh):
    """The reference's parameters (a nested numpy tree, as
    :func:`params_from_reference` takes it) and their PartitionSpecs (the
    same nesting, ``model.param_specs()``) -> this rank's blocks on
    ``mesh`` as a flat state dict of CPU tensors, for
    ``load_state_dict`` of the model built over ``mesh``."""
    from .parallel.collectives import local_block
    flat = _flat_specs(specs)
    return {n: local_block(t, mesh, flat.get(n, ())).contiguous()
            for n, t in params_from_reference(np_tree).items()}


@torch.no_grad()
def gather_params(state_dict, specs, mesh):
    """The inverse of :func:`shard_params`: every rank's blocks of a state
    dict gathered whole, as the reference's nested numpy tree, on every
    rank (a collective: every rank of ``mesh`` calls it)."""
    from .parallel.collectives import unshard
    flat = _flat_specs(specs)
    return params_to_reference({
        n: unshard(t.detach(), mesh, flat.get(n, ()))
        for n, t in state_dict.items()})


def _kv_spec(mesh):
    """The PartitionSpec of every array of a page pool (``[L, pages,
    page_size, H(, Dh)]``): heads over ``tp`` when the mesh has it."""
    return (None, None, None, "tp" if "tp" in mesh.axis_names else None)


def shard_kv(pool, mesh):
    """A whole page pool (``{"k", "v"}`` and, for int8 pages, ``{"k_scale",
    "v_scale"}``, as numpy arrays or tensors: the reference's
    ``init_kv_pages`` layout) -> this rank's head shard on ``mesh``, on
    its device: the pool ``TransformerLM.prefill`` / ``decode_step`` of
    the model built over ``mesh`` take.  Replicated over ``dp`` and
    ``sp``."""
    from .parallel.collectives import local_block
    spec = _kv_spec(mesh)
    return {n: local_block(_tensor(v), mesh, spec).to(mesh.device,
                                                      copy=True)
            for n, v in pool.items()}


@torch.no_grad()
def gather_kv(pool, mesh):
    """The inverse of :func:`shard_kv`: every rank's head shard gathered
    whole, as CPU tensors in the pool's dtypes, on every rank (a
    collective: every rank of ``mesh`` calls it)."""
    from .parallel.collectives import unshard
    spec = _kv_spec(mesh)
    return {n: unshard(t, mesh, spec).cpu() for n, t in pool.items()}


def _top_prefix(names):
    """The longest common prefix of ``names`` that ends in ``_`` (the
    reference Block's own prefix, e.g. ``resnetv10_``)."""
    common = os.path.commonprefix(list(names))
    return common[:common.rfind("_") + 1]


def _cut(prefix, parts):
    """``prefix`` up to and including its ``parts``-th ``_`` (all of it
    when it has fewer)."""
    end = -1
    for _ in range(parts):
        end = prefix.find("_", end + 1)
        if end < 0:
            return prefix
    return prefix[:end + 1]


def _ref_prefix(names, own):
    """What to strip from the reference's ``names`` to meet the port's
    names stripped of ``own``: their longest common prefix ending in
    ``_``, cut to as many ``_``-separated parts as ``own`` has (the
    packages count Block prefixes separately, ``resnetv10_`` here and
    ``resnetv11_`` there, and a one-child Block's names share more than
    its own prefix, ``gru0_l0_``)."""
    return _cut(_top_prefix(names), own.count("_"))


def pair_names(port_names, ref_names, own, ref=None):
    """``{port name: reference name}`` after stripping ``own`` from the
    port's names and ``ref`` (default :func:`_ref_prefix`) from the
    reference's; raises ``ValueError`` when the two sets do not pair
    up."""
    if ref is None:
        ref = _ref_prefix(ref_names, own)
    ours = {n[len(own):]: n for n in port_names}
    theirs = {n[len(ref):]: n for n in ref_names}
    if set(ours) != set(theirs):
        raise ValueError(
            "parameter names do not pair up: only in the port %s, only in "
            "the reference %s" % (sorted(set(ours) - set(theirs))[:8],
                                  sorted(set(theirs) - set(ours))[:8]))
    return {ours[k]: theirs[k] for k in ours}


def _own_prefix(block, names):
    """What to strip from ``block``'s own parameter names: its prefix, or
    where a name does not start with it (a Sequential whose children were
    made outside its ``name_scope``) the names' longest common prefix
    ending in ``_``."""
    if all(n.startswith(block.prefix) for n in names):
        return block.prefix
    return _top_prefix(names)


def gluon_params_from_reference(block, np_params, prefix=None):
    """Set ``block``'s Parameters from the reference Block's
    ``{name: array}`` (``{n: p.data().asnumpy() for n, p in
    ref.collect_params().items()}``).

    The two packages count Block prefixes separately (``resnetv10_`` here,
    ``resnetv11_`` there), so names are matched after stripping each
    net's own top prefix: the port Block's ``prefix`` (or its names'
    longest common prefix ending in ``_`` where they do not start with
    it) and, for the reference's names, ``prefix`` or else their longest
    common prefix ending in ``_`` cut to as many ``_``-separated parts as
    the port's (:func:`pair_names`).  A name or shape that does not pair
    up raises ``ValueError``.  Values keep each Parameter's dtype and device; a
    deferred Parameter keeps its value for its first forward."""
    params = block.collect_params()
    own = _own_prefix(block, list(params.keys()))
    pairs = pair_names(list(params.keys()), list(np_params), own, prefix)
    ours = {n: params[n] for n in pairs}
    theirs = {n: np_params[pairs[n]] for n in pairs}
    for name, p in ours.items():
        val = _tensor(theirs[name])
        if p.shape is not None and (len(p.shape) != val.dim() or any(
                s not in (0, v) for s, v in zip(p.shape, val.shape))):
            raise ValueError("shape of %s: port %s, reference %s"
                             % (name, p.shape, tuple(val.shape)))
        p.set_data(val)


def gluon_params_to_reference(block, prefix):
    """``block``'s Parameters as ``{reference name: numpy}``: the port
    Block's own top prefix (see :func:`gluon_params_from_reference`)
    replaced by the reference's ``prefix``, as copies; bf16 and f16
    values widen to float32."""
    out = {}
    params = block.collect_params()
    own = _own_prefix(block, list(params.keys()))
    for name, p in params.items():
        t = p.data()._data.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        # a copy: on the CPU ``numpy()`` shares the Parameter's storage,
        # which its optimizer updates in place
        out[prefix + name[len(own):]] = t.numpy().copy()
    return out


def _numpy_copy(v):
    t = getattr(v, "_data", v)
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        t = t.numpy()
    return _np.array(t, copy=True)


def symbol_params_from_reference(arg_params, aux_params, ctx=None):
    """The reference Module's ``(arg_params, aux_params)`` (NDArrays or
    numpy, ``{n: v.asnumpy()}``) as the port's NDArrays on ``ctx``
    (copies), ready for ``Module.init_params`` / ``set_params``."""
    from .ndarray.ndarray import array
    return ({n: array(_np.asarray(v), ctx=ctx)
             for n, v in arg_params.items()},
            {n: array(_np.asarray(v), ctx=ctx)
             for n, v in aux_params.items()})


def symbol_params_to_reference(arg_params, aux_params):
    """The port's ``(arg_params, aux_params)`` as ``{name: numpy}`` dicts:
    copies, not views (a view of a CPU tensor would follow the in-place
    updates of a later step); bf16 and f16 widen to float32."""
    return ({n: _numpy_copy(v) for n, v in arg_params.items()},
            {n: _numpy_copy(v) for n, v in aux_params.items()})


def oneshot_from_reference(block, ref_prefix, prefix, ref_param_prefix=None):
    """Write the port's one-shot artifact at ``prefix`` from the
    reference's at ``ref_prefix`` (``deploy.export_model`` f32 v1/v2, or
    ``quantization.export_quantized`` int8 v3), for ``block``, the same
    network built in the port: the graph is the Block's own, the params
    and the meta fields are the reference's (int8 payloads and
    ``<name>::scale`` companions included), renamed to the port's
    parameter names as :func:`gluon_params_from_reference` pairs them.
    The calibration manifest's weights are renamed too, so the port
    recolors the same sites.  Returns the written paths."""
    import json
    from . import deploy as _deploy
    from .quantization import SCALE_SUFFIX, _block_device, _forward
    with open(ref_prefix + "-meta.json") as f:
        meta = json.load(f)
    if meta.get("generate", False):
        raise ValueError("%r is a generation artifact; this carries "
                         "one-shot artifacts only" % (ref_prefix,))
    shape = meta.get("input_shape")
    dtype = _np.dtype(meta.get("input_dtype", "float32"))
    _forward(block, _np.zeros(shape, dtype), _block_device(block))
    port_names = list(block.collect_params().keys())
    ref_names = [n for n in meta["param_names"]
                 if not n.endswith(SCALE_SUFFIX)]
    own = _own_prefix(block, port_names)
    to_port = {r: p for p, r in pair_names(port_names, ref_names, own,
                                           ref_param_prefix).items()}

    def rename(n):
        if n.endswith(SCALE_SUFFIX):
            return to_port[n[:-len(SCALE_SUFFIX)]] + SCALE_SUFFIX
        return to_port[n]

    arrays = None
    if os.path.exists(ref_prefix + "-params.npz"):
        with _np.load(ref_prefix + "-params.npz") as loaded:
            arrays = {rename(n): loaded[n] for n in meta["param_names"]}
    graph, input_name = _deploy._trace(block)
    meta = dict(meta)
    meta["param_names"] = [rename(n) for n in meta["param_names"]]
    meta["program"] = _deploy.ONESHOT_PROGRAM
    meta["input_name"] = input_name
    if meta.get("quantized"):
        meta["quantized_params"] = [to_port[n]
                                    for n in meta["quantized_params"]]
        # no drift-monitoring twin in the port's artifact
        meta["stats_sites"] = []
        cal = dict(meta.get("calibration") or {})
        cal["sites"] = [dict(s, weight=to_port.get(s.get("weight"),
                                                   s.get("weight")))
                        for s in cal.get("sites", [])]
        meta["calibration"] = cal
    return _deploy._write_oneshot(prefix, graph, meta, arrays)
