"""Symbol — lazy graph composition over the op registry, and its Executor
(counterpart of ``mxnet_tpu.symbol.symbol``).

Reference: ``python/mxnet/symbol/symbol.py`` over the NNVM graph.  As in
the JAX package, a Symbol is an immutable Python DAG node naming a
registered op; binding interprets the DAG with the registered ops
(:func:`_eval_symbol`).  There is no ``jit`` here: PyTorch runs each op
as it comes, gradients come from ``torch.autograd.grad`` over the same
interpretation, and shape inference runs the ops on ``meta`` tensors
(:func:`_infer_shapes_partial`, with the reference's parameter-shape
rules).  The graph JSON is the JAX package's own schema
(``mxnet_tpu-symbol-v1``), so each package loads the other's files.

Not ported: ``group2ctx`` placement, ``AttrScope`` annotations,
``Variable(init=...)``, monitor callbacks, numerics taps and the
Apache-MXNet (NNVM) graph JSON reader; each raises NotImplementedError
when asked for.
"""
from __future__ import annotations

import json

import numpy as _np
import torch

from .. import config as _config
from .. import telemetry as _telemetry
from ..base import atomic_write, torch_dtype
from ..context import resolve_device
from ..ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "Executor", "zeros", "ones"]

_FORMAT = "mxnet_tpu-symbol-v1"


class Symbol:
    """Immutable graph node.

    kind: 'var' (named input), 'op' (registered op applied to inputs),
    'slice' (one output of a multi-output node), 'group' (tuple of heads,
    reference ``mx.sym.Group``).  ``inputs`` entries are Symbols or
    Python/numpy constants (scalars embed directly, as in ``sym + 1``).
    """

    __slots__ = ("kind", "name", "op", "attrs", "inputs", "index",
                 "_attr_map")

    def __init__(self, kind, name, op=None, attrs=None, inputs=(), index=0):
        self.kind = kind
        self.name = name
        self.op = op
        self.attrs = attrs or {}
        self.inputs = list(inputs)
        self.index = index
        self._attr_map = {}

    # ------------------------------------------------------------- identity
    def __repr__(self):
        return "<Symbol %s>" % (self.name,)

    def attr(self, key):
        return self._attr_map.get(key)

    def attr_dict(self):
        return {node.name: dict(node._attr_map) for node in _topo(self)
                if node._attr_map}

    # ------------------------------------------------------------ listings
    def list_arguments(self):
        """Names of the variable leaves in topological order, aux states
        excluded (reference ``Symbol.list_arguments``)."""
        return [n.name for n in _topo(self)
                if n.kind == "var" and not _is_aux_name(n.name)]

    def list_auxiliary_states(self):
        return [n.name for n in _topo(self)
                if n.kind == "var" and _is_aux_name(n.name)]

    def list_inputs(self):
        return [n.name for n in _topo(self) if n.kind == "var"]

    def list_outputs(self):
        """One name per output; a multi-output head expands to
        ``name_output0..N``."""
        names = []
        for h in self._heads():
            n = _node_num_outputs(h)
            if n > 1 and h.kind == "op" and self.kind != "group":
                names.extend("%s_output%d" % (h.name, i) for i in range(n))
            elif h.kind == "var":
                names.append(h.name)
            else:
                names.append(h.name + "_output")
        return names

    @property
    def num_outputs(self):
        return len(self._heads())

    def _heads(self):
        return list(self.inputs) if self.kind == "group" else [self]

    def __iter__(self):
        heads = self._heads()
        if len(heads) == 1:
            n = _node_num_outputs(heads[0])
            if n > 1:
                return iter([heads[0][i] for i in range(n)])
        return iter(heads)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            idx = self.list_outputs().index(idx)
        if self.kind == "group":
            return self.inputs[idx]
        if _node_num_outputs(self) > 1:
            return Symbol("slice", "%s%d" % (self.name, idx),
                          inputs=[self], index=idx)
        if idx != 0:
            raise IndexError("output index %d out of range" % idx)
        return self

    def get_internals(self):
        """Group of every node's outputs (reference
        ``Symbol.get_internals``)."""
        return Group(list(_topo(self)))

    def get_children(self):
        ins = [i for i in self.inputs if isinstance(i, Symbol)]
        return Group(ins) if ins else None

    # ----------------------------------------------------------- operators
    def _binop(self, opname, other, reverse=False):
        a, b = (other, self) if reverse else (self, other)
        return _make_op_node(opname, [a, b], {})

    def __add__(self, o): return self._binop("broadcast_add", o)
    def __radd__(self, o): return self._binop("broadcast_add", o, True)
    def __sub__(self, o): return self._binop("broadcast_sub", o)
    def __rsub__(self, o): return self._binop("broadcast_sub", o, True)
    def __mul__(self, o): return self._binop("broadcast_mul", o)
    def __rmul__(self, o): return self._binop("broadcast_mul", o, True)
    def __truediv__(self, o): return self._binop("broadcast_div", o)
    def __rtruediv__(self, o): return self._binop("broadcast_div", o, True)
    def __pow__(self, o): return self._binop("broadcast_power", o)
    def __neg__(self): return _make_op_node("negative", [self], {})
    def __eq__(self, o): return self._binop("broadcast_equal", o)
    def __ne__(self, o): return self._binop("broadcast_not_equal", o)
    def __lt__(self, o): return self._binop("broadcast_lesser", o)
    def __le__(self, o): return self._binop("broadcast_lesser_equal", o)
    def __gt__(self, o): return self._binop("broadcast_greater", o)
    def __ge__(self, o): return self._binop("broadcast_greater_equal", o)
    __hash__ = object.__hash__

    def __getattr__(self, name):
        # method-style op application: sym.reshape(...), sym.mean(...)
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            _registry.get(name)
        except AttributeError:
            raise AttributeError("Symbol has no attribute %r" % (name,)) \
                from None

        def method(*args, **kwargs):
            return _make_op_node(name, [self] + list(args), kwargs)
        method.__name__ = name
        return method

    # ----------------------------------------------------- shape/type infer
    def infer_shape(self, *args_shapes, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` (reference
        ``Symbol.infer_shape``), partial: parameter shapes follow from the
        data shapes by the per-op rules, and unknown ones come back as
        None."""
        if args_shapes:
            kwargs.update(zip(self.list_arguments(), args_shapes))
        known = {n: tuple(v) for n, v in kwargs.items() if v is not None}
        var_shapes, out_shapes = _infer_shapes_partial(self, known)
        arg_res = [var_shapes.get(n) for n in self.list_arguments()]
        aux_res = [var_shapes.get(n) for n in self.list_auxiliary_states()]
        out_res = []
        for h in self._heads():
            n = _node_num_outputs(h)
            if n > 1 and h.kind == "op" and self.kind != "group":
                out_res.extend(out_shapes.get((id(h), i)) for i in range(n))
            else:
                base, idx = _unwrap_slice(h)
                out_res.append(out_shapes.get((id(base), idx)))
        return arg_res, out_res, aux_res

    def infer_type(self, **kwargs):
        """float32 for everything unless given, as the reference types."""
        f32 = _np.dtype(_np.float32)
        return ([_np.dtype(kwargs.get(n, f32))
                 for n in self.list_arguments()],
                [f32] * len(self.list_outputs()),
                [f32] * len(self.list_auxiliary_states()))

    # -------------------------------------------------------------- binding
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Allocate zero arguments from shapes and bind (reference
        ``MXExecutorSimpleBindEx``); arrays live on ``ctx`` (the current
        context by default)."""
        if group2ctx:
            raise NotImplementedError("group2ctx placement is not ported")
        device = resolve_device(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        from ..ndarray.ndarray import _wrap
        args, aux = {}, {}
        for name, shp in zip(self.list_arguments(), arg_shapes):
            if shp is None:
                raise ValueError("simple_bind could not infer a shape for "
                                 "%r: pass it explicitly" % (name,))
            dt = torch_dtype((type_dict or {}).get(name, "float32"))
            args[name] = _wrap(torch.zeros(shp, dtype=dt, device=device))
        for name, shp in zip(self.list_auxiliary_states(), aux_shapes):
            if shp is None:
                raise ValueError("simple_bind could not infer a shape for "
                                 "aux %r" % (name,))
            aux[name] = _wrap(torch.zeros(shp, device=device))
        args_grad = None
        if grad_req != "null":
            args_grad = {n: _wrap(torch.zeros_like(v._data))
                         for n, v in args.items()}
        return Executor(self, device, args, args_grad, grad_req, aux)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind with explicit arrays (reference ``MXExecutorBindEX``):
        NDArrays are used as they are, anything else is copied onto
        ``ctx``."""
        if group2ctx:
            raise NotImplementedError("group2ctx placement is not ported")
        device = resolve_device(ctx)
        names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(names, args))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(names, args_grad))
        return Executor(self, device, _as_nd(args, device), _as_nd(
            args_grad, device) or None, grad_req, _as_nd(aux_states, device))

    def eval(self, ctx=None, **kwargs):
        """One-shot forward (reference ``Symbol.eval``)."""
        return self.bind(ctx, args=kwargs).forward()

    # -------------------------------------------------------- serialization
    def tojson(self):
        """The graph as JSON in the JAX package's schema (``format``
        ``mxnet_tpu-symbol-v1``)."""
        nodes = _topo(self)
        nid = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            ins = []
            for x in n.inputs:
                if isinstance(x, Symbol):
                    ins.append(["node", nid[id(x)]])
                else:
                    ins.append(["const", _const_json(x)])
            out_nodes.append({
                "kind": n.kind, "name": n.name, "op": n.op,
                "attrs": _json_attrs(n.attrs), "inputs": ins,
                "index": n.index, "attr_map": n._attr_map,
            })
        heads = [nid[id(h)] for h in self._heads()]
        return json.dumps({"nodes": out_nodes, "heads": heads,
                           "format": _FORMAT}, indent=2)

    def save(self, fname):
        with atomic_write(fname, "w") as f:
            f.write(self.tojson())


def _as_nd(arrays, device):
    from ..ndarray.ndarray import NDArray, array
    return {n: v if isinstance(v, NDArray) else array(v, ctx=device)
            for n, v in (arrays or {}).items()}


def _const_json(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return _np.asarray(x).tolist()


def _json_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, _np.dtype):
            v = v.name
        elif isinstance(v, torch.dtype):
            v = str(v)[len("torch."):]
        elif isinstance(v, type):
            v = _np.dtype(v).name
        elif isinstance(v, tuple):
            v = list(v)
        out[k] = v
    return out


def load_json(s):
    """A Symbol from :meth:`Symbol.tojson`'s JSON (either package's)."""
    if '"arg_nodes"' in s and '"nodes"' in s:
        raise NotImplementedError(
            "an Apache-MXNet (NNVM) symbol.json: its reader "
            "(compat.load_mxnet_symbol) is not ported yet (slice 9)")
    data = json.loads(s)
    nodes = []
    for spec in data["nodes"]:
        ins = [nodes[val] if kind == "node" else val
               for kind, val in spec["inputs"]]
        n = Symbol(spec["kind"], spec["name"], spec.get("op"),
                   spec.get("attrs") or {}, ins, spec.get("index", 0))
        n._attr_map = spec.get("attr_map") or {}
        nodes.append(n)
    heads = [nodes[i] for i in data["heads"]]
    return heads[0] if len(heads) == 1 else Group(heads)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ------------------------------------------------------------ constructors
def Variable(name, shape=None, dtype=None, init=None, **attr_kwargs):
    s = Symbol("var", name)
    if shape is not None:
        s.attrs["shape"] = tuple(shape)
    if dtype is not None:
        s.attrs["dtype"] = str(torch_dtype(dtype))[len("torch."):]
    if init is not None:
        # the initializer as its dumps() in the __init__ attr (the
        # reference's); Initializer.__call__ routes an InitDesc carrying
        # it back to that initializer at Module.init_params
        s._attr_map["__init__"] = init if isinstance(init, str) \
            else init.dumps()
    s._attr_map.update({k: str(v) for k, v in attr_kwargs.items()})
    return s


var = Variable


def Group(symbols):
    return Symbol("group", "group", inputs=list(symbols))


def zeros(shape, dtype="float32", **_):
    return _make_op_node("_zeros_shape", [],
                         {"shape": tuple(shape), "dtype": dtype})


def ones(shape, dtype="float32", **_):
    return _make_op_node("_ones_shape", [],
                         {"shape": tuple(shape), "dtype": dtype})


def _fill_shape(shape):
    # a 0 dim means "unknown, solve at bind" in the reference; inference
    # here is forward-only, so it lowers to 1 and broadcasting carries it
    return tuple(1 if s == 0 else s for s in shape)


def _filled(value):
    def op(shape=(), dtype="float32", **_):
        from ..context import current_context
        return torch.full(_fill_shape(shape), value, dtype=torch_dtype(dtype),
                          device=current_context().torch_device)
    return op


_registry.register("_zeros_shape", differentiable=False)(_filled(0.0))
_registry.register("_ones_shape", differentiable=False)(_filled(1.0))


_NAME_COUNTER = {}


def _auto_name(opname):
    base = opname.lower().lstrip("_")
    i = _NAME_COUNTER.get(base, 0)
    _NAME_COUNTER[base] = i + 1
    return "%s%d" % (base, i)


# Learnable-input slots per layer op: a missing one is auto-created as the
# Variable "{name}_{slot}" (reference: the generated op wrappers).
_OP_INPUT_SLOTS = {
    "FullyConnected": ("data", "weight", "bias"),
    "Convolution": ("data", "weight", "bias"),
    "BatchNorm": ("data", "gamma", "beta", "moving_mean", "moving_var"),
    "SoftmaxOutput": ("data", "label"),
    "LinearRegressionOutput": ("data", "label"),
    "LogisticRegressionOutput": ("data", "label"),
    "MAERegressionOutput": ("data", "label"),
}


def _make_op_node(opname, inputs, attrs):
    op = _registry.get(opname)  # raises AttributeError for unknown ops
    name = attrs.pop("name", None) or _auto_name(opname)
    slots = _OP_INPUT_SLOTS.get(op.name)
    if slots:
        slot_vals = dict(zip(slots, inputs))
        for s in slots:
            if s in attrs:
                slot_vals[s] = attrs.pop(s)
        no_bias = bool(attrs.get("no_bias", False))
        inputs = []
        for s in slots:
            v = slot_vals.get(s)
            if v is None:
                if s == "bias" and no_bias:
                    inputs.append(None)
                    continue
                if s == "data":
                    raise ValueError("%s: missing data input" % (op.name,))
                v = Variable("%s_%s" % (name, s))
            inputs.append(v)
    elif "data" in attrs and not inputs:
        inputs = [attrs.pop("data")]
    from ..ndarray.ndarray import NDArray
    inputs = [x._data if isinstance(x, NDArray) else x for x in inputs]
    return Symbol("op", name, op=op.name, attrs=attrs, inputs=inputs)


# Parameter-shape rules: given op attrs and the data shape, the shapes of
# the learnable inputs (the reverse half of the reference's per-op
# FInferShape); the forward half runs each op on meta tensors.
def _fc_param_shapes(attrs, dshape):
    nh = int(attrs["num_hidden"])
    flatten = attrs.get("flatten", True)
    in_dim = int(_np.prod(dshape[1:])) if flatten else dshape[-1]
    return {1: (nh, in_dim), 2: (nh,)}


def _conv_param_shapes(attrs, dshape):
    nf = int(attrs["num_filter"])
    groups = int(attrs.get("num_group", 1))
    return {1: (nf, dshape[1] // groups) + tuple(attrs["kernel"]), 2: (nf,)}


def _bn_param_shapes(attrs, dshape):
    c = dshape[int(attrs.get("axis", 1))]
    return {1: (c,), 2: (c,), 3: (c,), 4: (c,)}


def _softmax_output_label_shape(attrs, dshape):
    # reference SoftmaxOutput FInferShape: the label is (N,) class indices
    return {1: (dshape[0],)}


def _regression_output_label_shape(attrs, dshape):
    return {1: tuple(dshape)}


_PARAM_SHAPE_RULES = {
    "SoftmaxOutput": _softmax_output_label_shape,
    "LinearRegressionOutput": _regression_output_label_shape,
    "LogisticRegressionOutput": _regression_output_label_shape,
    "MAERegressionOutput": _regression_output_label_shape,
    "FullyConnected": _fc_param_shapes,
    "Convolution": _conv_param_shapes,
    "BatchNorm": _bn_param_shapes,
}

# unary ops that keep their input's shape: a parameter's shape may be
# followed through them to the variable they wrap
_SHAPE_TRANSPARENT = {"cast", "BlockGrad", "negative", "relu", "abs"}

# ops whose `training` attr the executor's is_train decides
_TRAIN_MODE_OPS = {"BatchNorm"}


def _infer_shapes_partial(sym, known):
    """Forward shape propagation on ``meta`` tensors with the reverse
    parameter rules (the stand-in for the reference's InferShape pass).
    Returns ``{var_name: shape}`` (with ``known``) and
    ``{(node_id, out_idx): shape}``."""
    var_shapes = dict(known)
    out_shapes = {}

    def in_shape(x):
        if not isinstance(x, Symbol):
            return tuple(_np.shape(x))
        if x.kind == "var":
            if x.name in var_shapes:
                return var_shapes[x.name]
            return tuple(x.attrs["shape"]) if "shape" in x.attrs else None
        base, idx = _unwrap_slice(x)
        return out_shapes.get((id(base), idx))

    for node in _topo(sym):
        if node.kind == "var":
            s = in_shape(node)
            if s is not None:
                out_shapes[(id(node), 0)] = s
            continue
        if node.kind == "slice":
            s = out_shapes.get((id(node.inputs[0]), node.index))
            if s is not None:
                out_shapes[(id(node), 0)] = s
            continue
        if node.kind != "op":
            continue
        shapes = [in_shape(x) if x is not None else None
                  for x in node.inputs]
        rule = _PARAM_SHAPE_RULES.get(node.op)
        if rule is not None and shapes and shapes[0] is not None:
            for i, shp in rule(node.attrs, shapes[0]).items():
                if i >= len(node.inputs) or shapes[i] is not None or \
                        not isinstance(node.inputs[i], Symbol):
                    continue
                chain = [node.inputs[i]]
                while chain[-1].kind == "op" and \
                        chain[-1].op in _SHAPE_TRANSPARENT and \
                        isinstance(chain[-1].inputs[0], Symbol):
                    chain.append(chain[-1].inputs[0])
                if chain[-1].kind != "var":
                    continue
                shapes[i] = tuple(shp)
                var_shapes[chain[-1].name] = tuple(shp)
                for c in chain:
                    out_shapes[(id(c), 0)] = tuple(shp)
        if any(s is None and x is not None
               for s, x in zip(shapes, node.inputs)):
            continue  # unknown inputs: this node's outputs stay unknown
        vals = []
        for s, x in zip(shapes, node.inputs):
            if isinstance(x, Symbol):
                vals.append(torch.empty(s, device="meta"))
            else:
                vals.append(x)
        attrs = dict(node.attrs)
        if node.op in _TRAIN_MODE_OPS:
            attrs["training"] = False
        try:
            res = _registry.get(node.op).fn(*vals, **attrs)
        except (RuntimeError, TypeError, ValueError, NotImplementedError):
            continue  # an op meta tensors cannot run: shapes stay unknown
        outs = list(res) if isinstance(res, (tuple, list)) else [res]
        for i, o in enumerate(outs):
            out_shapes[(id(node), i)] = tuple(o.shape)
    return var_shapes, out_shapes


# ----------------------------------------------------------------- traversal
def _topo(sym):
    """Post-order unique traversal."""
    seen = set()
    order = []

    def visit(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for x in n.inputs:
            if isinstance(x, Symbol):
                visit(x)
        order.append(n)

    visit(sym)
    if sym.kind == "group":
        # by identity: Symbol.__eq__ builds graph nodes
        order = [n for n in order if n is not sym]
    return order


# Ops whose extra outputs are internal (reference FNumVisibleOutputs):
# BatchNorm's batch mean and variance.
_VISIBLE_OUTPUTS = {"BatchNorm": 1}


def _unwrap_slice(x):
    """(base node, output index) of a symbol that may select one output of
    a multi-output op."""
    if x.kind == "slice":
        return x.inputs[0], x.index
    return x, 0


def _node_num_outputs(node):
    if node.kind != "op":
        return 1
    if node.op in _VISIBLE_OUTPUTS:
        return _VISIBLE_OUTPUTS[node.op]
    n = _registry.get(node.op).num_outputs
    if n == -1:  # attr-dependent (split)
        return int(node.attrs.get("num_outputs", 1))
    return n


# Aux-state write-backs: the reference's BatchNorm updates its moving
# statistics inside the kernel; the ops here are pure, so the executor
# applies them.
def _bn_aux_update(node, env_in, outs):
    mom = float(node.attrs.get("momentum", 0.9))
    mm, mv = node.inputs[3], node.inputs[4]
    updates = {}
    if isinstance(mm, Symbol) and mm.kind == "var":
        updates[mm.name] = mom * env_in[3] + (1 - mom) * outs[1].detach()
    if isinstance(mv, Symbol) and mv.kind == "var":
        updates[mv.name] = mom * env_in[4] + (1 - mom) * outs[2].detach()
    return updates


_AUX_UPDATE_RULES = {"BatchNorm": _bn_aux_update}

_AUX_SUFFIXES = ("moving_mean", "moving_var", "running_mean", "running_var",
                 "moving_avg")


def _is_aux_name(name):
    return name.endswith(_AUX_SUFFIXES)


def _eval_symbol(sym, env, training, aux_updates=None):
    """Interpret the DAG on tensors; ``env`` maps variable names to
    tensors.  Returns the list of head outputs; under ``training`` the
    aux write-backs land in ``aux_updates`` when it is given."""
    cache = {}

    def value(node, index=0):
        key = (id(node), index)
        if key in cache:
            return cache[key]
        if node.kind == "var":
            if node.name not in env:
                raise ValueError("unbound variable %r" % (node.name,))
            out = env[node.name]
        elif node.kind == "slice":
            out = value(node.inputs[0], node.index)
        elif node.kind == "op":
            vals = [value(x) if isinstance(x, Symbol) else x
                    for x in node.inputs]
            attrs = dict(node.attrs)
            if node.op in _TRAIN_MODE_OPS:
                # the executor's is_train decides, not an attr baked in
                attrs["training"] = training
            res = _registry.get(node.op).fn(*vals, **attrs)
            outs = list(res) if isinstance(res, (tuple, list)) else [res]
            for i, o in enumerate(outs):
                cache[(id(node), i)] = o
            if training and aux_updates is not None \
                    and node.op in _AUX_UPDATE_RULES:
                aux_updates.update(
                    _AUX_UPDATE_RULES[node.op](node, vals, outs))
            out = outs[index]
        else:
            raise ValueError("cannot evaluate node kind %r" % (node.kind,))
        cache[key] = out
        return out

    outs = []
    for h in sym._heads():
        n = _node_num_outputs(h)
        if n > 1 and h.kind == "op" and sym.kind != "group":
            outs.extend(value(h, i) for i in range(n))
        else:
            outs.append(value(h, h.index if h.kind == "slice" else 0))
    return outs


# ------------------------------------------------------------------ Executor
def _grads(sym, env, wrt, cotangents=None, aux_updates=None):
    """Outputs and ``{name: grad}`` of ``wrt`` (tensors, updated nowhere)
    for one training-mode forward over ``env`` with the given cotangents
    (ones where None: the reference's ``out_grads=None``).  An input the
    outputs do not reach gets zeros."""
    leaves = {n: t.detach().requires_grad_(True) for n, t in wrt.items()}
    with torch.enable_grad():
        outs = _eval_symbol(sym, dict(env, **leaves), True, aux_updates)
        cts = [torch.ones_like(o) for o in outs] if cotangents is None \
            else list(cotangents)
        pairs = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], list(leaves.values()),
            [c for _, c in pairs], allow_unused=True) if pairs \
            else [None] * len(leaves)
    res = {n: torch.zeros_like(leaves[n]) if g is None else g
           for n, g in zip(leaves, grads)}
    return [o.detach() for o in outs], res


class Executor:
    """A bound graph (reference ``include/mxnet/executor.h``):
    ``forward`` interprets it, ``backward`` takes the gradients of one
    training-mode forward with ``torch.autograd.grad``, and
    ``fused_step_fn`` builds the symbolic Module's fused train step."""

    def __init__(self, sym, device, args, args_grad, grad_req, aux):
        self._symbol = sym
        self._device = device
        self.arg_dict = dict(args or {})
        self.grad_dict = dict(args_grad or {})
        self.aux_dict = dict(aux or {})
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in self.arg_dict}
        self.grad_req = grad_req
        self.outputs = []
        self._fused_cache = {}

    def _env(self):
        env = {n: v._data for n, v in self.arg_dict.items()}
        env.update({n: v._data for n, v in self.aux_dict.items()})
        return env

    @property
    def arg_arrays(self):
        return [self.arg_dict.get(n) for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self.aux_dict.get(n)
                for n in self._symbol.list_auxiliary_states()]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n)
                for n in self._symbol.list_arguments()]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def _feed_inputs(self, input_map):
        """Assign forward inputs by name (NDArrays as they are, anything
        else copied onto the executor's device)."""
        from ..ndarray.ndarray import NDArray, _wrap, array
        for n, v in input_map.items():
            arr = v._data if isinstance(v, NDArray) else \
                array(v, ctx=self._device)._data
            if n in self.arg_dict:
                self.arg_dict[n]._data = arr
            else:
                self.arg_dict[n] = _wrap(arr)

    def forward(self, is_train=False, **kwargs):
        self._feed_inputs(kwargs)
        aux_updates = {}
        with torch.no_grad():
            outs = _eval_symbol(self._symbol, self._env(), bool(is_train),
                                aux_updates)
        for n, v in aux_updates.items():
            if n in self.aux_dict:
                self.aux_dict[n]._data = v
        from ..ndarray.ndarray import _wrap
        self.outputs = [_wrap(o) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients into ``grad_dict`` per ``grad_req`` (``write`` or
        ``add``), from a training-mode forward of the bound values;
        ``out_grads`` None means ones (reference semantics)."""
        from ..ndarray.ndarray import NDArray, _wrap
        wrt = sorted(n for n in self.arg_dict
                     if self.grad_req.get(n, "null") != "null"
                     and self.arg_dict[n]._data.is_floating_point())
        if not wrt:
            return
        if out_grads is not None:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            out_grads = [g._data if isinstance(g, NDArray)
                         else torch.as_tensor(g, device=self._device)
                         for g in out_grads]
        env = self._env()
        _, grads = _grads(self._symbol, {n: v for n, v in env.items()
                                         if n not in wrt},
                          {n: env[n] for n in wrt}, out_grads)
        for n in wrt:
            tgt = self.grad_dict.get(n)
            if tgt is None:
                self.grad_dict[n] = _wrap(grads[n])
            elif self.grad_req.get(n) == "add":
                tgt._data = tgt._data + grads[n]
            else:
                tgt._data = grads[n]

    def fused_step_fn(self, wrt, optimizer, feed_sig):
        """The symbolic Module's fused train step for trainable names
        ``wrt`` (the counterpart of the reference's one jitted program;
        here one Python function a step).  Cached per (optimizer,
        rescale_grad, clip_gradient, wrt, feed signature, config epoch):
        a knob flip builds a new one.  Each build counts
        ``fused_compiles``.

        The returned ``fn(feeds, opt_state, t, lrs, wds) -> (outputs,
        aux_updates)`` runs the forward under autograd with the bound
        values and ``feeds``, takes the gradients with ones cotangents,
        applies ``rescale_grad`` and clipping, and updates each parameter
        and its state IN PLACE: the f32 ones through one
        ``optimizer.step_fused_multi`` call (one launch of the fused
        kernel, K3 for Adam and K1 for SGD, with an f32 cast: the master
        itself) when
        ``kernels.fused_step_enabled(optimizer)``, each tensor counted on
        ``kernels.fused_step``; the others through ``optimizer.step``."""
        from .. import kernels as _kernels
        from ..optimizer.optimizer import _state_write
        wrt_t = tuple(wrt)
        rescale = float(optimizer.rescale_grad)
        clip = optimizer.clip_gradient
        key = (id(optimizer), rescale, clip, wrt_t, feed_sig,
               _config.epoch())
        fn = self._fused_cache.get(key)
        if fn is not None:
            return fn
        self._fused_cache = {k: v for k, v in self._fused_cache.items()
                             if k[-1] == key[-1]}
        fused_opt = _kernels.fused_step_enabled(optimizer)
        sym = self._symbol
        # the cached step keeps its optimizer alive, so id() stays unique
        keep = optimizer

        def run(feeds, opt_state, t, lrs, wds):
            env = self._env()
            env.update(feeds)
            params = {n: env.pop(n) for n in wrt_t}
            aux_updates = {}
            outs, grads = _grads(sym, env, params, None, aux_updates)
            fused = ([], [], [], [], [])
            with torch.no_grad():
                for i, n in enumerate(wrt_t):
                    w, g = params[n], grads[n]
                    if rescale != 1.0:
                        g = g * rescale
                    if clip is not None:
                        g = torch.clamp(g, -clip, clip)
                    state = opt_state[n]
                    if fused_opt and w.dtype == torch.float32:
                        for col, x in zip(fused, (w, g, state, lrs[i],
                                                  wds[i])):
                            col.append(x)
                        continue
                    new_w, new_s = keep.step(w, g, state, lrs[i], wds[i], t)
                    w.copy_(new_w)
                    _state_write(state, new_s)
                if fused[0]:
                    keep.step_fused_multi(*fused, t)
                    for _ in fused[0]:
                        _kernels.note_fused_step()
            return outs, {n: v.detach() for n, v in aux_updates.items()}

        self._fused_cache[key] = run
        _telemetry.counter("fused_compiles").inc()
        return run

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays (each keeps its device and
        dtype)."""
        for pool, src, what in ((self.arg_dict, arg_params, "argument"),
                                (self.aux_dict, aux_params, "aux state")):
            for n, v in (src or {}).items():
                if n in pool:
                    pool[n]._data = _copy_onto(v, pool[n]._data)
                elif not allow_extra_params:
                    raise ValueError("unknown %s %r" % (what, n))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """Re-bind with new input shapes: named arrays are new zeros, the
        others are shared."""
        from ..ndarray.ndarray import _wrap
        new_args = {n: _wrap(torch.zeros(tuple(kwargs[n]),
                                         dtype=v._data.dtype,
                                         device=v._data.device))
                    if n in kwargs else v for n, v in self.arg_dict.items()}
        return Executor(self._symbol, self._device, new_args,
                        dict(self.grad_dict), self.grad_req,
                        dict(self.aux_dict))

    def set_monitor_callback(self, callback, monitor_all=False):
        raise NotImplementedError("executor monitor callbacks are not "
                                  "ported")


def _copy_onto(v, like):
    """``v`` (an NDArray, tensor or array-like) as a new tensor with
    ``like``'s dtype and device."""
    t = getattr(v, "_data", v)
    t = t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(
        _np.asarray(t))
    return t.to(device=like.device, dtype=like.dtype, copy=True)
