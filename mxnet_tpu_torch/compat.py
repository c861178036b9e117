"""Apache MXNet's own model files: the binary ``.params`` and the NNVM
graph ``symbol.json`` (counterpart of ``mxnet_tpu.compat``).

``mx.nd.load``, ``mx.sym.load`` / ``load_json`` and with them
``mx.model.load_checkpoint`` read both transparently, and
``HybridBlock.export(fmt="mxnet")`` writes both, so a checkpoint moves
between Apache MXNet, the JAX package and this one.

The formats:

* ``.params`` — ``src/ndarray/ndarray.cc:1840`` NDArray::Save(list):
  ``uint64 0x112 | uint64 reserved | uint64 count | count x NDArray |
  names``, where each NDArray is ``uint32 magic`` (V2 0xF993fac9 / V3
  0xF993faca: ``int32 stype``, shape, context, ``int32 dtype``, raw
  bytes; V1 0xF993fac8 and the ancient magic==ndim layouts are also
  handled), a shape is ``int32 ndim + int64[ndim]`` (ancient:
  ``uint32[ndim]``), a context is ``int32 dev_type + int32 dev_id``,
  and names serialize as ``uint64 n | n x (uint64 len + bytes)``.
* ``symbol.json`` — the NNVM graph JSON (``nodes`` with ``op``/``name``/
  ``attrs``/``inputs`` triplets, ``arg_nodes``, ``heads``): replayed
  through this package's ``mx.sym`` builders, with the string-typed
  attrs literal-parsed.
"""
from __future__ import annotations

import ast
import json
import struct

import numpy as _np

__all__ = ["load_mxnet_params", "load_mxnet_symbol", "is_mxnet_params",
           "is_mxnet_symbol_json", "save_mxnet_params",
           "save_mxnet_symbol", "MXNET_PARAMS_MAGIC"]

MXNET_PARAMS_MAGIC = 0x112
_ND_V1 = 0xF993FAC8
_ND_V2 = 0xF993FAC9
_ND_V3 = 0xF993FACA

_TYPE_FLAG_TO_NP = {0: _np.float32, 1: _np.float64, 2: _np.float16,
                    3: _np.uint8, 4: _np.int32, 5: _np.int8, 6: _np.int64,
                    7: _np.bool_}


class _Reader:
    __slots__ = ("b", "o")

    def __init__(self, data):
        self.b = data
        self.o = 0

    def read(self, fmt):
        vals = self.read_tuple(fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_tuple(self, fmt):
        try:
            vals = struct.unpack_from("<" + fmt, self.b, self.o)
        except struct.error as e:
            raise ValueError("truncated MXNet params file: %s" % e)
        self.o += struct.calcsize("<" + fmt)
        return vals

    def bytes(self, n):
        out = self.b[self.o:self.o + n]
        if len(out) != n:
            raise ValueError("truncated MXNet params file")
        self.o += n
        return out


def is_mxnet_params(head):
    """True when the first bytes carry the reference list magic 0x112."""
    return len(head) >= 8 and \
        struct.unpack_from("<Q", head, 0)[0] == MXNET_PARAMS_MAGIC


def _read_shape(r):
    ndim = r.read("i")
    if ndim < 0:
        return None
    return r.read_tuple("%dq" % ndim) if ndim else ()


def _read_one(r):
    magic = r.read("I")
    if magic in (_ND_V2, _ND_V3):
        stype = r.read("i")
        if stype != 0:  # kDefaultStorage
            raise NotImplementedError(
                "MXNet params import: sparse storage type %d is not "
                "supported (dense checkpoints only)" % stype)
        shape = _read_shape(r)
    elif magic == _ND_V1:
        shape = _read_shape(r)
    else:
        # ancient layout: the magic word IS ndim, dims are uint32
        ndim = magic
        if ndim > 32:
            raise ValueError("not an MXNet NDArray record (magic 0x%x)"
                             % magic)
        shape = r.read_tuple("%dI" % ndim) if ndim else ()
    # none-array detection per version (reference Load): V3 signals none
    # with ndim=-1 and a 0-d shape is a REAL np scalar; every other
    # version signals none with ndim=0, writing nothing further
    if shape is None:
        return None
    if magic != _ND_V3 and len(shape) == 0:
        return None
    r.read("ii")  # context dev_type, dev_id — placement is ours to choose
    type_flag = r.read("i")
    dt = _TYPE_FLAG_TO_NP.get(type_flag)
    if dt is None:
        raise NotImplementedError(
            "MXNet params import: unknown dtype flag %d" % type_flag)
    count = 1
    for s in shape:
        count *= s
    raw = r.bytes(count * _np.dtype(dt).itemsize)
    return _np.frombuffer(raw, dt).reshape(shape).copy()


def load_mxnet_params(data):
    """Parse a reference ``.params`` payload.

    Named saves return ``{name: numpy array}`` with the ``arg:``/``aux:``
    prefixes exactly as written (the reference save_checkpoint
    convention); anonymous list saves return a plain list — the same
    shape the reference's own ``mx.nd.load`` hands back."""
    r = _Reader(data)
    header = r.read("Q")
    if header != MXNET_PARAMS_MAGIC:
        raise ValueError("not an MXNet params file (header 0x%x)" % header)
    r.read("Q")  # reserved
    n = r.read("Q")
    arrays = [_read_one(r) for _ in range(n)]
    n_names = r.read("Q")
    names = []
    for _ in range(n_names):
        ln = r.read("Q")
        names.append(r.bytes(ln).decode())
    if not names:
        return [a for a in arrays if a is not None]
    if len(names) != len(arrays):
        raise ValueError("corrupt MXNet params file: %d names for %d "
                         "arrays" % (len(names), len(arrays)))
    return {k: v for k, v in zip(names, arrays) if v is not None}


# ------------------------------------------------------------------ save

_NP_TO_TYPE_FLAG = {_np.dtype(v): k for k, v in _TYPE_FLAG_TO_NP.items()}


def save_mxnet_params(fname, data):
    """Write arrays in the reference ``.params`` wire format (V2 records
    inside the 0x112 list container) so the file loads in real Apache
    MXNet.  ``data`` is a dict (names saved verbatim — use ``arg:``/
    ``aux:`` prefixes for checkpoint pairs) or a list (anonymous save)."""
    import torch
    from .ndarray.ndarray import NDArray

    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[n] for n in names]
    else:
        names, arrays = [], list(data)

    def host(a):
        if isinstance(a, NDArray):
            return a.asnumpy()
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return _np.asarray(a)

    out = [struct.pack("<QQQ", MXNET_PARAMS_MAGIC, 0, len(arrays))]
    for a in arrays:
        a = _np.asarray(host(a))
        if a.ndim:  # ascontiguousarray would promote 0-d to 1-d
            a = _np.ascontiguousarray(a)
        flag = _NP_TO_TYPE_FLAG.get(a.dtype)
        if flag is None:
            raise NotImplementedError(
                "MXNet params export: dtype %s has no reference type flag "
                "(cast to float32/int32 first)" % a.dtype)
        # a 0-d record must use the V3 (np-shape) layout: every older
        # version reads ndim=0 as a none-array marker and stops
        magic = _ND_V3 if a.ndim == 0 else _ND_V2
        rec = struct.pack("<Ii", magic, 0)           # kDefaultStorage
        rec += struct.pack("<i", a.ndim)
        rec += struct.pack("<%dq" % a.ndim, *a.shape) if a.ndim else b""
        rec += struct.pack("<iii", 1, 0, flag)       # cpu(0) ctx + dtype
        rec += a.tobytes()
        out.append(rec)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode()
        out.append(struct.pack("<Q", len(b)) + b)
    payload = b"".join(out)
    if fname is None:
        return payload
    from .base import atomic_write
    with atomic_write(fname, "wb") as f:
        f.write(payload)
    return fname


def save_mxnet_symbol(sym):
    """Serialize a Symbol into the reference's NNVM graph JSON schema
    (nodes with string attrs, [id, idx, version] input triplets,
    arg_nodes, heads) so real Apache MXNet can load it.  Only graphs made
    of reference-named ops export — ops the reference lacks raise."""
    from .symbol.symbol import (_topo, _unwrap_slice, _node_num_outputs,
                                Symbol)

    # annotation attrs real MXNet only reads in their dunder form
    _ANNO = ("lr_mult", "wd_mult", "ctx_group", "force_mirroring",
             "init", "shape", "dtype")

    def dunder(k):
        return "__%s__" % k if k in _ANNO and not k.startswith("__") else k

    nodes = _topo(sym)
    nid = {}
    out_nodes = []
    for n in nodes:
        if n.kind == "slice":
            # a slice node is an output selector, not a reference node:
            # consumers reference [base_id, index]
            nid[id(n)] = nid[id(n.inputs[0])]
            continue
        ins = []
        for x in n.inputs:
            if x is None:
                continue  # a no_bias slot: the reference omits the input
            if not isinstance(x, Symbol):
                raise NotImplementedError(
                    "MXNet symbol export: node %r captures a constant "
                    "array; the NNVM schema has no constant inputs — "
                    "bind it as a Variable instead" % n.name)
            base, idx = _unwrap_slice(x)
            ins.append([nid[id(base)], idx, 0])
        nid[id(n)] = len(out_nodes)
        entry = {"op": "null" if n.kind == "var" else n.op,
                 "name": n.name, "inputs": ins}
        if n.kind == "var":
            # var attrs are Variable shape/dtype hints -> dunder
            # annotations (real MXNet reads __shape__/__dtype__)
            attrs = {dunder(k): str(v) for k, v in (n.attrs or {}).items()
                     if v is not None}
        else:
            # op attrs are REQUIRED parameters (Reshape shape, Cast
            # dtype, ...) and export verbatim as strings
            attrs = {k: str(v) for k, v in (n.attrs or {}).items()
                     if v is not None}
        attrs.update({dunder(k): str(v) for k, v in n._attr_map.items()})
        if attrs:
            entry["attrs"] = attrs
        out_nodes.append(entry)
    heads = []
    for h in sym._heads():
        base, idx = _unwrap_slice(h)
        n_out = _node_num_outputs(base)
        if h.kind != "slice" and base.kind == "op" and n_out > 1:
            # a bare multi-output head exposes EVERY output, matching
            # list_outputs' expansion
            heads.extend([nid[id(base)], i, 0] for i in range(n_out))
        else:
            heads.append([nid[id(base)], idx, 0])
    arg_nodes = [i for i, e in enumerate(out_nodes) if e["op"] == "null"]
    return json.dumps({
        "nodes": out_nodes,
        "arg_nodes": arg_nodes,
        "node_row_ptr": list(range(len(out_nodes) + 1)),
        "heads": heads,
        "attrs": {"mxnet_version": ["int", 10600]},
    }, indent=2)


# ------------------------------------------------------------ symbol.json

def is_mxnet_symbol_json(text):
    """The reference graph JSON always carries arg_nodes + nodes."""
    return '"arg_nodes"' in text and '"nodes"' in text


def _parse_attr(v):
    """Reference attrs are strings ('(3, 3)', 'True', '0.5', 'relu')."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def load_mxnet_symbol(text):
    """Rebuild a reference symbol.json as a native Symbol by replaying
    each node through this framework's op builders."""
    from . import symbol as sym_mod

    g = json.loads(text)
    nodes = g["nodes"]
    built = []  # one entry per node: Symbol or list of head Symbols
    for node in nodes:
        op = node.get("op", "null")
        name = node["name"]
        # schema drift across reference versions: v0 splits op params
        # ("param") from annotations ("attr"); later versions merge both
        # into "attrs" — union them all
        raw = {}
        for key in ("param", "attrs", "attr"):
            raw.update(node.get(key) or {})
        attrs = {k: _parse_attr(v) for k, v in raw.items()}
        if op == "null":
            v = sym_mod.Variable(name)
            # reference var attrs (__shape__/__init__/__lr_mult__...) are
            # annotations; carry them for attr()/attr_dict parity
            v._attr_map.update({k: str(a) for k, a in attrs.items()})
            built.append(v)
            continue
        # annotations (ctx_group / lr_mult / wd_mult / __dunder__) ride in
        # the same dict as op params in the reference JSON; route them to
        # the attr map, not the op builder
        anno = {k: str(v) for k, v in attrs.items()
                if k in ("ctx_group", "lr_mult", "wd_mult")
                or k.endswith(("_lr_mult", "_wd_mult"))
                or k.startswith("__")}
        op_attrs = {k: v for k, v in attrs.items() if k not in anno}
        ins = []
        for ref in node.get("inputs", []):
            src, out_idx = ref[0], ref[1]
            s = built[src]
            if isinstance(s, sym_mod.Symbol) and out_idx > 0:
                s = s[out_idx]
            ins.append(s)
        try:
            builder = getattr(sym_mod, op)
        except AttributeError:
            raise NotImplementedError(
                "MXNet symbol import: op %r is not registered here" % op)
        out = builder(*ins, name=name, **op_attrs)
        if anno and isinstance(out, sym_mod.Symbol):
            out._attr_map.update(anno)
        built.append(out)
    heads = []
    for ref in g.get("heads", []):
        s = built[ref[0]]
        idx = ref[1] if len(ref) > 1 else 0
        if idx > 0:
            s = s[idx]
        heads.append(s)
    if not heads:
        heads = [built[-1]]
    return heads[0] if len(heads) == 1 else sym_mod.Group(heads)
