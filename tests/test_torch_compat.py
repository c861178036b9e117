"""Apache MXNet's file formats (``compat``) held against the reference's
readers and writers, on the CPU.

* ``.params``: for the same arrays the port's writer gives the reference
  writer's bytes (dict and list saves, every dtype with a type flag, a
  0-d array); each package's ``nd.load`` reads the other's files, and
  both parse the older NDArray record layouts alike.
* ``symbol.json``: a graph built with every node named serializes to the
  reference's JSON, parsed; each package reads the other's.
* ``export(fmt="mxnet")`` of a zoo network: the same JSON as the
  reference's export up to the op nodes' auto names (the packages name
  them differently), the same ``.params`` bytes, and
  ``model.load_checkpoint`` into a ``SymbolBlock`` gives the source
  network's logits bitwise.
"""
import json
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import compat as jcompat
from mxnet_tpu import name as jname

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import compat as tcompat
from mxnet_tpu_torch import name as tname


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _arrays():
    rng = np.random.RandomState(0)
    return {"arg:w": rng.randn(3, 4).astype(np.float32),
            "arg:h": rng.randn(5).astype(np.float16),
            "aux:i": rng.randint(-9, 9, (2, 2)).astype(np.int32),
            "u8": rng.randint(0, 255, (4,)).astype(np.uint8),
            "i8": rng.randint(-9, 9, (4,)).astype(np.int8),
            "d": rng.randn(2).astype(np.float64),
            "scalar": np.array(2.5, np.float32)}


def _nd(lib, v):
    return lib.nd.array(v, dtype=v.dtype)


@pytest.mark.parametrize("form", ["dict", "list"])
def test_params_writer_bytes_match_the_reference(form):
    vals = _arrays()
    if form == "dict":
        ref = {k: _nd(jmx, v) for k, v in vals.items()
               if v.dtype != np.float64}
        port = {k: _nd(mt, v) for k, v in vals.items()
                if v.dtype != np.float64}
        # float64 through numpy on both sides (the packages' arrays are
        # 32-bit)
        ref["d"] = port["d"] = vals["d"]
    else:
        ref = [_nd(jmx, v) for v in list(vals.values())[:3]]
        port = [_nd(mt, v) for v in list(vals.values())[:3]]
    assert tcompat.save_mxnet_params(None, port) \
        == jcompat.save_mxnet_params(None, ref)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_params(writer, tmp_path):
    vals = {k: v for k, v in _arrays().items() if v.dtype != np.float64}
    fname = str(tmp_path / "m.params")
    src, dst = (mt, jmx) if writer == "port" else (jmx, mt)
    (tcompat if writer == "port" else jcompat).save_mxnet_params(
        fname, {k: _nd(src, v) for k, v in vals.items()})
    got = dst.nd.load(fname)
    assert sorted(got) == sorted(vals)
    for k, v in vals.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
        assert got[k].asnumpy().dtype == v.dtype


def _record(magic, shape, dtype_flag, payload, ancient=False):
    if ancient:
        rec = struct.pack("<I", len(shape))
        rec += struct.pack("<%dI" % len(shape), *shape)
    else:
        rec = struct.pack("<I", magic)
        if magic != 0xF993FAC8:
            rec += struct.pack("<i", 0)
        rec += struct.pack("<i", len(shape))
        rec += struct.pack("<%dq" % len(shape), *shape)
    return rec + struct.pack("<iii", 1, 0, dtype_flag) + payload


def test_older_record_layouts_parse_alike():
    """V1 (no storage type) and the ancient layout (the magic word is
    ndim, uint32 dims), anonymous list save: both packages parse the
    same arrays."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(4, dtype=np.int32)
    blob = struct.pack("<QQQ", 0x112, 0, 2)
    blob += _record(0xF993FAC8, a.shape, 0, a.tobytes())
    blob += _record(None, b.shape, 4, b.tobytes(), ancient=True)
    blob += struct.pack("<Q", 0)
    for parse in (tcompat.load_mxnet_params, jcompat.load_mxnet_params):
        got = parse(blob)
        np.testing.assert_array_equal(got[0], a)
        np.testing.assert_array_equal(got[1], b)
    with pytest.raises(ValueError):
        tcompat.load_mxnet_params(blob[:40])


def _graph(lib):
    s = lib.sym
    data = s.Variable("data")
    c = s.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                      name="conv")
    b = s.BatchNorm(c, name="bn")
    a = s.Activation(b, act_type="relu", name="relu")
    p = s.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool")
    f = s.Flatten(p, name="flat")
    fc = s.FullyConnected(f, num_hidden=3, name="fc")
    return s.SoftmaxOutput(fc, s.Variable("softmax_label"), name="softmax")


def test_symbol_json_matches_the_reference():
    assert json.loads(tcompat.save_mxnet_symbol(_graph(mt))) \
        == json.loads(jcompat.save_mxnet_symbol(_graph(jmx)))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_symbol(writer):
    text = (tcompat if writer == "port" else jcompat).save_mxnet_symbol(
        _graph(mt if writer == "port" else jmx))
    for lib in (mt, jmx):
        sym = lib.sym.load_json(text)
        assert sym.list_arguments() == _graph(lib).list_arguments()
        assert sym.list_auxiliary_states() == \
            _graph(lib).list_auxiliary_states()
    _, out, _ = mt.sym.load_json(text).infer_shape(data=(2, 3, 8, 8))
    assert out == [(2, 3)]


def _zoo(lib, manager):
    with manager():
        net = lib.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                     thumbnail=True)
    return net


def _strip_op_names(text):
    g = json.loads(text)
    for n in g["nodes"]:
        if n["op"] != "null":
            n["name"] = None
    return g


def test_export_mxnet_round_trips_bitwise(tmp_path):
    tnet = _zoo(mt, tname.NameManager)
    tnet.initialize(mt.init.Xavier(), ctx=mt.cpu())
    x = np.random.RandomState(2).uniform(size=(2, 3, 32, 32)).astype(
        np.float32)
    want = tnet(mt.nd.array(x)).asnumpy()
    jnet = _zoo(jmx, jname.NameManager)
    jnet.initialize(jmx.init.Zero())
    jnet(jmx.nd.array(x))
    for n, p in tnet.collect_params().items():
        jnet.collect_params()[n].set_data(jmx.nd.array(p.data().asnumpy()))
    tfiles = tnet.export(str(tmp_path / "port"), 3, fmt="mxnet")
    jfiles = jnet.export(str(tmp_path / "ref"), 3, fmt="mxnet")
    assert _strip_op_names(open(tfiles[0]).read()) \
        == _strip_op_names(open(jfiles[0]).read())
    assert open(tfiles[1], "rb").read() == open(jfiles[1], "rb").read()
    # the port's files back into a SymbolBlock: the source's logits
    sym, arg, aux = mt.model.load_checkpoint(str(tmp_path / "port"), 3)
    block = mt.gluon.SymbolBlock(sym, mt.sym.Variable("data"))
    params = block.collect_params()
    for n, v in list(arg.items()) + list(aux.items()):
        params[n]._load_init(v, mt.cpu())    # Apache MXNet's own idiom
    got = block(mt.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(got, want)
    imported = mt.gluon.SymbolBlock.imports(tfiles[0], "data", tfiles[1],
                                            ctx=mt.cpu())
    np.testing.assert_array_equal(imported(mt.nd.array(x)).asnumpy(), want)
    # and the reference reads them
    jsym, jarg, _ = jmx.model.load_checkpoint(str(tmp_path / "port"), 3)
    assert jsym.list_arguments() == sym.list_arguments()
    np.testing.assert_array_equal(
        jarg["resnetv10_conv0_weight"].asnumpy(),
        arg["resnetv10_conv0_weight"].asnumpy())


def test_export_rejects_an_unknown_format(tmp_path):
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    with pytest.raises(ValueError, match="fmt"):
        net.export(str(tmp_path / "x"), fmt="onnx")
