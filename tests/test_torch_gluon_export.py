"""``summary()``, ``HybridBlock.export`` and ``SymbolBlock`` held
against the reference on the CPU.  ``export`` writes the JAX package's
graph JSON and ``arg:``/``aux:`` params; the pair loads through
``SymbolBlock.imports`` in either package, and the imported block's
logits equal the block's within EXPORT_RTOL (the same ops, f32; the
packages sum in different orders).  ``summary()``'s text is the
reference's to the character."""
import contextlib
import io

import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu_torch as mt

import _torch_gluon as G
from test_torch_gluon_persistence import _pair, _small, _x

EXPORT_RTOL = 1e-5


def _summary_text(pkg, block, x):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        with (mt.cpu() if pkg is mt else ref.cpu()):
            block.summary(pkg.nd.array(x))
    return buf.getvalue()


@pytest.mark.parametrize("net", ["small", "resnet18_v1"])
def test_summary_text_matches_reference(net):
    if net == "small":
        rb, pb = _pair()
        x = _x(2, 3, 8, 8)
    else:
        rb, pb = _pair(lambda p: p.gluon.model_zoo.vision.get_model(
            "resnet18_v1", classes=10), (1, 3, 32, 32))
        x = _x(1, 3, 32, 32)
    got = _summary_text(mt, pb, x)
    want = _summary_text(ref, rb, x)
    assert got == want
    assert "Total params" in got


def _export(pkg, block, path):
    with (mt.cpu() if pkg is mt else ref.cpu()):
        return block.export(path, epoch=3)


def _imports(pkg, prefix):
    with (mt.cpu() if pkg is mt else ref.cpu()):
        return pkg.gluon.SymbolBlock.imports(
            prefix + "-symbol.json", ["data"], prefix + "-0003.params",
            ctx=mt.cpu() if pkg is mt else ref.cpu())


EXPORT_NETS = {
    "small": (_small, (2, 3, 8, 8)),
    "mobilenet0.25": (lambda p: p.gluon.model_zoo.vision.get_model(
        "mobilenet0.25", classes=10), (1, 3, 32, 32)),
}


@pytest.mark.parametrize("net", sorted(EXPORT_NETS))
@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("port", "ref"),
                                           ("ref", "port")])
def test_export_then_symbolblock_imports(tmp_path, net, writer, reader):
    make, shape = EXPORT_NETS[net]
    rb, pb = _pair(make, shape)
    x = _x(*shape, seed=4)
    want = G.run(G.ref, rb, [x], None, training=False, grads=False)[0][0]
    prefix = str(tmp_path / "model")
    src_pkg, src = (mt, pb) if writer == "port" else (ref, rb)
    files = _export(src_pkg, src, prefix)
    assert files == [prefix + "-symbol.json", prefix + "-0003.params"]
    dst_pkg = mt if reader == "port" else ref
    blk = _imports(dst_pkg, prefix)
    got = G.run(dst_pkg, blk, [x], None, training=False, grads=False)[0][0]
    G.close(got, want, EXPORT_RTOL, "logits")


def test_symbolblock_trains_through_the_tape(tmp_path):
    """An imported graph under record(): gradients reach its Parameters,
    and a training-mode forward moves the BatchNorm statistics."""
    _, pb = _pair()
    prefix = str(tmp_path / "model")
    _export(mt, pb, prefix)
    blk = _imports(mt, prefix)
    params = blk.collect_params()
    aux = [n for n, p in params.items() if p.grad_req == "null"]
    assert aux and all(n.endswith(("running_mean", "running_var"))
                       for n in aux)
    before = {n: params[n].data().asnumpy().copy() for n in aux}
    with mt.cpu():
        x = mt.nd.array(_x(2, 3, 8, 8))
        with mt.autograd.record():
            y = blk(x)
        y.backward()
    for n, p in params.items():
        if p.grad_req != "null":
            assert p.grad().asnumpy().any(), n
    assert any(not np.array_equal(before[n], params[n].data().asnumpy())
               for n in aux)


def test_export_mxnet_format_raises(tmp_path):
    """``fmt="mxnet"`` writes Apache MXNet's files (compat; held against
    the reference in ``tests/test_torch_compat.py``); an unknown format
    raises."""
    _, pb = _pair()
    files = pb.export(str(tmp_path / "m"), fmt="mxnet")
    assert mt.compat.is_mxnet_symbol_json(open(files[0]).read())
    assert mt.compat.is_mxnet_params(open(files[1], "rb").read(8))
    with pytest.raises(ValueError):
        pb.export(str(tmp_path / "m"), fmt="onnx")
