"""``mx.rtc`` (K7) on the CPU: signature parsing, the ``kernelParams``
marshalling, the errors, ``register_op``, and the counterparts of
``tests/test_rtc_pallas.py``'s three user-kernel tests.

The package has no CPU route for user source.  Here only the
compile-and-launch layer (``ops/_cudart``: NVRTC, the driver, the launch
device) is replaced, by :class:`FakeCudart` below: it records what it is
asked to compile, and "launches" a kernel by running a numpy emulation
of its CUDA source over the ``kernelParams`` array ``rtc`` marshalled,
reading each argument through its pointer.  What reaches the layer
(grids, blocks, shared memory, the pointers and scalar bits) is thereby
checked.  On the H100 ``chip_smoke.py`` phase 7 compiles and runs the
same kernels through NVRTC, bitwise against their plain expressions::

    extern "C" __global__ void doubler(const float* x, float* y, int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] = x[i] * 2.0f;
    }
    extern "C" __global__ void add_one(const float* x, float* y, int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] = x[i] + 1.0f;
    }
    // one block per tile of blockDim.y rows x blockDim.x columns
    extern "C" __global__ void block_scale(const float* x, float* y,
                                           int rows, int cols) {
      int c = blockIdx.x * blockDim.x + threadIdx.x;
      int r = blockIdx.y * blockDim.y + threadIdx.y;
      if (r < rows && c < cols) y[r * cols + c] = x[r * cols + c] * 4.0f;
    }

Tolerance: exact (the emulations compute the plain expressions in f32).
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, rtc
from mxnet_tpu_torch.ops import _cudart
from mxnet_tpu_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = __doc__
LAUNCH_DEVICE = rtc._launch_device


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


# ------------------------------------------------------------ the double
def _ptr(params, i):
    return ctypes.c_void_p.from_address(params[i]).value


def _int(params, i):
    return ctypes.c_int.from_address(params[i]).value


def _f32(addr, n):
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(addr))


def _threads(grid, block, axis):
    return np.arange(grid[axis] * block[axis])


def _elementwise(fn):
    def run(grid, block, params):
        n = _int(params, 2)
        i = _threads(grid, block, 0)
        i = i[i < n]
        _f32(_ptr(params, 1), n)[i] = fn(_f32(_ptr(params, 0), n)[i])
    return run


def _block_scale(grid, block, params):
    rows, cols = _int(params, 2), _int(params, 3)
    c = _threads(grid, block, 0)
    r = _threads(grid, block, 1)
    c, r = c[c < cols], r[r < rows]
    x = _f32(_ptr(params, 0), rows * cols).reshape(rows, cols)
    y = _f32(_ptr(params, 1), rows * cols).reshape(rows, cols)
    y[np.ix_(r, c)] = x[np.ix_(r, c)] * np.float32(4.0)


EMULATED = {"doubler": _elementwise(lambda x: x * np.float32(2.0)),
            "add_one": _elementwise(lambda x: x + np.float32(1.0)),
            "block_scale": _block_scale}


class FakeCudart:
    """``ops/_cudart`` for the CPU: compiles nothing, loads nothing, and
    runs :data:`EMULATED` kernels over the marshalled ``kernelParams``."""

    def __init__(self):
        self.programs, self.launches, self.shared = [], [], {}
        self.lookups = []

    def compile_program(self, source, name, options=(), exprs=()):
        self.programs.append((source, name, tuple(options), tuple(exprs)))
        return b"cubin", {e: "_lowered_" + e for e in exprs}, ""

    def current_device(self):
        return 0

    def current_stream(self, device):
        return 0

    def load_module(self, image, ordinal):
        return 1

    def get_function(self, module, name):
        self.lookups.append(name)
        known = name in EMULATED or name.startswith("_lowered_")
        return name if known else None

    def set_max_dynamic_shared(self, fn, nbytes):
        self.shared[fn] = nbytes

    def launch(self, fn, ordinal, grid, block, shared_mem, stream, params):
        self.launches.append((fn, grid, block, shared_mem))
        EMULATED[fn](grid, block, params)


@pytest.fixture
def fake(monkeypatch):
    """The double, with launches on the CPU (the launch device is part of
    the replaced layer)."""
    double = FakeCudart()
    monkeypatch.setattr(rtc, "_cudart", double)
    monkeypatch.setattr(rtc, "_launch_device", lambda ctx: torch.device("cpu"))
    rtc.reset_launches()
    return double


def _module(**kw):
    return rtc.CudaModule(SOURCE, **kw)


# ----------------------------------------------------- signature parsing
@pytest.mark.parametrize("signature,want", [
    ("const float *x, float *y, int n",
     [("x", "float", True, True), ("y", "float", True, False),
      ("n", "int", False, False)]),
    ("const float*, float*, int",
     [("arg0", "float", True, True), ("arg1", "float", True, False),
      ("arg2", "int", False, False)]),
    ("const   __nv_bfloat16*x,__nv_bfloat16 * y , __nv_bfloat16 a",
     [("x", "__nv_bfloat16", True, True), ("y", "__nv_bfloat16", True, False),
      ("a", "__nv_bfloat16", False, False)]),
    ("const int64_t n", [("n", "int64_t", False, True)]),
    ("", []),
], ids=["named", "unnamed", "spacing", "const-scalar", "empty"])
def test_parse_signature(signature, want):
    assert rtc.parse_signature(signature) == [rtc.Arg(*w) for w in want]


@pytest.mark.parametrize("ctype", sorted(rtc._TYPES))
def test_parse_signature_every_type(ctype):
    args = rtc.parse_signature("const %s *p, %s *q, %s v" % ((ctype,) * 3))
    assert [(a.ctype, a.is_tensor, a.is_const) for a in args] == [
        (ctype, True, True), (ctype, True, False), (ctype, False, False)]


@pytest.mark.parametrize("signature", ["float x y", "half *x", "float **x",
                                       "const", "float *x,"])
def test_parse_signature_rejects(signature):
    with pytest.raises(ValueError, match="signature"):
        rtc.parse_signature(signature)


# ----------------------------------------------------------- marshalling
def test_marshal_kernel_params_layout():
    """``kernelParams`` holds a pointer to each argument's value: device
    pointers as 64-bit values, each scalar as its C type (f16 and bf16 as
    their 16-bit patterns)."""
    args = rtc.parse_signature(
        "const float *a, double *b, __half c, __nv_bfloat16 d, int8_t e, "
        "uint8_t f, int32_t g, int h, int64_t i, float j, double k")
    a, b = torch.ones(3), torch.zeros(2, dtype=torch.float64)
    # an f64 NDArray needs x64 on, as in the reference
    mt.config.enable_x64(True)
    try:
        b_nd = mt.nd.NDArray(b)
    finally:
        mt.config.unset("numpy.enable_x64")
    values = [a, b_nd, 1.5, 0.7, -5, 200, -7, 123, 2 ** 40, 0.1, 0.1]
    params, holders = rtc.marshal(args, values, torch.device("cpu"))
    assert len(params) == len(args) == len(holders)

    def at(i, ctype):
        return ctype.from_address(params[i]).value

    assert at(0, ctypes.c_void_p) == a.data_ptr()
    assert at(1, ctypes.c_void_p) == b.data_ptr()
    assert at(2, ctypes.c_uint16) == int(np.float16(1.5).view(np.uint16))
    assert at(3, ctypes.c_uint16) == int(
        torch.tensor(0.7, dtype=torch.bfloat16).view(torch.int16)) & 0xFFFF
    assert at(4, ctypes.c_int8) == -5 and at(5, ctypes.c_uint8) == 200
    assert at(6, ctypes.c_int32) == -7 and at(7, ctypes.c_int32) == 123
    assert at(8, ctypes.c_int64) == 2 ** 40
    assert at(9, ctypes.c_float) == float(np.float32(0.1))
    assert at(10, ctypes.c_double) == 0.1


def test_marshal_rejects_what_contradicts_the_signature():
    args = rtc.parse_signature("const float *x, int8_t n")
    cpu = torch.device("cpu")
    x = torch.ones(4)
    with pytest.raises(ValueError, match="int8_t"):
        rtc.marshal(args, [x, 300], cpu)
    with pytest.raises(ValueError, match="int8_t"):
        rtc.marshal(args, [x, 2.5], cpu)
    with pytest.raises(TypeError, match="signature says float"):
        rtc.marshal(args, [x.double(), 1], cpu)
    with pytest.raises(TypeError, match="Python number"):
        rtc.marshal(args, [x, torch.tensor(1)], cpu)
    with pytest.raises(TypeError, match="pointer"):
        rtc.marshal(args, [1.0, 1], cpu)
    with pytest.raises(ValueError, match="contiguous"):
        rtc.marshal(args, [torch.ones(4, 2).t(), 1], cpu)
    with pytest.raises(ValueError, match="2 arguments"):
        rtc.marshal(args, [x], cpu)
    with pytest.raises(ValueError, match="no CPU version"):
        rtc.marshal(args, [x, 1], torch.device("meta"))


# ---------------------------------------------------------------- errors
def test_import_loads_nothing_and_compiling_without_nvrtc_raises():
    """Importing the port loads neither NVRTC nor the driver; where the
    CUDA toolkit is not installed (the CPU test setting), compiling
    raises RuntimeError naming where it looked for NVRTC."""
    code = ("import mxnet_tpu_torch, mxnet_tpu_torch.rtc; "
            "from mxnet_tpu_torch.ops import _cudart; "
            "assert not _cudart._LIBS, _cudart._LIBS")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    with pytest.raises(RuntimeError) as info:
        rtc.CudaModule(SOURCE)
    for d in _cudart.nvrtc_search_dirs():
        assert d in str(info.value)


def test_cpu_tensor_and_cpu_ctx_raise(fake, monkeypatch):
    """With the real launch device: a CPU ``ctx`` raises, and so does a CPU
    tensor (there is no plain version of user source)."""
    kernel = _module().get_kernel("doubler", "const float *x, float *y, "
                                  "int n")
    monkeypatch.setattr(rtc, "_launch_device", LAUNCH_DEVICE)
    before = ck.LAUNCHES["rtc"]
    x = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.launch([x, torch.empty_like(x), 8], mt.cpu(), (1,), (8,))
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.launch([x, torch.empty_like(x), 8], "cpu", (1,), (8,))
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.launch([x, torch.empty_like(x), 8], None, (1,), (8,))
    assert fake.launches == [] and ck.LAUNCHES["rtc"] == before


def test_unknown_kernel_raises_keyerror(fake):
    mod = _module()
    with pytest.raises(KeyError, match="no_such_kernel"):
        mod.get_kernel("no_such_kernel", "const float *x")


def test_compile_options_exports_and_lowered_names(fake):
    """Options and name expressions reach NVRTC; an export resolves to its
    lowered name."""
    mod = _module(options=("--fmad=false",), exports=("scale<float>",))
    assert fake.programs == [(SOURCE, "mxnet_rtc.cu", ("--fmad=false",),
                              ("scale<float>",))]
    mod.get_kernel("scale<float>", "const float *x")
    assert fake.lookups[-1] == "_lowered_scale<float>"
    assert mod.compile_ms >= 0


def test_launch_dims_and_dynamic_shared_memory(fake):
    """Grid and block dims pad to three; more than 48 KB of dynamic shared
    memory is allowed once per kernel, before its launch."""
    k = _module().get_kernel("doubler", "const float *x, float *y, int n")
    x = torch.arange(10.0)
    y = torch.empty_like(x)
    k.launch([x, y, 10], "cuda", 2, (8,))
    k.launch([x, y, 10], "cuda", (1, 1), (16, 1, 1), shared_mem=96 * 1024)
    k.launch([x, y, 10], "cuda", (1,), (16,), shared_mem=64 * 1024)
    assert [l[1:] for l in fake.launches] == [
        ((2, 1, 1), (8, 1, 1), 0), ((1, 1, 1), (16, 1, 1), 96 * 1024),
        ((1, 1, 1), (16, 1, 1), 64 * 1024)]
    assert fake.shared == {"doubler": 96 * 1024}
    with pytest.raises(ValueError, match="dims"):
        k.launch([x, y, 10], "cuda", (1, 1, 1, 1), (8,))
    assert ck.LAUNCHES["rtc"] >= 3 and rtc.LAUNCHES["doubler"] == 3


# ------------------------------------------- the reference's user kernels
def test_module_get_kernel_launch(fake):
    """``CudaModule.get_kernel(...).launch(...)`` (the reference's API;
    counterpart of ``test_pallas_module_get_kernel_launch``)."""
    k = _module().get_kernel("doubler", "const float *x, float *y, int n")
    x = mt.nd.array(np.arange(6, dtype=np.float32))
    y = mt.nd.zeros((6,))
    before = ck.LAUNCHES["rtc"]
    k.launch([x, y, 6], mt.gpu(0), (1,), (256,))
    np.testing.assert_array_equal(y.asnumpy(), 2 * np.arange(6))
    assert ck.LAUNCHES["rtc"] == before + 1 and rtc.LAUNCHES["doubler"] == 1


def test_register_op_into_registry_nd_and_sym(fake):
    """``register_op`` makes the kernel ``mx.nd.<op>`` and ``mx.sym.<op>``
    (counterpart of ``test_rtc_register_op_into_registry_and_jit``): one
    launch per call, nothing on the tape, and in a graph one launch per
    forward, with the graph's output equal to the same graph over
    ``data + 1``."""
    k = _module().get_kernel("add_one", "const float *x, float *y, int n")
    rtc.register_op("test_rtc_add_one", k,
                    out_shape=lambda x: (x.shape, x.dtype),
                    grid_dims=lambda x: ((x.numel() + 255) // 256,),
                    block_dims=(256,), scalars=lambda x: [x.numel()])
    assert mt.ops.registry.get("test_rtc_add_one").differentiable is False
    out = mt.nd.test_rtc_add_one(mt.nd.array([1.0, 2.0]))
    np.testing.assert_array_equal(out.asnumpy(), [2.0, 3.0])
    assert rtc.LAUNCHES["add_one"] == 1
    x = mt.nd.array(np.arange(4, dtype=np.float32))
    x.attach_grad()
    with autograd.record():
        y = mt.nd.test_rtc_add_one(x)
    assert not y._on_tape and not y._data.requires_grad
    assert rtc.LAUNCHES["add_one"] == 2
    # in a symbolic graph: shapes come through meta tensors at bind
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(mt.sym.test_rtc_add_one(data, name="plus"),
                                num_hidden=3, name="fc")
    plain = mt.sym.FullyConnected(data + 1, num_hidden=3, name="fc")
    ex = net.simple_bind(mt.cpu(), grad_req="null", data=(5, 4))
    ex_plain = plain.simple_bind(mt.cpu(), grad_req="null", data=(5, 4))
    w = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    for e in (ex, ex_plain):
        e.copy_params_from({"fc_weight": w, "fc_bias": np.ones(3)})
    xin = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    got = ex.forward(data=xin)[0].asnumpy()
    assert rtc.LAUNCHES["add_one"] == 3
    np.testing.assert_array_equal(got,
                                  ex_plain.forward(data=xin)[0].asnumpy())


def test_registered_op_has_no_cpu_route(fake, monkeypatch):
    k = _module().get_kernel("add_one", "const float *x, float *y, int n")
    rtc.register_op("test_rtc_add_one_cpu", k,
                    out_shape=lambda x: (x.shape, x.dtype), grid_dims=(1,),
                    block_dims=(256,), scalars=lambda x: [x.numel()])
    monkeypatch.setattr(rtc, "_launch_device", LAUNCH_DEVICE)
    with pytest.raises(ValueError, match="CUDA device"):
        mt.nd.test_rtc_add_one_cpu(mt.nd.array([1.0]))
    assert fake.launches == []


def test_kernel_with_grid_blocks(fake):
    """``block_scale`` on a 2-D grid of row blocks (counterpart of
    ``test_pallas_kernel_with_grid_blocks``: its BlockSpec((4, 8)) grid
    over an [8, 8] input), and at a ragged shape the grid overhangs."""
    k = _module().get_kernel("block_scale",
                             "const float *x, float *y, int rows, int cols")
    for rows, cols in ((8, 8), (37, 13)):
        x = mt.nd.array(np.arange(rows * cols, dtype=np.float32)
                        .reshape(rows, cols))
        y = mt.nd.zeros((rows, cols))
        k.launch([x, y, rows, cols], mt.gpu(0), ((cols + 7) // 8,
                                                 (rows + 3) // 4), (8, 4))
        np.testing.assert_array_equal(y.asnumpy(), 4 * x.asnumpy())
    assert fake.launches[0][1:3] == ((1, 2, 1), (8, 4, 1))
