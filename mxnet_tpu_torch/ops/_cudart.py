"""ctypes bindings to NVRTC and the CUDA driver API: the compile-and-launch
layer under ``mx.rtc`` (the port's own binding layer, as ``_build`` is for
the prebuilt kernels).

* NVRTC compiles user CUDA source in process, for ``sm_90a``, into a
  cubin (:func:`compile_program`), as the reference's
  ``src/common/rtc.cc`` does.  A cubin, not PTX: the driver then never has
  to JIT PTX written by an NVRTC newer than itself.
* The driver API loads the cubin into a device's primary context (the one
  PyTorch's runtime uses), looks up kernels and launches them on a stream
  (:func:`load_module`, :func:`get_function`, :func:`launch`).

Both libraries load at first use, never at import: the CPU-only test
machines import every module and have neither.  ``libnvrtc.so*`` is looked
up where ``_build.nvcc_path`` looks for ``nvcc``: ``$CUDA_HOME/lib64``,
then ``/usr/local/cuda/lib64``, then the loader path; its
``libnvrtc-builtins.so*`` is loaded first from the same directory, so that
NVRTC never pairs with another installation's builtins (PyTorch's wheel
may carry its own NVRTC).  Every call's status is checked; a failure
raises ``RuntimeError`` with the library's own error string.

The driver's current context is per thread: :func:`load_module` and
:func:`launch` make the device's primary context current on the calling
thread first (``cuDevicePrimaryCtxRetain``, ``cuCtxSetCurrent``).  A
module loaded there serves every thread.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading

__all__ = ["nvrtc_search_dirs", "nvrtc_version", "cuda_include_dir",
           "compile_program", "current_device", "current_stream",
           "load_module", "get_function", "set_max_dynamic_shared",
           "launch", "ARCH"]

#: the target every program compiles for (a real architecture: a cubin)
ARCH = "sm_90a"

_CUDA_ERROR_NOT_FOUND = 500
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
_U = ctypes.c_uint
_SZ = ctypes.POINTER(ctypes.c_size_t)
_STRS = ctypes.POINTER(ctypes.c_char_p)

_NVRTC_SIGS = {
    "nvrtcVersion": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "nvrtcCreateProgram": [_PP, ctypes.c_char_p, ctypes.c_char_p, _I, _STRS,
                           _STRS],
    "nvrtcDestroyProgram": [_PP],
    "nvrtcAddNameExpression": [_P, ctypes.c_char_p],
    "nvrtcCompileProgram": [_P, _I, _STRS],
    "nvrtcGetProgramLogSize": [_P, _SZ],
    "nvrtcGetProgramLog": [_P, ctypes.c_char_p],
    "nvrtcGetCUBINSize": [_P, _SZ],
    "nvrtcGetCUBIN": [_P, ctypes.c_char_p],
    "nvrtcGetLoweredName": [_P, ctypes.c_char_p, _STRS],
}
_CUDA_SIGS = {
    "cuInit": [_U],
    "cuDeviceGet": [ctypes.POINTER(_I), _I],
    "cuDevicePrimaryCtxRetain": [_PP, _I],
    "cuCtxGetCurrent": [_PP],
    "cuCtxSetCurrent": [_P],
    "cuModuleLoadData": [_PP, _P],
    "cuModuleGetFunction": [_PP, _P, ctypes.c_char_p],
    "cuFuncSetAttribute": [_P, _I, _I],
    "cuLaunchKernel": [_P, _U, _U, _U, _U, _U, _U, _U, _P, _PP, _PP],
    "cuGetErrorString": [_I, _STRS],
}

_LOCK = threading.Lock()
_LIBS = {}        # guarded-by: _LOCK — "nvrtc" / "cuda" -> ctypes.CDLL
_PRIMARY = {}     # guarded-by: _LOCK — device ordinal -> CUcontext (int)


def _cuda_roots():
    roots = []
    if os.environ.get("CUDA_HOME"):
        roots.append(os.environ["CUDA_HOME"])
    roots.append("/usr/local/cuda")
    return roots


def nvrtc_search_dirs():
    """Where ``libnvrtc.so*`` is looked for, in order (the loader path
    comes after these)."""
    return [os.path.join(r, "lib64") for r in _cuda_roots()]


def cuda_include_dir():
    """The toolkit's include directory (``cuda_fp16.h`` and
    ``cuda_bf16.h`` resolve there), or None."""
    for r in _cuda_roots():
        inc = os.path.join(r, "include")
        if os.path.exists(os.path.join(inc, "cuda_fp16.h")):
            return inc
    return None


def _bind(lib, sigs):
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def _open_nvrtc():
    for d in nvrtc_search_dirs():
        libs = sorted(glob.glob(os.path.join(d, "libnvrtc.so*")), key=len)
        if not libs:
            continue
        for builtins in sorted(glob.glob(
                os.path.join(d, "libnvrtc-builtins.so*")), key=len)[-1:]:
            ctypes.CDLL(builtins, mode=ctypes.RTLD_GLOBAL)
        return ctypes.CDLL(libs[0])
    try:
        return ctypes.CDLL("libnvrtc.so")
    except OSError:
        raise RuntimeError(
            "NVRTC (libnvrtc.so*) not found: tried %s and the loader path; "
            "mx.rtc compiles user CUDA source only where the CUDA toolkit "
            "is installed" % ", ".join(nvrtc_search_dirs())) from None


def _open_cuda():
    try:
        return ctypes.CDLL("libcuda.so.1")
    except OSError:
        raise RuntimeError("the CUDA driver (libcuda.so.1) is not on the "
                           "loader path: mx.rtc kernels need an NVIDIA "
                           "driver") from None


def _lib(kind):
    with _LOCK:
        lib = _LIBS.get(kind)
        if lib is None:
            if kind == "nvrtc":
                lib = _bind(_open_nvrtc(), _NVRTC_SIGS)
                lib.nvrtcGetErrorString.argtypes = [_I]
                lib.nvrtcGetErrorString.restype = ctypes.c_char_p
            else:
                lib = _bind(_open_cuda(), _CUDA_SIGS)
                _check_cu(lib, lib.cuInit(0), "cuInit")
            _LIBS[kind] = lib
        return lib


def _check_cu(lib, res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(res, ctypes.byref(msg))
        raise RuntimeError("%s failed: CUDA driver error %d (%s)" % (
            what, res, (msg.value or b"unknown").decode()))


def _check_rtc(lib, res, what):
    if res != 0:
        raise RuntimeError("%s failed: %s" % (
            what, lib.nvrtcGetErrorString(res).decode()))


def nvrtc_version():
    """``(major, minor)`` of the NVRTC that :func:`compile_program` uses."""
    lib = _lib("nvrtc")
    major, minor = _I(), _I()
    _check_rtc(lib, lib.nvrtcVersion(ctypes.byref(major),
                                     ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def _strs(items):
    arr = (ctypes.c_char_p * len(items))()
    arr[:] = [s.encode() for s in items]
    return arr


def compile_program(source, name, options=(), name_expressions=()):
    """Compile ``source`` for :data:`ARCH` into a cubin.  Returns
    ``(cubin bytes, {name expression: lowered name}, log)``.  A source
    that does not compile raises ``RuntimeError`` with NVRTC's log."""
    lib = _lib("nvrtc")
    prog = _P()
    _check_rtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), name.encode(), 0, None, None),
        "nvrtcCreateProgram")
    try:
        for expr in name_expressions:
            _check_rtc(lib, lib.nvrtcAddNameExpression(prog, expr.encode()),
                       "nvrtcAddNameExpression(%r)" % expr)
        opts = ["--gpu-architecture=" + ARCH, "--std=c++17"]
        inc = cuda_include_dir()
        if inc is not None:
            opts.append("-I" + inc)
        opts.extend(options)
        res = lib.nvrtcCompileProgram(prog, len(opts), _strs(opts))
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        if res != 0:
            raise RuntimeError("NVRTC could not compile %s (options %s):\n%s"
                               % (name, " ".join(opts), log))
        _check_rtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                   "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_rtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for expr in name_expressions:
            out = ctypes.c_char_p()
            _check_rtc(lib, lib.nvrtcGetLoweredName(
                prog, expr.encode(), ctypes.byref(out)),
                "nvrtcGetLoweredName(%r)" % expr)
            lowered[expr] = out.value.decode()
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def current_device():
    """The CUDA device ordinal PyTorch's runtime has current."""
    import torch
    return torch.cuda.current_device()


def current_stream(device):
    """PyTorch's current stream on ``device`` (a ``torch.device``), as the
    driver's ``CUstream`` handle."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def _make_current(lib, ordinal):
    """The device's primary context, current on the calling thread."""
    ctx = _PRIMARY.get(ordinal)
    if ctx is None:
        import torch
        torch.cuda.init()
        with _LOCK:
            ctx = _PRIMARY.get(ordinal)
            if ctx is None:
                dev = _I()
                _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev), ordinal),
                          "cuDeviceGet")
                handle = _P()
                _check_cu(lib, lib.cuDevicePrimaryCtxRetain(
                    ctypes.byref(handle), dev), "cuDevicePrimaryCtxRetain")
                ctx = _PRIMARY[ordinal] = handle.value
    cur = _P()
    _check_cu(lib, lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx:
        _check_cu(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def load_module(image, ordinal):
    """Load a cubin (bytes) into device ``ordinal``'s primary context;
    returns the ``CUmodule`` handle."""
    lib = _lib("cuda")
    _make_current(lib, ordinal)
    mod = _P()
    buf = ctypes.create_string_buffer(image, len(image))
    _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(mod), buf),
              "cuModuleLoadData")
    return mod.value


def get_function(module, name):
    """The ``CUfunction`` named ``name`` (a lowered name) in ``module``, or
    None when the module has no such kernel."""
    lib = _lib("cuda")
    fn = _P()
    res = lib.cuModuleGetFunction(ctypes.byref(fn), module, name.encode())
    if res == _CUDA_ERROR_NOT_FOUND:
        return None
    _check_cu(lib, res, "cuModuleGetFunction(%r)" % name)
    return fn.value


def set_max_dynamic_shared(function, nbytes):
    """Let ``function`` take ``nbytes`` of dynamic shared memory (needed
    above 48 KB)."""
    lib = _lib("cuda")
    _check_cu(lib, lib.cuFuncSetAttribute(
        function, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
        int(nbytes)), "cuFuncSetAttribute(max dynamic shared memory)")


def launch(function, ordinal, grid, block, shared_mem, stream, params):
    """``cuLaunchKernel`` on device ``ordinal``: ``params`` is the
    ``kernelParams`` array (a pointer to each argument's value), kept
    alive by the caller until this returns.  Does not synchronise; a
    refused launch raises here."""
    lib = _lib("cuda")
    _make_current(lib, ordinal)
    _check_cu(lib, lib.cuLaunchKernel(
        function, grid[0], grid[1], grid[2], block[0], block[1], block[2],
        int(shared_mem), stream, params, None), "cuLaunchKernel")
