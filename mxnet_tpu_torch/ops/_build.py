"""Build and load the hand-written CUDA kernels of ``mxnet_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for
``sm_90a``, into its own shared library with a plain C interface, loaded
with ``ctypes``.  The library lands in ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named after the hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header never loads a stale build.
:func:`build` compiles several sources at once, one ``nvcc`` process per
source, all started together.

Nothing here runs at import: the CPU-only test machines import every
module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "build", "load", "build_dir", "nvcc_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
#: kernel name -> source file under csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "flash_f32": "flash_f32.cu",
           "paged_attn": "paged_attn.cu", "adam_step": "adam_step.cu",
           "sgd_step": "sgd_step.cu", "row_softmax": "row_softmax.cu",
           "scale_bias_relu": "scale_bias_relu.cu",
           "box_nms": "box_nms.cu"}
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}   # guarded-by: _LOCK — name -> ctypes.CDLL


def build_dir():
    return os.path.join(os.path.dirname(_PKG), "build", "kernels")


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _lib_path(name):
    """The source of kernel ``name`` and its library's path, named after
    the hash of the source, the flags and every shared header under
    ``csrc/`` (``*.cuh``, which a source may include)."""
    src = os.path.join(_CSRC, SOURCES[name])
    digest = hashlib.sha1(" ".join(_FLAGS).encode())
    for path in [src] + sorted(os.path.join(_CSRC, f)
                               for f in os.listdir(_CSRC)
                               if f.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(build_dir(),
                             "lib%s-%s.so" % (name, digest.hexdigest()[:12]))


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet,
    in parallel.  Returns ``{name: {"seconds": s, "ptxas": text}}`` for the
    ones compiled now; raises RuntimeError with the compiler's output if
    any fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        src, out = _lib_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = "%s.%d.tmp" % (out, os.getpid())
        procs[name] = (subprocess.Popen(
            [nvcc, *_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s:\n%s" % (name, text))
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": text}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name, signatures):
    """The loaded library for kernel ``name`` (building it first if
    needed), with ``argtypes``/``restype`` set from ``signatures``
    (``{symbol: (argtypes, restype)}``)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _, path = _lib_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            for sym, (argtypes, restype) in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIBS[name] = lib
        return lib
