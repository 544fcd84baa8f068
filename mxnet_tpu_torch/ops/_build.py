"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is a plain-C-interface source.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``mxnet_tpu_torch/_build/`` (one
shared library per source, named by a digest of the source and the flags,
written to a temporary name and renamed into place so concurrent builders
never load a half-written file) and bound with ``ctypes``.  Nothing here
runs at import: the sources build only when a CUDA tensor reaches a
kernel wrapper, or when :func:`build_all` is called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..base import MXNetError

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs = {}
# name -> {"seconds": build wall time (0.0 when the library was already
# built), "path": library path, "ptxas": the compiler's resource report}
BUILD_INFO = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default install, else ``nvcc`` on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                         "that builds the package's kernels")
    return found


def _library_path(name):
    src = os.path.join(SRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + repr(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, "lib%s-%s.so"
                             % (name, digest.hexdigest()[:12]))


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path."""
    src, lib = _library_path(name)
    if os.path.exists(lib):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "path": lib,
                                     "ptxas": ""})
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.%d.tmp" % (lib, os.getpid(), threading.get_ident())
    t0 = time.perf_counter()
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise MXNetError("nvcc failed on %s:\n%s%s"
                         % (src, res.stdout, res.stderr))
    os.replace(tmp, lib)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "path": lib,
                        "ptxas": (res.stdout + res.stderr).strip()}
    return lib


def build_all(names):
    """Build several sources at once, one ``nvcc`` per source."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
