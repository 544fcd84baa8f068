"""Runtime kernel compilation (ref: include/mxnet/rtc.h + src/common/rtc.cc
— user-supplied CUDA C compiled through NVRTC into launchable kernels,
exposed to Python as ``mx.rtc.CudaModule``).

Counterpart of ``mxnet_tpu/rtc.py``, with two source languages:

- **CUDA C** (a source holding ``__global__``), MXNet 1.0's own contract.
  The source is compiled at its first launch by NVRTC for ``sm_90a``
  (through ``ctypes``, as ``src/common/rtc.cc`` does), the cubin is cached
  by a digest of the source, options and exports under the package's
  ``_build/``, and the module is loaded and its kernels launched through
  the CUDA driver API on torch's current stream.  ``get_kernel(name,
  signature)`` parses the C signature (``const float *x, float *y, float
  alpha, int n``); ``Kernel.launch`` checks each argument's dtype, card
  and contiguity and honours ``grid_dims``, ``block_dims`` and
  ``shared_mem``.  ``exports`` names C++ kernels (``"axpy<float>"``) whose
  lowered names NVRTC reports.  A compile error raises ``MXNetError``
  with the compiler's log; a launch with a host ``ctx`` raises, as MXNet
  1.0's rtc is GPU-only.  NVRTC and ``libcuda`` are loaded only inside
  the launching call, never at import.
- **Python** over torch tensors: the JAX package's reinterpretation.  Its
  source is Python run in a namespace holding ``torch``, ``F``
  (``torch.nn.functional``) and ``np`` where the JAX package offers
  ``jnp``/``jax``/``lax`` (and ``pl``/``pltpu`` for hand-written TPU
  kernels, whose counterpart here is the CUDA C route), so a source such
  as ``def axpy(a, x, y): return a * x + y`` runs in both packages.
  grid/block/shared_mem are accepted and ignored, and results are written
  into ``outputs`` when given, else returned.

Example (CUDA C, MXNet 1.0's ``test_cuda_rtc``)::

    mod = mx.rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
        int i = threadIdx.x + blockIdx.x * blockDim.x;
        y[i] += alpha * x[i];
    }''')
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha")
    k.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import re
import threading
import time

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

ARCH = "sm_90a"
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build")
# NVRTC has no standard headers: the fixed-width integer names of the
# signature table, on one line so the compiler's line numbers hold
_PRELUDE = ("typedef signed char int8_t; typedef unsigned char uint8_t; "
            "typedef int int32_t; typedef unsigned int uint32_t; "
            "typedef long long int64_t; typedef unsigned long long "
            "uint64_t;\n")

# C type of a kernel parameter -> numpy dtype (ref: rtc.py _DTYPE_CPP_TO_NP)
DTYPE_CPP_TO_NP = {
    "float": np.float32,
    "double": np.float64,
    "__half": np.float16,
    "uint8_t": np.uint8,
    "int": np.int32,
    "int32_t": np.int32,
    "int8_t": np.int8,
    "char": np.int8,
    "int64_t": np.int64,
}
_CTYPE = {np.float32: ctypes.c_float, np.float64: ctypes.c_double,
          np.float16: ctypes.c_uint16, np.uint8: ctypes.c_uint8,
          np.int32: ctypes.c_int32, np.int8: ctypes.c_int8,
          np.int64: ctypes.c_int64}
_PARAM = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")
_PY_NAMES = ("torch", "F", "np")


def parse_signature(signature):
    """``[(is_pointer, is_const, numpy dtype, name)]`` of a C kernel
    signature such as ``"const float *x, float *y, float alpha"``."""
    out = []
    for arg in signature.split(","):
        m = _PARAM.match(arg)
        if m is None or m.group(2) not in DTYPE_CPP_TO_NP:
            raise MXNetError(
                "invalid kernel signature %r: cannot parse %r (each "
                "argument is [const] <type>[*] [name] with a type of %s)"
                % (signature, arg.strip(), ", ".join(DTYPE_CPP_TO_NP)))
        out.append((m.group(3) is not None, m.group(1) is not None,
                    np.dtype(DTYPE_CPP_TO_NP[m.group(2)]), m.group(4)))
    return out


# -- the Python route ----------------------------------------------------------

class Kernel:
    """A kernel of a Python-source module (ref: CudaModule::Kernel,
    rtc.h:39-118)."""

    def __init__(self, fn, name, signature):
        self._fn = fn
        self.name = name
        self.signature = signature

    def launch(self, args, ctx=None, grid_dims=(1, 1, 1),
               block_dims=(1, 1, 1), shared_mem=0, outputs=None):
        """Run the function.  grid/block/shared_mem are accepted for
        call-site parity and ignored.  ``ctx`` places the results.
        Results are written into ``outputs`` (NDArrays) when given, else
        returned."""
        vals = [a.tensor if isinstance(a, NDArray) else a for a in args]
        with torch.no_grad():
            out = self._fn(*vals)
        dev = ctx.torch_device() if ctx is not None else None

        def place(t, device=None):
            t = torch.as_tensor(t)
            device = device or dev
            return t if device is None or t.device == device \
                else t.to(device)

        if outputs is None:
            if isinstance(out, tuple):
                return tuple(NDArray(place(o)) for o in out)
            return NDArray(place(out))
        outs = out if isinstance(out, tuple) else (out,)
        if len(outs) != len(outputs):
            raise MXNetError(
                "kernel %r produced %d outputs, launch got %d output "
                "arrays" % (self.name, len(outs), len(outputs)))
        for dst, src in zip(outputs, outs):
            src = torch.as_tensor(src)
            if tuple(dst.shape) != tuple(src.shape):
                raise MXNetError(
                    "kernel %r output shape %s does not match destination "
                    "%s" % (self.name, tuple(src.shape), tuple(dst.shape)))
            dst._h.tensor = place(src, dst.tensor.device).to(
                dst.tensor.dtype)
        return outputs


# -- the CUDA C route: NVRTC and the driver API through ctypes ----------------

_lock = threading.Lock()
_libs = {}

_P = ctypes.POINTER
_VP, _INT, _UINT = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# (argtypes, restype) of every entry point used; each returns a status
# code (nvrtcResult, CUresult) unless said
_SIGNATURES = {
    "nvrtc": {
        "nvrtcCreateProgram": ((_P(_VP), ctypes.c_char_p, ctypes.c_char_p,
                                _INT, _VP, _VP), _INT),
        "nvrtcAddNameExpression": ((_VP, ctypes.c_char_p), _INT),
        "nvrtcCompileProgram": ((_VP, _INT, _P(ctypes.c_char_p)), _INT),
        "nvrtcGetProgramLogSize": ((_VP, _P(ctypes.c_size_t)), _INT),
        "nvrtcGetProgramLog": ((_VP, _VP), _INT),
        "nvrtcGetCUBINSize": ((_VP, _P(ctypes.c_size_t)), _INT),
        "nvrtcGetCUBIN": ((_VP, _VP), _INT),
        "nvrtcGetLoweredName": ((_VP, ctypes.c_char_p,
                                 _P(ctypes.c_char_p)), _INT),
        "nvrtcDestroyProgram": ((_P(_VP),), _INT),
        "nvrtcGetErrorString": ((_INT,), ctypes.c_char_p),
    },
    "cuda": {
        "cuInit": ((_UINT,), _INT),
        "cuDeviceGet": ((_P(_INT), _INT), _INT),
        "cuDevicePrimaryCtxRetain": ((_P(_VP), _INT), _INT),
        "cuCtxSetCurrent": ((_VP,), _INT),
        "cuModuleLoadData": ((_P(_VP), _VP), _INT),
        "cuModuleGetFunction": ((_P(_VP), _VP, ctypes.c_char_p), _INT),
        "cuFuncSetAttribute": ((_VP, _INT, _INT), _INT),
        "cuLaunchKernel": ((_VP, _UINT, _UINT, _UINT, _UINT, _UINT, _UINT,
                            _UINT, _VP, _P(_VP), _P(_VP)), _INT),
        "cuGetErrorString": ((_INT, _P(ctypes.c_char_p)), _INT),
    },
}


def _find_library(kind):
    """The NVRTC or driver library: the toolkit's, torch's bundled copy,
    then the loader's search path."""
    import ctypes.util
    if kind == "cuda":
        names = ["libcuda.so.1", "libcuda.so"]
    else:
        roots = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
        names = []
        for root in roots:
            if root:
                names += sorted(glob.glob(os.path.join(
                    root, "lib64", "libnvrtc.so*")))
        torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
        names += sorted(glob.glob(os.path.join(torch_lib, "libnvrtc*.so*")))
        site = os.path.dirname(os.path.dirname(torch.__file__))
        names += sorted(glob.glob(os.path.join(
            site, "nvidia", "cuda_nvrtc", "lib", "libnvrtc.so*")))
        found = ctypes.util.find_library("nvrtc")
        if found:
            names.append(found)
        names = [n for n in names if "builtins" not in n]
    for name in names:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        for fn, (argtypes, restype) in _SIGNATURES[kind].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        return lib
    raise MXNetError("rtc: cannot load %s (looked for %s)"
                     % ("libcuda" if kind == "cuda" else "NVRTC",
                        names or kind))


def _lib(kind):
    with _lock:
        lib = _libs.get(kind)
        if lib is None:
            lib = _libs[kind] = _find_library(kind)
        return lib


def _cu_check(res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        _lib("cuda").cuGetErrorString(res, ctypes.byref(msg))
        raise MXNetError("rtc: %s failed: CUDA error %d (%s)"
                         % (what, res, (msg.value or b"?").decode()))


def _nvrtc_check(res, what):
    if res != 0:
        raise MXNetError("rtc: %s failed: %s" % (
            what, _lib("nvrtc").nvrtcGetErrorString(res).decode()))


def _compile(source, options, exports):
    """(cubin bytes, {export: lowered name}, seconds, cached) for a CUDA C
    source, from the ``_build/`` cache when an equal compile is there."""
    text = _PRELUDE + source
    opts = ["--gpu-architecture=%s" % ARCH] + list(options)
    digest = hashlib.sha256(repr((text, opts, list(exports))).encode()) \
        .hexdigest()[:16]
    cubin_path = os.path.join(_BUILD_DIR, "rtc-%s.cubin" % digest)
    names_path = os.path.join(_BUILD_DIR, "rtc-%s.names.json" % digest)
    t0 = time.perf_counter()
    if os.path.exists(cubin_path) and os.path.exists(names_path):
        with open(cubin_path, "rb") as f, open(names_path) as g:
            return f.read(), json.load(g), time.perf_counter() - t0, True
    nv = _lib("nvrtc")
    prog = ctypes.c_void_p()
    _nvrtc_check(nv.nvrtcCreateProgram(
        ctypes.byref(prog), text.encode(), b"mx_rtc_source.cu", 0, None,
        None), "nvrtcCreateProgram")
    try:
        for name in exports:
            _nvrtc_check(nv.nvrtcAddNameExpression(prog, name.encode()),
                         "nvrtcAddNameExpression(%s)" % name)
        argv = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = nv.nvrtcCompileProgram(prog, len(opts), argv)
        size = ctypes.c_size_t()
        nv.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        nv.nvrtcGetProgramLog(prog, log)
        if res != 0:
            raise MXNetError("rtc compilation failed (NVRTC, %s):\n%s"
                             % (" ".join(opts),
                                log.value.decode(errors="replace")))
        _nvrtc_check(nv.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        buf = ctypes.create_string_buffer(size.value)
        _nvrtc_check(nv.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN")
        cubin = buf.raw
        lowered = {}
        for name in exports:
            out = ctypes.c_char_p()
            _nvrtc_check(nv.nvrtcGetLoweredName(prog, name.encode(),
                                                ctypes.byref(out)),
                         "nvrtcGetLoweredName(%s)" % name)
            lowered[name] = out.value.decode()
    finally:
        nv.nvrtcDestroyProgram(ctypes.byref(prog))
    os.makedirs(_BUILD_DIR, exist_ok=True)
    for path, data, mode in ((cubin_path, cubin, "wb"),
                             (names_path, json.dumps(lowered), "w")):
        tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
        with open(tmp, mode) as f:
            f.write(data)
        os.replace(tmp, path)
    return cubin, lowered, time.perf_counter() - t0, False


_contexts = {}


def _current_context(index):
    """Make the card's primary context (torch's) current on this
    thread."""
    cu = _lib("cuda")
    with _lock:
        ctx = _contexts.get(index)
        if ctx is None:
            _cu_check(cu.cuInit(0), "cuInit")
            dev = ctypes.c_int()
            _cu_check(cu.cuDeviceGet(ctypes.byref(dev), index),
                      "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _cu_check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                      "cuDevicePrimaryCtxRetain")
            _contexts[index] = ctx
    _cu_check(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


class CudaKernel:
    """A kernel of a CUDA C module (ref: CudaModule::Kernel)."""

    def __init__(self, module, name, signature):
        self.module = module
        self.name = name
        self.signature = signature
        self._params = parse_signature(signature)
        self._functions = {}  # card index -> CUfunction
        self.launches = 0

    def _function(self, index):
        fn = self._functions.get(index)
        if fn is None:
            mod = self.module._load(index)
            symbol = self.module.lowered_names.get(self.name, self.name)
            fn = ctypes.c_void_p()
            res = _lib("cuda").cuModuleGetFunction(
                ctypes.byref(fn), mod, symbol.encode())
            if res != 0:
                raise MXNetError(
                    "kernel %r not found in rtc module (symbol %r; a C++ "
                    "kernel needs extern \"C\" or a name in exports)"
                    % (self.name, symbol))
            self._functions[index] = fn
        return fn

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx``'s card on torch's current stream (ref:
        CudaKernel.launch).  ``args`` follow the signature: an NDArray of
        the pointer's dtype on that card, contiguous, for each pointer;
        a number for each scalar."""
        if ctx is None or ctx.device_type != "gpu":
            raise MXNetError("CUDA C kernel %r can only be launched on a "
                             "GPU context, got %s" % (self.name, ctx))
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise MXNetError("grid_dims and block_dims must be tuples of "
                             "3 integers")
        if len(args) != len(self._params):
            raise MXNetError("CudaKernel(%s) expects %d arguments but got "
                             "%d" % (self.name, len(self._params),
                                     len(args)))
        device = ctx.torch_device()
        index = device.index or 0
        keep, ptrs = [], []
        for i, (arg, (is_ptr, _, dtype, pname)) in enumerate(
                zip(args, self._params)):
            what = "argument %d (%s) of %s" % (i, pname or "?", self.name)
            if is_ptr:
                if not isinstance(arg, NDArray):
                    raise MXNetError("%s must be an NDArray, got %s"
                                     % (what, type(arg).__name__))
                t = arg.tensor
                if str(t.dtype).replace("torch.", "") != dtype.name:
                    raise MXNetError("%s must be %s, got %s"
                                     % (what, dtype, t.dtype))
                if t.device != device:
                    raise MXNetError("%s lies on %s, the launch's context "
                                     "is %s" % (what, t.device, device))
                if not t.is_contiguous():
                    raise MXNetError("%s must be contiguous" % what)
                v = ctypes.c_void_p(t.data_ptr())
            else:
                if isinstance(arg, NDArray) or not np.isscalar(arg):
                    raise MXNetError("%s must be a number, got %s"
                                     % (what, type(arg).__name__))
                raw = np.array(arg, dtype=dtype)
                v = _CTYPE[dtype.type](
                    int(raw.view(np.uint16)) if dtype == np.float16
                    else raw.item())
            keep.append(v)
            ptrs.append(ctypes.cast(ctypes.pointer(v), ctypes.c_void_p))
        params = (ctypes.c_void_p * len(ptrs))(*ptrs)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _current_context(index)
            fn = self._function(index)
            cu = _lib("cuda")
            if shared_mem > 48 * 1024:
                # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
                _cu_check(cu.cuFuncSetAttribute(fn, 8, int(shared_mem)),
                          "cuFuncSetAttribute(%s)" % self.name)
            _cu_check(cu.cuLaunchKernel(
                fn, *[ctypes.c_uint(int(d)) for d in grid_dims],
                *[ctypes.c_uint(int(d)) for d in block_dims],
                ctypes.c_uint(int(shared_mem)), ctypes.c_void_p(stream),
                params, None), "cuLaunchKernel(%s)" % self.name)
        self.launches += 1


class CudaModule:
    """Runtime-compiled kernel module (ref: mx.rtc.CudaModule).

    ``source`` holding ``__global__`` is CUDA C, compiled by NVRTC at its
    first launch; otherwise it is Python over torch tensors, run now in a
    namespace holding ``torch``, ``F`` and ``np``."""

    def __init__(self, source, options=(), exports=()):
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self._kernels = {}
        self.is_cuda = "__global__" in source
        if self.is_cuda:
            self.lowered_names = {}
            self.compile_seconds = None
            self.compile_cached = None
            self._cubin = None
            self._modules = {}
            return
        import torch.nn.functional as F
        ns = {"torch": torch, "F": F, "np": np}
        try:
            exec(compile(source, "<mx.rtc source>", "exec"), ns)
        except Exception as e:
            raise MXNetError("rtc compilation failed: %s: %s"
                             % (type(e).__name__, e))
        self._ns = ns

    def compile(self):
        """Compile a CUDA C module now (its first launch does otherwise);
        returns the compile's seconds (a cache hit's are the read)."""
        if not self.is_cuda:
            raise MXNetError("compile() is for CUDA C modules")
        if self._cubin is None:
            self._cubin, self.lowered_names, self.compile_seconds, \
                self.compile_cached = _compile(self.source, self.options,
                                               self.exports)
        return self.compile_seconds

    def _load(self, index):
        mod = self._modules.get(index)
        if mod is None:
            self.compile()
            mod = ctypes.c_void_p()
            _cu_check(_lib("cuda").cuModuleLoadData(ctypes.byref(mod),
                                                    self._cubin),
                      "cuModuleLoadData")
            self._modules[index] = mod
        return mod

    def get_kernel(self, name, signature=""):
        cached = self._kernels.get((name, signature))
        if cached is not None:
            return cached
        if self.is_cuda:
            kernel = CudaKernel(self, name, signature)
        else:
            fn = self._ns.get(name)
            if not callable(fn):
                raise MXNetError("kernel %r not found in rtc module "
                                 "(defined: %s)" % (
                                     name,
                                     [k for k, v in self._ns.items()
                                      if callable(v)
                                      and not k.startswith("_")
                                      and k not in _PY_NAMES]))
            kernel = Kernel(fn, name, signature)
        self._kernels[(name, signature)] = kernel
        return kernel
