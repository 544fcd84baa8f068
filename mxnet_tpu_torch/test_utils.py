"""Testing helpers (ref: python/mxnet/test_utils.py — the test contract:
check_numeric_gradient :794, check_symbolic_forward/backward :926,
assert_almost_equal :472, default_context :55, rand_ndarray :341).

The port's copy of ``mxnet_tpu/test_utils.py``: the same helpers over the
port's arrays, symbols and executors.  ``check_consistency`` runs one
symbol on several contexts (the reference's cpu against gpu check);
``rand_ndarray`` makes dense arrays only (sparse storage is not ported);
``list_gpus`` counts the CUDA devices torch sees."""
from __future__ import annotations

import logging
import numbers

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context
from .ndarray import NDArray, array
from . import ndarray as nd
from . import symbol as sym_mod

_rng = np.random.RandomState(1234)  # module-local shape RNG


def default_context():
    return current_context()


def set_default_context(ctx):
    Context._default_ctx.value = ctx


def default_dtype():
    return np.float32


def random_arrays(*shapes):
    out = tuple(np.random.randn(*s).astype(default_dtype())
                for s in shapes)
    return out[0] if len(out) == 1 else list(out)


def random_sample(population, k):
    shuffled = list(population)
    np.random.shuffle(shuffled)
    return shuffled[:k]


def rand_shape_2d(dim0=10, dim1=10):
    return _rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1)


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1),
            _rng.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(_rng.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype=None):
    if stype == "default":
        return array(np.random.uniform(-1, 1, shape),
                     dtype=dtype or np.float32)
    from .ndarray import sparse
    return sparse.rand_sparse_ndarray(shape, stype, density=density,
                                      dtype=dtype)[0]


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """Reference reduction helper for axis-reduce op checks: applies the
    numpy reducer one axis at a time (the MXNet axis-list semantics), then
    restores singleton dims when keepdims."""
    if axis is None:
        axes = tuple(range(dat.ndim))
    elif isinstance(axis, int):
        axes = (axis,)
    else:
        axes = tuple(axis)
    axes = tuple(a % dat.ndim for a in axes)
    out = dat
    # descending order keeps the remaining axis numbers valid as dims drop
    for ax in sorted(axes, reverse=True):
        out = numpy_reduce_func(out, axis=ax)
    if keepdims:
        out = out.reshape(tuple(1 if i in axes else d
                                for i, d in enumerate(dat.shape)))
    return out


def same(a, b):
    return np.array_equal(a, b)


def find_max_violation(a, b, rtol=None, atol=None):
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    violation = np.abs(a - b) / (atol + rtol * np.abs(b) + 1e-20)
    worst = np.unravel_index(np.argmax(violation), violation.shape)
    return worst, violation[worst]


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """(ref: test_utils.py:472)"""
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    if isinstance(a, NDArray):
        a = a.asnumpy()
    if isinstance(b, NDArray):
        b = b.asnumpy()
    a = np.asarray(a, dtype=np.float64) if np.asarray(a).dtype.kind not in "fiub" \
        else np.asarray(a)
    b_arr = np.asarray(b)
    if np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                   rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    index, rel = find_max_violation(np.asarray(a, np.float64),
                                    np.asarray(b, np.float64), rtol, atol)
    raise AssertionError(
        "Error %f exceeds tolerance rtol=%f, atol=%f. Location of maximum "
        "error: %s, %s=%.8f, %s=%.8f"
        % (rel, rtol, atol, str(index), names[0],
           np.asarray(a, np.float64)[index], names[1],
           np.asarray(b, np.float64)[index]))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    return np.allclose(a, b, rtol=rtol or 1e-5, atol=atol or 1e-20,
                       equal_nan=equal_nan)


def assert_exception(f, exception_type, *args, **kwargs):
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError("Did not raise %s" % exception_type)


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    ctx = ctx or default_context()
    inputs = {k: array(v, ctx=ctx) for k, v in inputs.items()}
    exe = sym.bind(ctx, args=inputs)
    exe.forward(is_train=is_train)
    outputs = [o.asnumpy() for o in exe.outputs]
    return outputs[0] if len(outputs) == 1 else outputs


def _parse_location(sym, location, ctx, dtype=np.float32):
    assert isinstance(location, (dict, list, tuple))
    if isinstance(location, dict):
        if set(location.keys()) != set(sym.list_arguments()):
            raise ValueError("Symbol arguments and keys of the given location "
                             "do not match. symbol args:%s, location.keys():%s"
                             % (str(set(sym.list_arguments())),
                                str(set(location.keys()))))
    else:
        location = {k: v for k, v in zip(sym.list_arguments(), location)}
    location = {k: array(v, ctx=ctx, dtype=v.dtype if isinstance(v, np.ndarray)
                         and v.dtype.kind in "fiu" else dtype)
                if isinstance(v, np.ndarray) else
                (v if isinstance(v, NDArray) else array(v, ctx=ctx, dtype=dtype))
                for k, v in location.items()}
    return location


def _parse_aux_states(sym, aux_states, ctx, dtype=np.float32):
    if aux_states is not None:
        if isinstance(aux_states, dict):
            if set(aux_states.keys()) != set(sym.list_auxiliary_states()):
                raise ValueError("Symbol aux_states names and given aux_states "
                                 "do not match.")
        elif isinstance(aux_states, (list, tuple)):
            aux_names = sym.list_auxiliary_states()
            aux_states = {k: v for k, v in zip(aux_names, aux_states)}
        aux_states = {k: array(v, ctx=ctx, dtype=dtype)
                      if not isinstance(v, NDArray) else v
                      for k, v in aux_states.items()}
    return aux_states


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True, dtype=np.float32):
    """Finite-difference gradients through an executor (ref: test_utils.py:707)."""
    approx_grads = {k: np.zeros(v.shape, dtype=dtype)
                    for k, v in location.items()}
    for k, v in location.items():
        executor.arg_dict[k][:] = v
    for k in location:
        location[k] = np.array(location[k].asnumpy()
                               if isinstance(location[k], NDArray)
                               else location[k])  # writable copy
    for k, loc in location.items():
        if loc.dtype.kind in "ui":
            continue
        old_value = loc.copy()
        flat = loc.reshape(-1)
        for i in range(flat.size):
            # centered difference
            flat[i] = old_value.reshape(-1)[i] + eps / 2
            executor.arg_dict[k][:] = loc
            executor.forward(is_train=use_forward_train)
            f_peps = sum(o.asnumpy().sum() for o in executor.outputs)
            flat[i] = old_value.reshape(-1)[i] - eps / 2
            executor.arg_dict[k][:] = loc
            executor.forward(is_train=use_forward_train)
            f_neps = sum(o.asnumpy().sum() for o in executor.outputs)
            approx_grads[k].reshape(-1)[i] = (f_peps - f_neps) / eps
            flat[i] = old_value.reshape(-1)[i]
        executor.arg_dict[k][:] = old_value
    return approx_grads


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None,
                           grad_stype_dict=None, dtype=np.float32):
    """Verify symbolic gradients against finite differences
    (ref: test_utils.py:794)."""
    assert dtype in (np.float16, np.float32, np.float64)
    if ctx is None:
        ctx = default_context()

    def random_projection(shape):
        plain = _rng.rand(*shape) + 0.1
        return plain

    location = _parse_location(sym, location, ctx, dtype=dtype)
    location_npy = {k: v.asnumpy() for k, v in location.items()}
    aux_states = _parse_aux_states(sym, aux_states, ctx, dtype=dtype)
    aux_states_npy = None if aux_states is None else \
        {k: v.asnumpy() for k, v in aux_states.items()}
    # grad_nodes: None -> every argument; list -> those names; dict -> a
    # per-name grad_req map
    if isinstance(grad_nodes, dict):
        grad_req = dict(grad_nodes)
        grad_nodes = list(grad_req)
    else:
        grad_nodes = list(grad_nodes) if grad_nodes is not None \
            else sym.list_arguments()
        grad_req = dict.fromkeys(grad_nodes, "write")

    _, out_shape, _ = sym.infer_shape(
        **{k: v.shape for k, v in location.items()})
    proj = sym_mod.Variable("__random_proj")
    out = sym_mod.sum(sym * proj)
    out = sym_mod.MakeLoss(out)

    location = dict(location, __random_proj=array(
        random_projection(out_shape[0]), ctx=ctx, dtype=dtype))
    args_grad_npy = {k: _rng.normal(0, 0.01, size=location[k].shape)
                     for k in grad_nodes}
    args_grad = {k: array(v, ctx=ctx, dtype=dtype)
                 for k, v in args_grad_npy.items()}

    executor = out.bind(ctx, grad_req=grad_req, args=location,
                        args_grad=args_grad, aux_states=aux_states)

    inps = executor.arg_arrays
    executor.forward(is_train=True)
    executor.backward()
    symbolic_grads = {k: executor.grad_dict[k].asnumpy() for k in grad_nodes}

    numeric_gradients = numeric_grad(
        executor, location_npy, aux_states_npy, eps=numeric_eps,
        use_forward_train=use_forward_train, dtype=dtype)

    for name in grad_nodes:
        req = grad_req[name]
        labels = ("NUMERICAL_%s" % name, "BACKWARD_%s" % name)
        if req == "write":
            assert_almost_equal(numeric_gradients[name],
                                symbolic_grads[name], rtol, atol, labels)
        elif req == "add":
            assert_almost_equal(
                numeric_gradients[name],
                symbolic_grads[name] - args_grad_npy[name], rtol, atol,
                labels)
        elif req == "null":
            assert_almost_equal(args_grad_npy[name], symbolic_grads[name],
                                rtol, atol, labels)
        else:
            raise ValueError(req)


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None, equal_nan=False,
                           dtype=np.float32):
    """(ref: test_utils.py:926)"""
    assert dtype in (np.float16, np.float32, np.float64)
    if ctx is None:
        ctx = default_context()
    location = _parse_location(sym, location, ctx, dtype=dtype)
    aux_states = _parse_aux_states(sym, aux_states, ctx, dtype=dtype)
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym.list_outputs()]
    args_grad_data = {k: nd.empty(v.shape, ctx=ctx, dtype=dtype)
                      for k, v in location.items()}
    executor = sym.bind(ctx=ctx, args=location, args_grad=args_grad_data,
                        aux_states=aux_states)
    executor.forward(is_train=False)
    outputs = [x.asnumpy() for x in executor.outputs]
    for output_name, expect, output in zip(sym.list_outputs(), expected,
                                           outputs):
        assert_almost_equal(expect, output, rtol, atol,
                            ("EXPECTED_%s" % output_name,
                             "FORWARD_%s" % output_name),
                            equal_nan=equal_nan)
    return executor.outputs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None, grad_stypes=None, equal_nan=False,
                            dtype=np.float32):
    """(ref: test_utils.py:~1000)"""
    assert dtype in (np.float16, np.float32, np.float64)
    if ctx is None:
        ctx = default_context()
    location = _parse_location(sym, location, ctx, dtype=dtype)
    aux_states = _parse_aux_states(sym, aux_states, ctx, dtype=dtype)
    if isinstance(expected, (list, tuple)):
        expected = {k: v for k, v in zip(sym.list_arguments(), expected)}
    args_grad_npy = {k: _rng.normal(size=location[k].shape)
                     for k in expected}
    args_grad_data = {k: array(v, ctx=ctx, dtype=dtype)
                      for k, v in args_grad_npy.items()}
    if isinstance(grad_req, str):
        grad_req = {k: grad_req for k in sym.list_arguments()}
    elif isinstance(grad_req, (list, tuple)):
        grad_req = {k: v for k, v in zip(sym.list_arguments(), grad_req)}
    executor = sym.bind(ctx=ctx, args=location, args_grad=args_grad_data,
                        aux_states=aux_states, grad_req=grad_req)
    executor.forward(is_train=True)
    if isinstance(out_grads, (tuple, list)):
        out_grads = [array(v, ctx=ctx, dtype=dtype)
                     if not isinstance(v, NDArray) else v for v in out_grads]
    elif isinstance(out_grads, dict):
        out_grads = [array(out_grads[k], ctx=ctx, dtype=dtype)
                     for k in sym.list_outputs()]
    executor.backward(out_grads)
    grads = {k: v.asnumpy() for k, v in args_grad_data.items()}
    for name in expected:
        if grad_req[name] == "write":
            assert_almost_equal(expected[name], grads[name], rtol, atol,
                                ("EXPECTED_%s" % name, "BACKWARD_%s" % name),
                                equal_nan=equal_nan)
        elif grad_req[name] == "add":
            assert_almost_equal(expected[name],
                                grads[name] - args_grad_npy[name], rtol, atol,
                                ("EXPECTED_%s" % name, "BACKWARD_%s" % name),
                                equal_nan=equal_nan)
        elif grad_req[name] == "null":
            assert_almost_equal(args_grad_npy[name], grads[name], rtol, atol,
                                ("EXPECTED_%s" % name, "BACKWARD_%s" % name),
                                equal_nan=equal_nan)
        else:
            raise ValueError
    return args_grad_data


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, ground_truth=None, equal_nan=False):
    """Run a symbol on multiple contexts/dtypes and compare
    (ref: test_utils.py check_consistency — the cpu<->gpu model; here
    cpu<->gpu<->dtype consistency)."""
    if tol is None:
        tol = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
               np.dtype(np.float64): 1e-5, np.dtype(np.uint8): 0,
               np.dtype(np.int32): 0}
    elif isinstance(tol, numbers.Number):
        tol = {np.dtype(np.float16): tol, np.dtype(np.float32): tol,
               np.dtype(np.float64): tol, np.dtype(np.uint8): tol,
               np.dtype(np.int32): tol}
    assert len(ctx_list) > 1
    if isinstance(sym, sym_mod.Symbol):
        sym = [sym] * len(ctx_list)
    else:
        assert len(sym) == len(ctx_list)
    output_points = [len(s.list_outputs()) for s in sym]
    arg_names = sym[0].list_arguments()
    exe_list = []
    for s, ctx in zip(sym, ctx_list):
        assert s.list_arguments() == arg_names
        exe_list.append(s.simple_bind(grad_req=grad_req, **ctx))
    arg_params = {} if arg_params is None else arg_params
    aux_params = {} if aux_params is None else aux_params
    for n, arr in exe_list[0].arg_dict.items():
        if n not in arg_params:
            arg_params[n] = np.random.normal(
                size=arr.shape, scale=scale).astype(arr.dtype
                                                    if np.dtype(arr.dtype) != np.dtype(np.float16)
                                                    else np.float32)
    for n in exe_list[0].aux_dict:
        aux_params.setdefault(n, 0)
    for exe in exe_list:
        for name, arr in exe.arg_dict.items():
            arr[:] = np.asarray(arg_params[name]).astype(arr.dtype)
        for name, arr in exe.aux_dict.items():
            arr[:] = aux_params[name]
    dtypes = [np.dtype(exe.outputs[0].dtype) if exe.outputs else
              np.dtype(np.float32) for exe in exe_list]
    for exe in exe_list:
        exe.forward(is_train=False)
    dtypes = [np.dtype(exe.outputs[0].dtype) for exe in exe_list]
    max_idx = np.argmax([t.itemsize if t.kind == "f" else 8 for t in dtypes])
    gt = ground_truth
    if gt is None:
        gt = [o.asnumpy() for o in exe_list[max_idx].outputs]
    for i, exe in enumerate(exe_list):
        if i == max_idx and ground_truth is None:
            continue
        rtol = atol = tol[dtypes[i]]
        for name, arr, gtarr in zip(sym[i].list_outputs(), exe.outputs, gt):
            try:
                assert_almost_equal(arr.asnumpy(), gtarr, rtol=rtol, atol=atol,
                                    equal_nan=equal_nan)
            except AssertionError as e:
                print("Predict Err: ctx %d vs ctx %d at %s" % (i, max_idx, name))
                print(str(e))
                if raise_on_err:
                    raise
    return gt


def synthetic_image_dataset(shape_hw, channels, n, num_classes=10, seed=42,
                            what="dataset", root="<unset>"):
    """Canonical zero-egress dataset fallback: uint8 images + int labels in
    the real file format's shapes, announced with a LOUD warning (training
    on noise is chance-level).  Single source for MNISTIter, the gluon
    vision datasets, and get_mnist — sizes/seeds/warning live here only."""
    logging.getLogger(__name__).warning(
        "%s files not found under %s; using SYNTHETIC random data — "
        "accuracy will be chance-level", what, root)
    rng = np.random.RandomState(seed)
    h, w = shape_hw
    data = rng.randint(0, 256, (n, h, w, channels)).astype(np.uint8)
    label = rng.randint(0, num_classes, n).astype(np.int32)
    return data, label


def get_mnist(path=None):
    """Synthetic MNIST-format data when the real dataset is unavailable
    (zero-egress environment); shapes and dtypes match the real one."""
    rng = np.random.RandomState(42)
    n_train, n_test = 2048, 512
    train_data = rng.rand(n_train, 1, 28, 28).astype(np.float32)
    train_label = rng.randint(0, 10, n_train).astype(np.float32)
    test_data = rng.rand(n_test, 1, 28, 28).astype(np.float32)
    test_label = rng.randint(0, 10, n_test).astype(np.float32)
    return {"train_data": train_data, "train_label": train_label,
            "test_data": test_data, "test_label": test_label}


def get_mnist_iterator(batch_size, input_shape, num_parts=1, part_index=0):
    from .io import NDArrayIter
    mnist = get_mnist()
    flat = len(input_shape) == 1
    shape = (-1,) + tuple(input_shape)
    train = NDArrayIter(mnist["train_data"].reshape(shape),
                        mnist["train_label"], batch_size, shuffle=True)
    val = NDArrayIter(mnist["test_data"].reshape(shape),
                      mnist["test_label"], batch_size)
    return (train, val)


def list_gpus():
    return list(range(torch.cuda.device_count()))


def download(url, fname=None, dirname=None, overwrite=False):
    raise MXNetError("network access is not available in this environment")
