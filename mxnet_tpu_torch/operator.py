"""Custom Python operators (parity: python/mxnet/operator.py CustomOp/
CustomOpProp + src/operator/custom/custom-inl.h).

Counterpart of ``mxnet_tpu/operator.py``.  The reference runs a custom op
through asynchronous C callbacks back into Python; the JAX package calls
the user's numpy code through ``jax.pure_callback`` under a
``custom_vjp``.  Here the ``Custom`` op is a ``torch.autograd.Function``:
its forward copies the inputs to the host, runs the user's ``forward`` on
numpy arrays (``in_data``) into slots (``out_data``, written with
``op.assign`` or ``dst[:] = src``), and copies the outputs back to the
inputs' device; its backward does the same with ``op.backward``.

As in the JAX package (caveat R17): ``in_data``/``out_data``/``out_grad``
are numpy arrays (MXNet 1.0 hands NDArrays, so ``.asnumpy()`` there
becomes ``np.asarray(...)``), and ``mx.sym.Custom`` creates no input that
the prop's ``list_arguments()`` names beyond those passed (pass a label
variable explicitly).  The outputs take the first input's dtype.  A host
round trip cannot be captured in a CUDA graph, so the fused train step
refuses a graph holding a ``Custom`` node on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ops import registry as _registry

__all__ = ["CustomOp", "CustomOpProp", "register_op", "register",
           "get_prop"]


class CustomOp:
    """Base class for custom operator implementations."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        if req in ("write", "inplace", "add"):
            if req == "add":
                dst[:] = dst[:] + src if hasattr(dst, "__getitem__") else src
            else:
                dst[:] = src


class CustomOpProp:
    """Describes a custom op's signature (ref: operator.py:CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


_PROP_REGISTRY = {}


def register_op(reg_name):
    """Decorator: register a CustomOpProp under op_type=reg_name
    (ref: mx.operator.register)."""

    def do_register(prop_cls):
        _PROP_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return do_register


# the reference's name is mx.operator.register (the JAX package's
# ``operator.register`` is its op registry's ``register``, which
# registers no prop: R17); ``register_cls`` is the JAX package's alias
register = register_cls = register_op


def get_prop(op_type):
    cls = _PROP_REGISTRY.get(op_type)
    if cls is None:
        raise MXNetError("custom op type %r is not registered" % op_type)
    return cls()


class _Slot:
    """An output or input-gradient buffer handed to the user's code:
    ``slot[:] = src`` (numpy, or anything with ``asnumpy``) replaces it,
    ``slot[key] = src`` writes part of it."""
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __setitem__(self, key, src):
        src = np.asarray(src.asnumpy() if hasattr(src, "asnumpy") else src)
        if key == slice(None):
            self.value = src.astype(self.value.dtype, copy=False)
        else:
            v = self.value.copy()
            v[key] = src
            self.value = v

    def __getitem__(self, key):
        return self.value[key]

    def asnumpy(self):
        return self.value


def _host(t):
    """A tensor's values as a numpy array on the host."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _back(value, like):
    """A numpy result as a tensor of ``like``'s device and dtype."""
    t = torch.from_numpy(np.ascontiguousarray(value))
    return t.to(device=like.device, dtype=like.dtype)


class _CustomFunction(torch.autograd.Function):
    """The ``Custom`` op under torch autograd: the user's forward and
    backward on host copies of the tensors."""

    @staticmethod
    def forward(ctx, prop, is_train, *xs):
        n_out = len(prop.list_outputs())
        in_shapes = [tuple(x.shape) for x in xs]
        _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
        ins = [_host(x) for x in xs]
        op = prop.create_operator(None, in_shapes, [a.dtype for a in ins])
        dtype = ins[0].dtype
        outs = [_Slot(np.zeros(tuple(int(d) for d in s), dtype))
                for s in out_shapes]
        op.forward(is_train=is_train, req=["write"] * n_out, in_data=ins,
                   out_data=outs, aux=[])
        ctx.prop, ctx.in_shapes = prop, in_shapes
        ctx.host = (ins, [o.value for o in outs])
        ctx.likes = [x.detach() for x in xs]
        return tuple(_back(o.value, xs[0]) for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        ins, outs = ctx.host
        op = ctx.prop.create_operator(None, ctx.in_shapes,
                                      [a.dtype for a in ins])
        igrads = [_Slot(np.zeros_like(a)) for a in ins]
        op.backward(req=["write"] * len(ins), out_grad=[_host(g) for g in gs],
                    in_data=ins, out_data=outs, in_grad=igrads, aux=[])
        return (None, None) + tuple(_back(g.value, x)
                                    for g, x in zip(igrads, ctx.likes))


def _custom_impl(*tensors, op_type=None, _train=False):
    """Custom op compute: the user's Python forward (and, under autograd,
    backward) on host copies of the inputs."""
    prop = get_prop(op_type)
    out = _CustomFunction.apply(prop, bool(_train), *tensors)
    return out if len(out) > 1 else out[0]


def _custom_infer_shape(in_shapes, attrs):
    if any(s is None for s in in_shapes):
        return in_shapes, None
    prop = get_prop(attrs["op_type"])
    ins, outs, _ = prop.infer_shape([list(s) for s in in_shapes])
    return [tuple(s) for s in ins], [tuple(s) for s in outs]


_registry.register("Custom", _custom_impl, num_inputs=None,
                   num_outputs=lambda attrs: len(
                       get_prop(attrs["op_type"]).list_outputs()),
                   infer_shape=_custom_infer_shape,
                   takes_train_flag=True,
                   params={"op_type": (_registry.pStr, None)})
