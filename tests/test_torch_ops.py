"""Each graph op of the LM serving slice, in the port against the JAX
package's registry op: forward values and shape inference.

Inputs come from a numpy seed and reach both packages as numpy arrays.
Tolerance f32 atol=rtol=1e-5 (same math, different summation order).
``multi_head_attention`` runs the JAX side through its Pallas flash
kernel in interpret mode (``MXNET_TPU_PALLAS_ATTN=1``, head_dim 128).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg

TOL = dict(atol=1e-5, rtol=1e-5)


def _r(seed):
    return np.random.RandomState(seed)


def _f32(r, *shape):
    return r.normal(0, 1, shape).astype(np.float32)


def _case(name):
    r = _r(sum(map(ord, name)))
    if name == "Embedding":
        ids = r.randint(0, 10, (2, 5)).astype(np.float32)
        return "Embedding", [ids, _f32(r, 10, 6)], \
            {"input_dim": 10, "output_dim": 6}
    if name == "expand_dims0":
        return "expand_dims", [_f32(r, 3, 4)], {"axis": 0}
    if name == "expand_dims-1":
        return "expand_dims", [_f32(r, 3, 4)], {"axis": -1}
    if name == "broadcast_add":
        return "broadcast_add", [_f32(r, 2, 3, 4), _f32(r, 1, 3, 4)], {}
    if name == "elemwise_add":
        return "elemwise_add", [_f32(r, 2, 3), _f32(r, 2, 3)], {}
    if name == "LayerNorm":
        return "LayerNorm", [_f32(r, 2, 3, 8), _f32(r, 8), _f32(r, 8)], \
            {"axis": -1, "eps": 1e-5}
    if name == "LayerNorm-mean-var":
        return "LayerNorm", [_f32(r, 2, 3, 8), _f32(r, 8), _f32(r, 8)], \
            {"output_mean_var": True}
    if name == "FC-flatten":
        return "FullyConnected", [_f32(r, 2, 3, 4), _f32(r, 5, 12),
                                  _f32(r, 5)], {"num_hidden": 5}
    if name == "FC-noflatten":
        return "FullyConnected", [_f32(r, 2, 3, 4), _f32(r, 5, 4),
                                  _f32(r, 5)], \
            {"num_hidden": 5, "flatten": False}
    if name == "FC-nobias":
        return "FullyConnected", [_f32(r, 2, 4), _f32(r, 5, 4)], \
            {"num_hidden": 5, "no_bias": True}
    if name.startswith("LeakyReLU-"):
        return "LeakyReLU", [_f32(r, 3, 7)], {"act_type": name[10:]}
    if name.startswith("mha"):
        e = 256
        ins = [_f32(r, 2, 8, e)] * 3
        for _ in range(4):
            ins += [_f32(r, e, e) * 0.05, _f32(r, e) * 0.05]
        attrs = {"num_heads": 2, "causal": "causal" in name}
        if name.endswith("lens"):
            ins.append(np.array([8, 3], np.float32))
            attrs["use_lengths"] = True
        return "multi_head_attention", ins, attrs
    if name == "sdpa":
        return "scaled_dot_product_attention", \
            [_f32(r, 2, 8, 2, 64) for _ in range(3)], {"causal": True}
    raise KeyError(name)


CASES = ["Embedding", "expand_dims0", "expand_dims-1", "broadcast_add",
         "elemwise_add", "LayerNorm", "LayerNorm-mean-var", "FC-flatten",
         "FC-noflatten", "FC-nobias", "LeakyReLU-gelu", "LeakyReLU-leaky",
         "LeakyReLU-elu", "LeakyReLU-selu", "mha", "mha-causal",
         "mha-causal-lens", "sdpa"]


@pytest.fixture
def pallas_attn(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_ATTN", "1")


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax(name, pallas_attn):
    op_name, ins, attrs = _case(name)
    jop, top = jreg.get_op(op_name), treg.get_op(op_name)
    want = jreg.apply_op(jop, [jnp.asarray(a) for a in ins],
                         jop.normalize_attrs(dict(attrs)))
    got = treg.apply_op(top, [torch.from_numpy(a) for a in ins],
                        top.normalize_attrs(dict(attrs)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_elemwise_add_rejects_unequal_shapes():
    op = treg.get_op("elemwise_add")
    with pytest.raises(mx.MXNetError):
        treg.apply_op(op, [torch.zeros(2, 3), torch.zeros(1, 3)], {})


def _build(pkg, name):
    """The case's op as a one-node graph over variables, in ``pkg``."""
    op_name, ins, attrs = _case(name)
    names = ["in%d" % i for i in range(len(ins))]
    out = getattr(pkg.sym, op_name)(*[pkg.sym.var(n) for n in names],
                                    name="node", **attrs)
    return out, {n: a.shape for n, a in zip(names, ins)}


@pytest.mark.parametrize("name", CASES)
def test_shape_inference_matches_jax(name):
    tsym, shapes = _build(mx, name)
    jsym = jmx.sym.load_json(tsym.tojson())
    # weights left unknown where the op's rule can fill them from data
    known = {"in0": shapes["in0"]}
    if name in ("broadcast_add", "elemwise_add", "sdpa"):
        known = shapes
    elif name.startswith("mha"):
        known = {n: shapes[n] for n in ("in0", "in1", "in2")}
    assert tsym.list_arguments() == jsym.list_arguments()
    got = tsym.infer_shape_partial(**known)
    want = jsym.infer_shape_partial(**known)

    def norm(groups):
        return [[None if s is None else tuple(int(d) for d in s) for s in g]
                for g in groups]

    assert norm(got) == norm(want)


@pytest.mark.parametrize("name", ["FC-noflatten", "LayerNorm", "mha-causal"])
def test_infer_type_matches_jax(name):
    tsym, _ = _build(mx, name)
    jsym = jmx.sym.load_json(tsym.tojson())
    got = tsym.infer_type(in0="float32")
    want = jsym.infer_type(in0="float32")
    assert [[str(np.dtype(t)) for t in g] for g in got] == \
        [[str(np.dtype(t)) for t in w] for w in want]
