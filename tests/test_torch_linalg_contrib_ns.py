"""The port's ``nd.linalg``, ``sym.linalg``, ``nd.contrib`` and
``sym.contrib`` namespaces and its registry's name -> Op map for the dense
op surface, against the JAX package's.

The contrib namespaces hold the same names in both packages, the seven
detection ops of ``ops/detection_ops.py`` included.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg

# the JAX package's contrib ops the port does not register yet
NOT_YET = set()

# the dense op surface's canonical names and every alias
DENSE_NAMES = (
    ["linalg_" + n for n in ("gemm", "gemm2", "potrf", "potri", "trsm",
                             "trmm", "syrk", "sumlogdiag", "gelqf", "syevd")]
    + ["_linalg_" + n for n in ("gemm", "gemm2", "potrf", "potri", "trsm",
                                "trmm", "syrk", "sumlogdiag", "gelqf",
                                "syevd")]
    + ["khatri_rao", "_contrib_khatri_rao", "_contrib_krprod", "Crop",
       "smooth_l1", "depth_to_space", "space_to_depth", "BilinearSampler",
       "GridGenerator", "SpatialTransformer", "Correlation", "ROIPooling",
       "IdentityAttachKLSparseReg",
       "_contrib_box_iou", "box_iou", "_contrib_box_nms", "box_nms",
       "_contrib_MultiBoxPrior", "MultiBoxPrior", "_contrib_MultiBoxTarget",
       "MultiBoxTarget", "_contrib_MultiBoxDetection", "MultiBoxDetection",
       "_contrib_quantize", "quantize", "_contrib_dequantize", "dequantize",
       "_contrib_fft", "fft", "_contrib_ifft", "ifft"])


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")
            and callable(getattr(module, n))} - {"populate", "make_getattr"}


@pytest.mark.parametrize("ns", ["nd.linalg", "sym.linalg", "nd.contrib",
                                "sym.contrib"])
def test_namespace_names_match_the_jax_package(ns):
    front, sub = ns.split(".")
    port = _public(getattr(getattr(mx, front), sub))
    jax_names = _public(getattr(getattr(jmx, front), sub))
    want_missing = NOT_YET if sub == "contrib" else set()
    assert jax_names - port == want_missing
    assert port - jax_names == set()


def test_the_name_to_op_map_of_the_dense_surface():
    """Every name and alias resolves to an Op of the JAX package's
    canonical name, and two names share an Op in the port exactly when
    they do in the JAX registry: ``_contrib_khatri_rao`` is the 2-D Op
    (no shape rule), distinct from ``khatri_rao`` and ``_contrib_krprod``."""
    jr, tr = jreg.op_registry(), treg.op_registry()
    assert len(DENSE_NAMES) == 51
    # the list is closed under the JAX registry's aliases: 30 ops
    ops = {id(jr[n]) for n in DENSE_NAMES}
    assert {n for n, op in jr.items() if id(op) in ops} == set(DENSE_NAMES)
    assert len({jr[n].name for n in DENSE_NAMES}) == 30
    for name in DENSE_NAMES:
        assert tr[name].name == jr[name].name, name
        assert tr[name].num_outputs == jr[name].num_outputs, name
        assert set(tr[name].params) == set(jr[name].params), name
        assert (tr[name].infer_shape is None) == \
            (jr[name].infer_shape is None) or name.endswith(
                ("box_nms", "MultiBoxPrior", "MultiBoxTarget",
                 "MultiBoxDetection")), name
    for a in DENSE_NAMES:
        for b in DENSE_NAMES:
            assert (tr[a] is tr[b]) == (jr[a] is jr[b]), (a, b)
    assert tr["_contrib_khatri_rao"] is not tr["khatri_rao"]
    assert tr["_contrib_krprod"] is tr["khatri_rao"]
    assert tr["_contrib_khatri_rao"].infer_shape is None


def test_param_defaults_match_the_jax_registry():
    """Defaults agree, but for the MultiBox float tuples, which the port
    keeps as floats (ROADMAP R14): equal in value."""
    jr, tr = jreg.op_registry(), treg.op_registry()
    for name in DENSE_NAMES:
        for k, (_, default) in jr[name].params.items():
            assert tr[name].params[k][1] == default, (name, k)


def test_contrib_khatri_rao_is_two_d_and_khatri_rao_is_batched():
    a = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                    ctx=mx.cpu())
    b = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3),
                    ctx=mx.cpu())
    for fn in (mx.nd.khatri_rao, mx.nd.contrib.khatri_rao,
               mx.nd.contrib.krprod):
        out = fn(a, b).asnumpy()
        want = np.einsum("ik,jk->ijk", a.asnumpy(), b.asnumpy()).reshape(8, 3)
        np.testing.assert_array_equal(out, want)
    batched = torch.arange(12.0).reshape(2, 2, 3)
    out = treg.get_op("khatri_rao").impl(batched, batched)
    assert tuple(out.shape) == (2, 4, 3)


def test_linalg_through_nd_and_sym():
    rng = np.random.RandomState(0)
    a = rng.rand(3, 3).astype(np.float32)
    spd = a @ a.T + 3 * np.eye(3, dtype=np.float32)
    x = mx.nd.array(spd, ctx=mx.cpu())
    chol = mx.nd.linalg.potrf(x).asnumpy()
    np.testing.assert_allclose(chol @ chol.T, spd, rtol=1e-5, atol=1e-5)
    inv = mx.nd.linalg.potri(mx.nd.linalg.potrf(x)).asnumpy()
    np.testing.assert_allclose(inv @ spd, np.eye(3), rtol=1e-4, atol=1e-4)
    s = mx.sym.linalg.sumlogdiag(mx.sym.linalg.potrf(mx.sym.var("A")))
    ex = s.simple_bind(mx.cpu(), A=(3, 3), grad_req="null")
    out = ex.forward(is_train=False, A=x)[0].asnumpy()
    np.testing.assert_allclose(out, np.log(np.diag(chol)).sum(), rtol=1e-6)
    u, lam = mx.sym.linalg.syevd(mx.sym.var("A"))
    assert mx.sym.Group([u, lam]).infer_shape(A=(2, 4, 4))[1] == \
        [(2, 4, 4), (2, 4)]


def test_contrib_through_nd_and_sym():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8).astype(np.float32)
    got = mx.nd.contrib.fft(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    want = jmx.nd.contrib.fft(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    s = mx.sym.contrib.box_nms(mx.sym.var("d"), overlap_thresh=0.5)
    assert s.infer_shape(d=(2, 10, 6))[1] == [(2, 10, 6)]
    q = mx.sym.contrib.quantize(mx.sym.var("d"), mx.sym.var("lo"),
                                mx.sym.var("hi"))
    assert len(q.list_outputs()) == 3
