"""Parity of the port's dense op surface (``mxnet_tpu_torch/ops/extra.py``)
with the JAX package's (``mxnet_tpu/ops/extra.py``), on the host.

The same numpy inputs go through both packages' registered op impls
(``_run_both`` of ``tests/test_torch_train_ops.py``: the JAX side as one
jitted program with its ``jax.vjp``, the port's with torch autograd, one
random cotangent).  Tolerances: forward outputs within 1e-4 relative to
each output's largest magnitude, gradients within 1e-3; the identity
sampling grid bit for bit.  ``syevd``'s eigenvectors are unique only up to
sign, so it is compared through sign-invariant quantities.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx  # noqa: F401  (registers the JAX package's ops)
from mxnet_tpu.ops import extra as jextra
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import extra as textra
from mxnet_tpu_torch.ops.registry import get_op as port_op

from test_op_sweep import CASES
from test_torch_train_ops import _run_both

FWD_REL = 1e-4
GRAD_REL = 1e-3

# the op-sweep cases of the ops this file's module ports
A4A_SWEEP = ("smooth_l1", "depth_to_space", "space_to_depth", "khatri_rao",
             "Crop", "linalg_gemm", "linalg_gemm2", "linalg_syrk",
             "linalg_potrf", "linalg_potri", "linalg_trmm", "linalg_trsm",
             "linalg_sumlogdiag", "IdentityAttachKLSparseReg",
             "GridGenerator", "BilinearSampler", "SpatialTransformer",
             "ROIPooling", "Correlation")
SWEEP_CASES = [(name, i, c) for name in A4A_SWEEP
               for i, c in enumerate(CASES[name])]


def _close(got, want, rel):
    """Within ``rel`` relative to the reference's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _check_both(results, fwd=FWD_REL, grad=GRAD_REL):
    outs_j, outs_t, grads_j, grads_t = results
    assert len(outs_j) == len(outs_t)
    for a, b in zip(outs_j, outs_t):
        _close(b, a, fwd)
    for a, b in zip(grads_j, grads_t):
        _close(b, a, grad)


def test_the_sweep_covers_nineteen_cases():
    assert len(SWEEP_CASES) == 19


@pytest.mark.parametrize("name, i, case", SWEEP_CASES,
                         ids=["%s-%d" % (n, i) for n, i, _ in SWEEP_CASES])
def test_op_sweep_case_forward_and_gradients(name, i, case):
    """Each of the sweep's cases: outputs within 1e-4 relative, the
    autograd gradients of every input within 1e-3."""
    _check_both(_run_both(name, [np.asarray(x) for x in case.inputs],
                          case.attrs))


def _spd(rng, n, batch=()):
    a = rng.rand(*batch, n, n)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _nonsymmetric_spd(rng, n):
    """An SPD matrix with one upper entry moved: ``torch.linalg`` alone
    would read one triangle, the JAX package symmetrizes."""
    a = _spd(rng, n)
    a[0, n - 1] += 0.7
    return a


@pytest.mark.parametrize("name", ["linalg_potrf", "linalg_sumlogdiag"])
def test_potrf_factors_the_symmetrized_input(name):
    rng = np.random.RandomState(3)
    a = _nonsymmetric_spd(rng, 4)
    if name == "linalg_sumlogdiag":
        a = np.linalg.cholesky((a + a.T) / 2).astype(np.float32)
    _check_both(_run_both(name, [a], {}))
    if name == "linalg_potrf":
        sym = np.linalg.cholesky((a + a.T) / 2)
        got = port_op(name).impl(torch.tensor(a)).numpy()
        _close(got, sym, FWD_REL)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rightside", [False, True])
def test_trsm_keeps_the_jax_triangle_rule(transpose, rightside):
    """All four ``transpose``/``rightside`` combinations on a full (not
    triangular) A: the solve reads the triangle the JAX package reads."""
    rng = np.random.RandomState(5)
    a = (rng.rand(2, 4, 4) + 3 * np.eye(4)).astype(np.float32)
    b = rng.randn(2, 4, 3).astype(np.float32)
    if rightside:
        b = np.swapaxes(b, -1, -2).copy()
    _check_both(_run_both("linalg_trsm", [a, b],
                          {"transpose": transpose, "rightside": rightside,
                           "alpha": 1.5}))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rightside", [False, True])
def test_trmm_both_sides(transpose, rightside):
    rng = np.random.RandomState(6)
    a = np.tril(rng.rand(4, 4) + 0.5).astype(np.float32)
    b = rng.randn(4, 4).astype(np.float32)
    _check_both(_run_both("linalg_trmm", [a, b],
                          {"transpose": transpose, "rightside": rightside,
                           "alpha": -0.5}))


def test_gemm_transposes_and_syrk_transpose():
    rng = np.random.RandomState(7)
    a, b, c = (rng.randn(2, 3, 4).astype(np.float32),
               rng.randn(2, 3, 5).astype(np.float32),
               rng.randn(2, 4, 5).astype(np.float32))
    _check_both(_run_both("linalg_gemm", [a, b, c],
                          {"transpose_a": True, "alpha": 0.5, "beta": 2.0}))
    _check_both(_run_both("linalg_gemm2", [b, c],
                          {"transpose_b": True, "alpha": 3.0}))
    _check_both(_run_both("linalg_syrk", [a], {"transpose": True,
                                               "alpha": 0.25}))


def test_gelqf_signs_and_factors():
    """L @ Q = A, Q with orthonormal rows, diag(L) >= 0, and both factors
    the JAX package's (LQ with a non-negative diagonal is unique)."""
    rng = np.random.RandomState(8)
    a = rng.randn(2, 3, 5).astype(np.float32)
    _check_both(_run_both("linalg_gelqf", [a], {}))
    q, l_ = port_op("linalg_gelqf").impl(torch.tensor(a))
    q, l_ = q.numpy(), l_.numpy()
    assert (np.diagonal(l_, axis1=-2, axis2=-1) >= 0).all()
    _close(l_ @ q, a, FWD_REL)
    _close(q @ np.swapaxes(q, -1, -2), np.broadcast_to(np.eye(3), (2, 3, 3)),
           FWD_REL)


def test_syevd_up_to_sign_on_a_nonsymmetric_input():
    """Eigenvalues, U^T diag(L) U, |U|, and the gradient of a loss blind
    to the eigenvectors' signs, against the JAX package; the input's upper
    entry moved, so both factor the symmetrized matrix."""
    rng = np.random.RandomState(9)
    a = np.stack([_nonsymmetric_spd(rng, 4) for _ in range(2)])
    cu = rng.randn(4, 4).astype(np.float32)
    cw = rng.randn(4).astype(np.float32)

    def jloss(x):
        u, w = jextra._linalg_syevd(x)
        return jnp.sum(u * u * cu) + jnp.sum(w * cw), (u, w)

    (jl, (ju, jw)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(a))
    t = torch.tensor(a, requires_grad=True)
    tu, tw = port_op("linalg_syevd").impl(t)
    tl = (tu * tu * torch.tensor(cu)).sum() + (tw * torch.tensor(cw)).sum()
    (tg,) = torch.autograd.grad(tl, t)
    tu, tw = tu.detach().numpy(), tw.detach().numpy()
    _close(tw, np.asarray(jw), FWD_REL)
    assert (np.diff(tw, axis=-1) >= 0).all()
    recon = np.swapaxes(tu, -1, -2) @ (tw[..., :, None] * tu)
    _close(recon, (a + np.swapaxes(a, -1, -2)) / 2, FWD_REL)
    _close(np.abs(tu), np.abs(np.asarray(ju)), FWD_REL)
    _close(tl.item(), float(jl), FWD_REL)
    _close(tg.numpy(), np.asarray(jg), GRAD_REL)


def test_host_linspace_is_jnp_linspace_bit_for_bit():
    for n in range(1, 130):
        np.testing.assert_array_equal(textra._host_linspace(n).numpy(),
                                      np.asarray(jnp.linspace(-1, 1, n)))


@pytest.mark.parametrize("shape", [(28, 28), (5, 9)])
def test_identity_grid_is_the_jax_grid_bit_for_bit(shape):
    """The JAX package's affine grid is float64 (x64 is on); the port's
    sampling grid is the same float64 array, and ``GridGenerator`` returns
    it rounded to the parameters' float32."""
    theta = np.tile(np.array([[1, 0, 0, 0, 1, 0]], np.float32), (3, 1))
    attrs = {"transform_type": "affine", "target_shape": shape}
    want = np.asarray(jextra._grid_generator(jnp.asarray(theta), **attrs))
    assert want.dtype == np.float64
    grid = textra._affine_grid(torch.tensor(theta), *shape)
    np.testing.assert_array_equal(grid.numpy(), want)
    got = port_op("GridGenerator").impl(torch.tensor(theta), **attrs)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_grid_generator_warp_and_a_general_affine():
    rng = np.random.RandomState(10)
    flow = rng.randn(2, 2, 4, 5).astype(np.float32)
    _check_both(_run_both("GridGenerator", [flow],
                          {"transform_type": "warp", "target_shape": (4, 5)}))
    theta = (rng.randn(2, 6) * 0.3).astype(np.float32)
    _check_both(_run_both("GridGenerator", [theta],
                          {"transform_type": "affine",
                           "target_shape": (6, 7)}))


def test_bilinear_sampler_gradients_away_from_integer_coordinates():
    """Gradients with respect to the data and the grid; the grid's sample
    points sit a third of a cell off the lattice, some outside the plane
    (those taps read 0)."""
    rng = np.random.RandomState(11)
    data = rng.randn(2, 3, 5, 6).astype(np.float32)
    ys, xs = np.meshgrid(np.linspace(-1.1, 1.1, 4), np.linspace(-1.2, 1.05, 7),
                         indexing="ij")
    grid = np.stack([xs, ys])[None].repeat(2, 0)
    grid = (grid + 1 / 3 * 2 / np.array([5, 4])[None, :, None, None]
            ).astype(np.float32)
    _check_both(_run_both("BilinearSampler", [data, grid], {}))


def test_spatial_transformer_gradient_to_the_affine_parameters():
    rng = np.random.RandomState(12)
    data = rng.randn(2, 2, 6, 6).astype(np.float32)
    loc = np.array([[0.9, 0.1, 0.05, -0.1, 1.1, -0.05],
                    [1.0, -0.2, 0.1, 0.15, 0.8, 0.02]], np.float32)
    _check_both(_run_both("SpatialTransformer", [data, loc],
                          {"target_shape": (5, 4)}))


def test_roi_pooling_splits_the_gradient_over_tied_maxima(monkeypatch):
    """Bins after a ReLU: all-zero bins and bins with repeated maxima, two
    overlapping ROIs of one image, an ROI past the border, a second
    image; chunks of one ROI (so the backward accumulates across chunks).
    A separable row-then-column max would split these ties differently."""
    monkeypatch.setattr(textra, "_ROI_CHUNK_ELEMS", 1)
    rng = np.random.RandomState(13)
    data = np.maximum(rng.randn(2, 3, 8, 9), 0).astype(np.float32)
    data[0, :, 0:4, 0:4] = 0.0          # a plane of ties
    data[1, 1, 2:4, 2:6] = 2.5          # a block of equal maxima
    rois = np.array([[0, 0, 0, 7, 7], [0, 1, 1, 5, 6], [1, 0, 0, 8, 7],
                     [1, 2, 3, 12, 11], [0, 3, 2, 3, 2]], np.float32)
    results = _run_both("ROIPooling", [data, rois],
                        {"pooled_size": (3, 2), "spatial_scale": 1.0})
    _check_both(results)
    assert np.count_nonzero(results[3][0]) > 0


def test_roi_pooling_scaled_rois_and_empty_bins():
    rng = np.random.RandomState(14)
    data = rng.randn(1, 4, 6, 7).astype(np.float32)
    rois = np.array([[0, 4, 4, 60, 40], [0, 0, 0, 15, 15],
                     [0, 80, 80, 95, 95]], np.float32)
    _check_both(_run_both("ROIPooling", [data, rois],
                          {"pooled_size": (4, 4), "spatial_scale": 0.0625}))


@pytest.mark.parametrize("attrs", [
    dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2, pad_size=2),
    dict(kernel_size=3, max_displacement=1, stride1=1, stride2=1, pad_size=1,
         is_multiply=False),
    dict(kernel_size=1, max_displacement=4, stride1=3, stride2=2, pad_size=4),
])
def test_correlation_kernel_three_and_strides(attrs):
    rng = np.random.RandomState(15)
    a = rng.randn(2, 3, 9, 10).astype(np.float32)
    b = rng.randn(2, 3, 9, 10).astype(np.float32)
    _check_both(_run_both("Correlation", [a, b], attrs))


def test_crop_like_input_and_centre_crop():
    """With a second, "like" input the crop takes its spatial size, and
    its gradient is 0 in both packages."""
    rng = np.random.RandomState(16)
    x = rng.randn(2, 3, 7, 8).astype(np.float32)
    like = rng.randn(2, 1, 4, 5).astype(np.float32)
    results = _run_both("Crop", [x, like], {"center_crop": True,
                                            "num_args": 2})
    _check_both(results)
    assert not results[3][1].any()
    _check_both(_run_both("Crop", [x], {"offset": (1, 2), "h_w": (3, 4)}))


def test_identity_attach_kl_sparse_reg_is_the_identity_both_ways():
    x = torch.randn(3, 4, requires_grad=True)
    y = port_op("IdentityAttachKLSparseReg").impl(x, penalty=0.5)
    g = torch.randn(3, 4)
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(y, x) and torch.equal(dx, g)


def test_shape_rules_through_a_symbol():
    """SpatialTransformer fills its ``loc`` input from the data; ROIPooling,
    Crop, GridGenerator, gelqf, syevd and khatri_rao give the JAX package's
    shapes."""
    for pkg in (mx, jmx):
        d, r = pkg.sym.var("data"), pkg.sym.var("rois")
        st = pkg.sym.SpatialTransformer(d, pkg.sym.var("loc"),
                                        target_shape=(5, 6))
        args, outs, _ = st.infer_shape(data=(2, 3, 8, 8))
        assert args[1] == (2, 6) and outs == [(2, 3, 5, 6)]
        roi = pkg.sym.ROIPooling(d, r, pooled_size=(2, 3),
                                 spatial_scale=0.5)
        assert roi.infer_shape(data=(1, 4, 8, 8), rois=(5, 5))[1] == \
            [(5, 4, 2, 3)]
        q = pkg.sym.linalg.gelqf(d)
        assert q.infer_shape(data=(2, 3, 5))[1] == [(2, 3, 5), (2, 3, 3)]
        kr = pkg.sym.khatri_rao(d, r)
        assert kr.infer_shape(data=(2, 3), rois=(4, 3))[1] == [(8, 3)]
