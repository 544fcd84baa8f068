"""The dense op surface: spatial transformer, ROIPooling, Correlation,
Crop, depth/space, smooth_l1, the linalg ops and khatri_rao.

Counterpart of ``mxnet_tpu/ops/extra.py`` (its optimizer update ops live in
``ops/optimizer_ops.py``).  The JAX package computes every op here in
``jnp``/``lax`` outside any Pallas kernel; the port computes them in torch
ops (cuBLAS and cuSOLVER behind ``torch.linalg`` on the card), each the
same function as the JAX op and differentiable by torch autograd where
the JAX op is by ``jax.vjp``.  Names, aliases, inputs, attrs, defaults,
output counts and shape rules follow the JAX registry, ``khatri_rao``'s
two registrations included.

Three choices keep the card's results the host's:

- The affine grid is the JAX package's, which is float64 (its
  ``jnp.linspace`` is, under x64): the port builds the ``linspace`` on
  the host, bit for bit, keeps it on each device once (a host-to-device
  copy cannot run inside a CUDA-graph capture), takes the affine product
  elementwise in float64, not as a GEMM, and samples at float64
  coordinates.  At the identity transform the coordinates are
  near-integers, so the side ``floor`` falls on decides which cell the
  grid's gradient goes through.  The outputs are in the data's type,
  where the JAX package's are float64 (ROADMAP R15).
- ``ROIPooling`` never materialises the JAX package's per-bin mask over
  the whole plane (``R x C x bins x H x W``): it walks the ROIs in chunks
  and recomputes each chunk's bins in its backward, which splits a bin's
  cotangent equally over every tied maximum, as JAX's ``max`` VJP does.
- ``linalg_potrf`` and ``linalg_syevd`` factor ``(A + A^T) / 2``, as
  ``jnp.linalg.cholesky`` and ``jnp.linalg.eigh`` do (``torch.linalg``
  reads one triangle only).
"""
from __future__ import annotations

import functools
from fractions import Fraction

import torch
import torch.nn.functional as F

from .registry import pBool, pFloat, pInt, pShape, pStr, register


def _div(t, d):
    """``t / d`` for a Python number ``d``, rounded once on every device
    (divided by a host scalar, the card multiplies by its reciprocal)."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# Bilinear sampling family (ref: bilinear_sampler-inl.h, grid_generator-
# inl.h, spatial_transformer-inl.h)
# ---------------------------------------------------------------------------

def _bilinear_sample(data, grid):
    """data [N,C,H,W], grid [N,2,Ho,Wo] with x,y in [-1,1] -> [N,C,Ho,Wo]
    in the promoted type of data and grid, as the JAX package's; taps
    outside the plane read 0."""
    N, C, H, W = data.shape
    Ho, Wo = grid.shape[2], grid.shape[3]
    x = (grid[:, 0] + 1) * (W - 1) / 2   # [N, Ho, Wo]
    y = (grid[:, 1] + 1) * (H - 1) / 2
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    wx1 = x - x0
    wy1 = y - y0
    flat = data.reshape(N, C, H * W)

    def gather(yy, xx):
        yi = yy.clamp(0, H - 1).to(torch.int64)
        xi = xx.clamp(0, W - 1).to(torch.int64)
        ok = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        idx = (yi * W + xi).reshape(N, 1, Ho * Wo).expand(N, C, Ho * Wo)
        vals = torch.gather(flat, 2, idx).reshape(N, C, Ho, Wo)
        return vals * ok[:, None].to(data.dtype)

    v00 = gather(y0, x0)
    v01 = gather(y0, x1)
    v10 = gather(y1, x0)
    v11 = gather(y1, x1)
    wx1e = wx1[:, None]
    wy1e = wy1[:, None]
    return (v00 * (1 - wx1e) * (1 - wy1e) + v01 * wx1e * (1 - wy1e) +
            v10 * (1 - wx1e) * wy1e + v11 * wx1e * wy1e)


register("BilinearSampler",
         lambda data, grid: _bilinear_sample(data, grid).to(data.dtype),
         input_names=("data", "grid"))


def _host_linspace(n):
    """The JAX package's ``jnp.linspace(-1, 1, n)`` as XLA:CPU computes it,
    in float64 (the JAX package runs with x64 on): ``start * (1 - step) +
    stop * step`` with ``step = i * (1 / (n - 1))``, the product and the sum
    fused into one rounding, ``fl(i * r - fl(1 - fl(i * r)))``, then the end
    point.  Bit for bit ``jnp.linspace`` for every n up to 129 (tested);
    XLA's vectorized loop rounds a few points of longer ones differently,
    by one unit in the last place."""
    if n == 1:
        return torch.tensor([-1.0], dtype=torch.float64)
    r = 1.0 / (n - 1)
    pts = [float(Fraction(i) * Fraction(r) - Fraction(1.0 - i * r))
           for i in range(n - 1)]
    return torch.tensor(pts + [1.0], dtype=torch.float64)


@functools.lru_cache(maxsize=64)
def _linspace(n, device):
    """:func:`_host_linspace` on ``device``, made once (callers never
    write it)."""
    return _host_linspace(n).to(device)


def _affine_grid(theta, H, W):
    """The sampling grid [N, 2, H, W] of affine parameters [N, 6] in
    float64, as the JAX package computes it (its ``linspace`` is float64,
    so the whole grid is): each row ``theta_i0 * x + theta_i1 * y +
    theta_i2``, the three terms summed in order, elementwise rather than
    as a GEMM."""
    N = theta.shape[0]
    t = theta.reshape(N, 2, 3, 1, 1).to(torch.float64)
    if theta.device.type == "meta":
        xs = torch.empty(W, dtype=torch.float64, device="meta")
        ys = torch.empty(H, dtype=torch.float64, device="meta")
    else:
        xs, ys = _linspace(W, theta.device), _linspace(H, theta.device)
    return t[:, :, 0] * xs.reshape(1, 1, 1, W) \
        + t[:, :, 1] * ys.reshape(1, 1, H, 1) + t[:, :, 2]


def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: data [N, 6] -> sampling grid [N, 2, H, W];
    warp: data [N, 2, H, W] flow -> grid.  In the data's type (the JAX
    package's affine grid stays float64; ROADMAP R15)."""
    H, W = int(target_shape[0]), int(target_shape[1])
    if transform_type == "affine":
        return _affine_grid(data, H, W).to(data.dtype)
    # warp: flow field added to the identity grid, normalized
    N, _, Hf, Wf = data.shape
    ys = torch.arange(Hf, dtype=data.dtype, device=data.device)
    xs = torch.arange(Wf, dtype=data.dtype, device=data.device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    x = _div((xg + data[:, 0]) * 2, max(Wf - 1, 1)) - 1
    y = _div((yg + data[:, 1]) * 2, max(Hf - 1, 1)) - 1
    return torch.stack([x, y], dim=1)


def _grid_infer_shape(in_shapes, attrs):
    d = in_shapes[0]
    if d is None:
        return in_shapes, None
    if attrs.get("transform_type", "affine") == "affine":
        H, W = attrs["target_shape"]
        return in_shapes, [(d[0], 2, int(H), int(W))]
    return in_shapes, [d]


register("GridGenerator", _grid_generator, num_inputs=1,
         infer_shape=_grid_infer_shape,
         params={"transform_type": (pStr, "affine"),
                 "target_shape": (pShape, (0, 0))})


def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear"):
    """The data sampled at the affine grid of ``loc``, the grid and the
    sampling weights in float64 as in the JAX package, the output in the
    data's type (the JAX package's is float64; ROADMAP R15)."""
    grid = _affine_grid(loc, int(target_shape[0]), int(target_shape[1]))
    return _bilinear_sample(data, grid).to(data.dtype)


def _st_infer_shape(in_shapes, attrs):
    d = in_shapes[0]
    if d is None:
        return in_shapes, None
    H, W = attrs["target_shape"]
    filled = list(in_shapes)
    filled[1] = (d[0], 6)
    return filled, [(d[0], d[1], int(H), int(W))]


register("SpatialTransformer", _spatial_transformer,
         input_names=("data", "loc"), infer_shape=_st_infer_shape,
         params={"target_shape": (pShape, (0, 0)),
                 "transform_type": (pStr, "affine"),
                 "sampler_type": (pStr, "bilinear")})


# ---------------------------------------------------------------------------
# ROIPooling (ref: roi_pooling-inl.h)
# ---------------------------------------------------------------------------

# elements of one chunk's widest temporary (ROIs x channels x bins x
# plane): bounds the memory a chunk takes, whatever the ROI count
_ROI_CHUNK_ELEMS = 1 << 27


def _roi_masks(rois, n_batch, H, W, ph, pw, spatial_scale, dtype):
    """Each ROI's batch index [R] and its bins' row and column masks,
    [R, ph, H] and [R, pw, W]: bin (py, px) covers rows ``floor(y1 + py *
    bin_h) <= y < ceil(y1 + (py + 1) * bin_h)`` and likewise columns, the
    JAX package's arithmetic in the data's dtype."""
    dev = rois.device
    b = rois[:, 0].to(torch.int64)
    # an index as the JAX package's gather takes it: negative counts from
    # the end, out of range is clamped
    b = torch.where(b < 0, b + n_batch, b).clamp(0, n_batch - 1)
    r = rois.to(dtype)
    x1 = torch.round(r[:, 1] * spatial_scale)
    y1 = torch.round(r[:, 2] * spatial_scale)
    x2 = torch.round(r[:, 3] * spatial_scale)
    y2 = torch.round(r[:, 4] * spatial_scale)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    bin_w = _div(rw, pw)[:, None]
    bin_h = _div(rh, ph)[:, None]

    def mask(start, size, n_bins, extent):
        k = torch.arange(n_bins, dtype=dtype, device=dev)
        lo = torch.floor(start[:, None] + k * size)
        hi = torch.ceil(start[:, None] + (k + 1) * size)
        g = torch.arange(extent, dtype=dtype, device=dev)
        return (g >= lo[..., None]) & (g < hi[..., None])

    return b, mask(y1, bin_h, ph, H), mask(x1, bin_w, pw, W)


def _roi_chunks(data, n_rois, ph, pw):
    C, H, W = data.shape[1:]
    k = max(1, _ROI_CHUNK_ELEMS // max(1, C * ph * pw * H * W))
    return [(s, min(s + k, n_rois)) for s in range(0, n_rois, k)]


class _ROIPoolFn(torch.autograd.Function):
    """The bins' maxima (0 for an empty bin); the backward recomputes each
    chunk's tie masks and gives every maximal tap of a bin an equal share
    of its cotangent.  The ROIs get no gradient (the JAX package's rounds
    them)."""

    @staticmethod
    def forward(ctx, data, rois, ph, pw, spatial_scale):
        N, C, H, W = data.shape
        R = rois.shape[0]
        b, my, mx_ = _roi_masks(rois, N, H, W, ph, pw, spatial_scale,
                                data.dtype)
        fill = torch.finfo(data.dtype).min
        out = data.new_empty((R, C, ph, pw))
        for s, e in _roi_chunks(data, R, ph, pw):
            img = data[b[s:e]]                       # [k, C, H, W]
            cols = torch.where(mx_[s:e, None, :, None, :],
                               img[:, :, None], fill).amax(-1)
            v = torch.where(my[s:e, None, :, None, :], cols[:, :, None],
                            fill).amax(-1)           # [k, C, ph, pw]
            hit = my[s:e].any(-1)[:, :, None] & mx_[s:e].any(-1)[:, None, :]
            out[s:e] = torch.where(hit[:, None], v, 0.0)
        ctx.geometry = (ph, pw, spatial_scale)
        ctx.save_for_backward(data, rois, out)
        return out

    @staticmethod
    def backward(ctx, dy):
        data, rois, out = ctx.saved_tensors
        ph, pw, spatial_scale = ctx.geometry
        N, C, H, W = data.shape
        b, my, mx_ = _roi_masks(rois, N, H, W, ph, pw, spatial_scale,
                                data.dtype)
        dx = torch.zeros_like(data)
        for s, e in _roi_chunks(data, rois.shape[0], ph, pw):
            img = data[b[s:e]].reshape(e - s, C, 1, H * W)
            inside = (my[s:e, :, None, :, None]
                      & mx_[s:e, None, :, None, :]).reshape(
                          e - s, 1, ph * pw, H * W)
            ties = (img == out[s:e].reshape(e - s, C, ph * pw, 1)) & inside
            count = ties.sum(-1)                     # [k, C, bins]
            share = torch.where(count > 0, dy[s:e].reshape(count.shape)
                                / count.clamp(min=1), 0.0)
            part = torch.einsum("kcph,kcp->kch", ties.to(data.dtype), share)
            dx.index_add_(0, b[s:e], part.reshape(e - s, C, H, W))
        return dx, None, None, None, None


def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """data [N,C,H,W]; rois [R,5] (batch_idx, x1, y1, x2, y2) in image
    coords -> [R, C, ph, pw]: the max over each bin of the ROI's grid."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    return _ROIPoolFn.apply(data, rois, ph, pw, float(spatial_scale))


def _roi_infer_shape(in_shapes, attrs):
    d, r = in_shapes[0], in_shapes[1]
    if d is None or r is None:
        return in_shapes, None
    ph, pw = attrs["pooled_size"]
    return in_shapes, [(r[0], d[1], int(ph), int(pw))]


register("ROIPooling", _roi_pooling, input_names=("data", "rois"),
         infer_shape=_roi_infer_shape,
         params={"pooled_size": (pShape, (1, 1)),
                 "spatial_scale": (pFloat, 1.0)})


# ---------------------------------------------------------------------------
# Correlation (ref: correlation-inl.h, FlowNet's cost volume)
# ---------------------------------------------------------------------------

def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """Cost volume between two feature maps (FlowNet-C): [N, D*D, H', W']
    with D = 2*(max_displacement/stride2)+1, the JAX package's geometry
    (zero padding, a top-left-anchored kernel window, the final crop)."""
    md = int(max_displacement)
    s1, s2 = int(stride1), int(stride2)
    ks = int(kernel_size)
    pad = int(pad_size)
    H, W = data1.shape[2], data1.shape[3]
    d1p = F.pad(data1, (pad, pad, pad, pad))
    d2p = F.pad(data2, (pad + md,) * 4)
    Hp, Wp = H + 2 * pad, W + 2 * pad
    outs = []
    for dy in range(-md, md + 1, s2):
        for dx in range(-md, md + 1, s2):
            shifted = d2p[:, :, md + dy:md + dy + Hp, md + dx:md + dx + Wp]
            prod = d1p * shifted if is_multiply \
                else torch.abs(d1p - shifted)
            cost = prod.mean(dim=1, keepdim=True)
            if ks > 1:
                # the mean over each top-left-anchored ks x ks window of
                # valid positions
                cost = F.avg_pool2d(cost, ks, stride=1)
            outs.append(cost[:, 0])
    out = torch.stack(outs, dim=1)
    lim_h = Hp - ks + 1 - md
    lim_w = Wp - ks + 1 - md
    if lim_h > md and lim_w > md:
        return out[:, :, md:lim_h:s1, md:lim_w:s1]
    return out[:, :, ::s1, ::s1]


register("Correlation", _correlation, input_names=("data1", "data2"),
         params={"kernel_size": (pInt, 1), "max_displacement": (pInt, 1),
                 "stride1": (pInt, 1), "stride2": (pInt, 1),
                 "pad_size": (pInt, 0), "is_multiply": (pBool, True)})


# ---------------------------------------------------------------------------
# Crop / depth-space / smooth_l1 (ref: crop-inl.h, matrix_op, smooth_l1)
# ---------------------------------------------------------------------------

def _crop(*args, offset=(0, 0), h_w=(0, 0), center_crop=False, num_args=0):
    """The ``h_w`` window of ``args[0]`` (or the second input's spatial
    size, whose gradient is then 0) at ``offset`` or centred."""
    data = args[0]
    if len(args) == 2:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    H, W = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    return data[:, :, y0:y0 + th, x0:x0 + tw]


def _crop_infer_shape(in_shapes, attrs):
    d = in_shapes[0]
    if d is None:
        return in_shapes, None
    if len(in_shapes) == 2:
        ref = in_shapes[1]
        if ref is None:
            return in_shapes, None
        th, tw = ref[2], ref[3]
    else:
        th, tw = attrs["h_w"]
    return in_shapes, [(d[0], d[1], int(th), int(tw))]


register("Crop", _crop, num_inputs=None, key_var_num_args="num_args",
         infer_shape=_crop_infer_shape,
         params={"offset": (pShape, (0, 0)), "h_w": (pShape, (0, 0)),
                 "center_crop": (pBool, False), "num_args": (pInt, 0)})


def _depth_to_space(data, block_size=1):
    N, C, H, W = data.shape
    b = int(block_size)
    x = data.reshape(N, b, b, C // (b * b), H, W)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(N, C // (b * b), H * b, W * b)


register("depth_to_space", _depth_to_space, num_inputs=1,
         params={"block_size": (pInt, 1)})


def _space_to_depth(data, block_size=1):
    N, C, H, W = data.shape
    b = int(block_size)
    x = data.reshape(N, C, H // b, b, W // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(N, C * b * b, H // b, W // b)


register("space_to_depth", _space_to_depth, num_inputs=1,
         params={"block_size": (pInt, 1)})


def _smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2, 0.5 * s2 * data * data,
                       torch.abs(data) - 0.5 / s2)


register("smooth_l1", _smooth_l1, num_inputs=1,
         params={"scalar": (pFloat, 1.0)})


def _identity_kl_sparse(data, sparseness_target=0.1, penalty=0.001,
                        momentum=0.9):
    """The identity both ways, as the JAX package's (MXNet 1.0 adds the
    KL sparsity penalty's gradient in the backward; ROADMAP R14)."""
    return data.view_as(data)


register("IdentityAttachKLSparseReg", _identity_kl_sparse, num_inputs=1,
         params={"sparseness_target": (pFloat, 0.1),
                 "penalty": (pFloat, 0.001), "momentum": (pFloat, 0.9)})


# ---------------------------------------------------------------------------
# linalg ops (ref: tensor/la_op.h; LAPACK in the reference, cuBLAS and
# cuSOLVER through torch.linalg on the card)
# ---------------------------------------------------------------------------

def _t(x):
    return x.transpose(-1, -2)


def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0):
    At = _t(A) if transpose_a else A
    Bt = _t(B) if transpose_b else B
    return alpha * (At @ Bt) + beta * C


register("linalg_gemm", _linalg_gemm, input_names=("A", "B", "C"),
         aliases=("_linalg_gemm",),
         params={"transpose_a": (pBool, False), "transpose_b": (pBool, False),
                 "alpha": (pFloat, 1.0), "beta": (pFloat, 1.0)})


def _linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    At = _t(A) if transpose_a else A
    Bt = _t(B) if transpose_b else B
    return alpha * (At @ Bt)


register("linalg_gemm2", _linalg_gemm2, input_names=("A", "B"),
         aliases=("_linalg_gemm2",),
         params={"transpose_a": (pBool, False), "transpose_b": (pBool, False),
                 "alpha": (pFloat, 1.0)})


def _symmetrized(A):
    return (A + _t(A)) / 2


register("linalg_potrf", lambda A: torch.linalg.cholesky(_symmetrized(A)),
         num_inputs=1, aliases=("_linalg_potrf",))


def _linalg_potri(A):
    """Input is the lower Cholesky factor L (potrf's output); returns
    (L L^T)^{-1} = L^{-T} L^{-1} by a triangular solve."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype,
                    device=A.device).expand(A.shape)
    Linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return _t(Linv) @ Linv


register("linalg_potri", _linalg_potri, num_inputs=1,
         aliases=("_linalg_potri",))


def _linalg_trsm(A, B, transpose=False, rightside=False, alpha=1.0):
    """The JAX package's triangle rule: the solve reads the lower triangle
    of ``A`` (``A^T``'s upper one when ``transpose``); ``rightside``
    solves ``X A^T = alpha B`` through the transposed system."""
    At = _t(A) if transpose else A
    if rightside:
        X = torch.linalg.solve_triangular(_t(At), _t(alpha * B),
                                          upper=transpose)
        return _t(X)
    return torch.linalg.solve_triangular(At, alpha * B, upper=transpose)


register("linalg_trsm", _linalg_trsm, input_names=("A", "B"),
         aliases=("_linalg_trsm",),
         params={"transpose": (pBool, False), "rightside": (pBool, False),
                 "alpha": (pFloat, 1.0)})


def _linalg_trmm(A, B, transpose=False, rightside=False, alpha=1.0):
    At = _t(A) if transpose else A
    if rightside:
        return alpha * (B @ At)
    return alpha * (At @ B)


register("linalg_trmm", _linalg_trmm, input_names=("A", "B"),
         aliases=("_linalg_trmm",),
         params={"transpose": (pBool, False), "rightside": (pBool, False),
                 "alpha": (pFloat, 1.0)})


def _linalg_syrk(A, transpose=False, alpha=1.0):
    return alpha * (_t(A) @ A if transpose else A @ _t(A))


register("linalg_syrk", _linalg_syrk, num_inputs=1,
         aliases=("_linalg_syrk",),
         params={"transpose": (pBool, False), "alpha": (pFloat, 1.0)})


register("linalg_sumlogdiag",
         lambda A: torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1),
         num_inputs=1, aliases=("_linalg_sumlogdiag",))


def _linalg_gelqf(A):
    """LQ factorization A = L @ Q with Q orthonormal rows (ref:
    tensor/la_op.cc _linalg_gelqf): the transpose of the QR of A^T, signs
    fixed so diag(L) >= 0, as the JAX package's."""
    Qt, Rt = torch.linalg.qr(_t(A), mode="reduced")
    d = torch.diagonal(Rt, dim1=-2, dim2=-1)
    s = torch.where(d < 0, -1.0, 1.0).to(A.dtype)
    # flipping column i of Q-tilde pairs with flipping ROW i of R-tilde
    Q = _t(Qt * s[..., None, :])
    L = _t(Rt * s[..., :, None])
    return Q, L


def _gelqf_infer_shape(in_shapes, attrs):
    a = in_shapes[0]
    if a is None:
        return in_shapes, [None, None]
    return in_shapes, [tuple(a), tuple(a[:-1]) + (a[-2],)]


register("linalg_gelqf", _linalg_gelqf, num_inputs=1, num_outputs=2,
         aliases=("_linalg_gelqf",), infer_shape=_gelqf_infer_shape)


def _linalg_syevd(A):
    """Symmetric eigendecomposition U @ A = diag(L) @ U, L ascending, of
    ``(A + A^T) / 2`` (row-eigenvector convention: U is the transpose of
    the usual column-eigenvector matrix).  Narrower types are decomposed
    in float64 and rounded back: at 512 x 512, cuSOLVER's float32 routine
    leaves backward and orthogonality errors some 20-100 times LAPACK's
    (the JAX package's on the host); ``chip_smoke.py`` phase 19c prints
    both."""
    work = A if A.dtype == torch.float64 else A.to(torch.float64)
    w, V = torch.linalg.eigh(_symmetrized(work))
    return _t(V).to(A.dtype), w.to(A.dtype)


def _syevd_infer_shape(in_shapes, attrs):
    a = in_shapes[0]
    if a is None:
        return in_shapes, [None, None]
    return in_shapes, [tuple(a), tuple(a[:-1])]


register("linalg_syevd", _linalg_syevd, num_inputs=1, num_outputs=2,
         aliases=("_linalg_syevd",), infer_shape=_syevd_infer_shape)


# ---------------------------------------------------------------------------
# khatri_rao (ref: contrib/krprod.cc).  Registered twice, as in the JAX
# registry: ``_contrib_khatri_rao`` keeps the first, 2-D registration;
# ``khatri_rao`` and ``_contrib_krprod`` resolve to the second, batched one.
# ---------------------------------------------------------------------------

def _khatri_rao_2d(*args, num_args=0):
    """Column-wise Kronecker product of 2-D matrices."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[1])
    return out


register("khatri_rao", _khatri_rao_2d, num_inputs=None,
         key_var_num_args="num_args", aliases=("_contrib_khatri_rao",),
         params={"num_args": (pInt, 0)})


def _khatri_rao(*mats, num_args=0):
    """Column k of the output is the Kronecker product of the inputs'
    k-th columns; rows multiply out, columns must agree."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[..., :, None, :] * m[..., None, :, :]).reshape(
            out.shape[:-2] + (out.shape[-2] * m.shape[-2], m.shape[-1]))
    return out


def _khatri_rao_infer_shape(in_shapes, attrs):
    if any(s is None for s in in_shapes):
        return in_shapes, [None]
    rows = 1
    for s in in_shapes:
        rows *= s[-2]
    return in_shapes, [(rows, in_shapes[0][-1])]


register("khatri_rao", _khatri_rao, num_inputs=None,
         key_var_num_args="num_args", aliases=("_contrib_krprod",),
         infer_shape=_khatri_rao_infer_shape,
         params={"num_args": (pInt, 0)})
