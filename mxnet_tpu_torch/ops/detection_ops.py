"""Detection-era contrib ops: proposals, position-sensitive ROI pooling,
deformable convolution and pooling, count sketch, bipartite matching.

Counterpart of ``mxnet_tpu/ops/detection_ops.py`` (ref:
src/operator/contrib/{proposal,multi_proposal,psroi_pooling,
deformable_convolution,deformable_psroi_pooling,count_sketch}.cc and
bounding_box-inl.h), under the same names, aliases, parameters and
outputs.  The bodies follow the JAX package's, which depart from MXNet
1.0 in places (ROADMAP R16).

- ``Proposal``/``MultiProposal``: the anchor field, the box decode, the
  clip and the min-size mask in torch ops; the top ``rpn_pre_nms_top_n``
  by a stable descending sort (the JAX package's ``lax.top_k`` puts the
  lower index first among equal scores); the greedy suppression on
  ``ops/kernels.py: proposal_nms_keep`` (``csrc/box_nms.cu`` at pixel
  offset 1 on the card), one set per picture; the ``rpn_post_nms_top_n``
  slots filled with static shapes as the JAX package fills them.
- ``PSROIPooling``: each bin's mean from a summed-area table of the
  input, taken in float64 (the JAX package sums a masked plane per bin);
  the gradient flows back through the table.
- ``DeformableConvolution``: the bilinear column tensor on
  ``ops/kernels.py: deformable_im2col`` (``csrc/deformable_im2col.cu`` on
  the card), then one grouped ``torch.matmul``.
- ``DeformablePSROIPooling``: the sampled bins in torch ops; the sample
  points and the bilinear combination in float64, where the JAX package's
  x64 arithmetic puts them (ROADMAP R15), returned in the input's dtype.
- ``bipartite_matching``: at most min(rows, cols) + 1 masked arg-min steps
  over each pair's position in the stable score order, which match what
  the JAX package's walk of rows x cols pairs matches.
- ``count_sketch``: one ``index_add``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernels as K
from .extra import _div
from .image_ops import pFloatTuple
from .registry import pBool, pFloat, pInt, pShape, register


# ---------------------------------------------------------------------------
# count_sketch (ref: count_sketch-inl.h — hashed random projection)
# ---------------------------------------------------------------------------

def _count_sketch(data, h, s, out_dim=1, processing_batch_size=32):
    """out[..., h[j]] += s[j] * data[..., j]: one ``index_add`` of the
    signed input's columns into the output's, taken as rows."""
    idx = h.reshape(-1).long()
    sign = s.reshape(-1).to(data.dtype)
    cols = (data * sign).reshape(-1, data.shape[-1]).t()
    out = torch.zeros((int(out_dim), cols.shape[1]), dtype=data.dtype,
                      device=data.device).index_add(0, idx, cols)
    return out.t().reshape(data.shape[:-1] + (int(out_dim),))


def _count_sketch_infer_shape(in_shapes, attrs):
    d = in_shapes[0]
    if d is None:
        return in_shapes, None
    return in_shapes, [tuple(d[:-1]) + (int(attrs["out_dim"]),)]


register("_contrib_count_sketch", _count_sketch,
         input_names=("data", "h", "s"),
         infer_shape=_count_sketch_infer_shape,
         params={"out_dim": (pInt, 1),
                 "processing_batch_size": (pInt, 32)},
         doc="Count-sketch random projection (hash h, signs s).")


# ---------------------------------------------------------------------------
# Proposal / MultiProposal (ref: proposal-inl.h, multi_proposal-inl.h)
# ---------------------------------------------------------------------------

def _gen_anchors(base_size, scales, ratios):
    """Standard RPN anchor enumeration (ratios then scales), in the JAX
    package's numpy arithmetic."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for sc in scales:
            aw, ah = ws * sc, hs * sc
            anchors.append([cx - 0.5 * (aw - 1), cy - 0.5 * (ah - 1),
                            cx + 0.5 * (aw - 1), cy + 0.5 * (ah - 1)])
    return np.array(anchors, np.float32)  # (A, 4)


def _bbox_decode(anchors, deltas):
    """(dx, dy, dw, dh) deltas [N, M, 4] applied to anchors [M, 4]."""
    w = anchors[:, 2] - anchors[:, 0] + 1.0
    h = anchors[:, 3] - anchors[:, 1] + 1.0
    cx = anchors[:, 0] + 0.5 * (w - 1.0)
    cy = anchors[:, 1] + 0.5 * (h - 1.0)
    dx, dy, dw, dh = deltas.unbind(-1)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                        pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)],
                       dim=-1)


def proposal_candidates(scores, deltas, im_info, anchors, feature_stride,
                        pre_nms, min_size):
    """The boxes that enter Proposal's suppression: the anchor field
    decoded by ``deltas`` [N, 4A, H, W], clipped to ``im_info`` [N, 3],
    scores [N, A, H, W] (foreground) set to -inf under the min size, and
    the top ``pre_nms`` by a stable descending sort.  Returns (boxes
    [N, pre, 4], scores [N, pre]), pre = min(pre_nms, A H W)."""
    N, A, H, W = scores.shape
    dev = scores.device
    f32 = torch.float32
    shift_x = torch.arange(W, dtype=f32, device=dev) * feature_stride
    shift_y = torch.arange(H, dtype=f32, device=dev) * feature_stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")   # (H, W)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)
    all_anchors = (torch.as_tensor(anchors, device=dev)[None, None]
                   + shifts[:, :, None]).reshape(-1, 4)       # (H*W*A, 4)
    flat_scores = scores.permute(0, 2, 3, 1).reshape(N, -1)
    flat_deltas = deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, -1, 4)
    boxes = _bbox_decode(all_anchors, flat_deltas)            # (N, M, 4)
    zero = torch.zeros((), dtype=boxes.dtype, device=dev)
    hi_x = (im_info[:, 1] - 1.0)[:, None]
    hi_y = (im_info[:, 0] - 1.0)[:, None]
    boxes = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), hi_x),
        torch.minimum(torch.maximum(boxes[..., 1], zero), hi_y),
        torch.minimum(torch.maximum(boxes[..., 2], zero), hi_x),
        torch.minimum(torch.maximum(boxes[..., 3], zero), hi_y)], dim=-1)
    ms = (min_size * im_info[:, 2])[:, None]
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    flat_scores = torch.where((ws >= ms) & (hs >= ms), flat_scores,
                              float("-inf"))
    pre = min(int(pre_nms), boxes.shape[1])
    top_scores, order = torch.sort(flat_scores, dim=1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :pre], order[:, :pre]
    return torch.gather(boxes, 1, order[..., None].expand(N, pre, 4)), \
        top_scores


def _proposals(scores, deltas, im_info, anchors, feature_stride, pre_nms,
               post_nms, thresh, min_size):
    """The JAX package's ``_proposal_single`` over a batch: scores [N, A,
    H, W] (foreground), deltas [N, 4A, H, W], im_info [N, 3] -> boxes
    [N, post_nms, 4] and their scores [N, post_nms]."""
    top_boxes, top_scores = proposal_candidates(
        scores, deltas, im_info, anchors, feature_stride, pre_nms, min_size)
    N, pre = top_scores.shape
    dev = top_scores.device
    keep = K.proposal_nms_keep(top_boxes.detach().float(), thresh) \
        & torch.isfinite(top_scores)
    # the kept boxes in order into post_nms slots; kept boxes ranked beyond
    # post_nms go to a discard slot, and slots past the last kept box
    # repeat it (the reference pads with sampled boxes)
    kept_rank = torch.cumsum(keep.long(), dim=1) - 1
    idxs = torch.arange(pre, device=dev).expand(N, pre)
    slot_idx = torch.where(keep & (kept_rank < post_nms), kept_rank,
                           post_nms)
    slot_src = torch.full((N, post_nms + 1), -1, dtype=torch.long,
                          device=dev).scatter_reduce(
        1, slot_idx, torch.where(keep, idxs, -1), "amax")[:, :post_nms]
    n_kept = torch.clamp(keep.sum(dim=1), max=post_nms)
    last = torch.clamp(n_kept - 1, 0, post_nms - 1)
    slot_src = torch.where(
        torch.arange(post_nms, device=dev) < n_kept[:, None], slot_src,
        torch.gather(slot_src, 1, last[:, None]))
    slot_src = slot_src % pre   # -1 (nothing kept): the last box, as jnp
    out_boxes = torch.gather(top_boxes, 1,
                             slot_src[..., None].expand(N, post_nms, 4))
    return out_boxes, torch.gather(top_scores, 1, slot_src)


def _check_iou_loss(name, iou_loss):
    if iou_loss:
        raise NotImplementedError(
            "%s iou_loss=True (corner-correction decode) is not "
            "implemented; boxes would be silently wrong" % name)


def _proposal(cls_prob, bbox_pred, im_info, scales=(4, 8, 16, 32),
              ratios=(0.5, 1, 2), feature_stride=16,
              rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
              threshold=0.7, rpn_min_size=16, output_score=False,
              iou_loss=False):
    _check_iou_loss("Proposal", iou_loss)
    anchors = _gen_anchors(feature_stride, scales, ratios)
    A = anchors.shape[0]
    boxes, scores = _proposals(
        cls_prob[:1, A:], bbox_pred[:1], im_info[:1], anchors,
        float(feature_stride), rpn_pre_nms_top_n, int(rpn_post_nms_top_n),
        float(threshold), float(rpn_min_size))
    rois = torch.cat([torch.zeros((boxes.shape[1], 1), dtype=boxes.dtype,
                                  device=boxes.device), boxes[0]], dim=1)
    if output_score:
        return rois, scores[0][:, None]
    return rois


def _multi_proposal(cls_prob, bbox_pred, im_info, scales=(4, 8, 16, 32),
                    ratios=(0.5, 1, 2), feature_stride=16,
                    rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                    threshold=0.7, rpn_min_size=16, output_score=False,
                    iou_loss=False):
    _check_iou_loss("MultiProposal", iou_loss)
    anchors = _gen_anchors(feature_stride, scales, ratios)
    A = anchors.shape[0]
    boxes, scores = _proposals(
        cls_prob[:, A:], bbox_pred, im_info, anchors, float(feature_stride),
        rpn_pre_nms_top_n, int(rpn_post_nms_top_n), float(threshold),
        float(rpn_min_size))
    N, P = boxes.shape[:2]
    batch_ids = torch.arange(N, dtype=boxes.dtype,
                             device=boxes.device).repeat_interleave(P)
    rois = torch.cat([batch_ids[:, None], boxes.reshape(N * P, 4)], dim=1)
    if output_score:
        return rois, scores.reshape(N * P, 1)
    return rois


def _prop_nout(attrs):
    return 2 if attrs.get("output_score") else 1


def _prop_infer_shape(batched):
    def infer(in_shapes, attrs):
        c = in_shapes[0]
        if c is None:
            return in_shapes, None
        rows = int(attrs["rpn_post_nms_top_n"]) * (int(c[0]) if batched
                                                   else 1)
        outs = [(rows, 5)] + ([(rows, 1)] if attrs.get("output_score")
                              else [])
        return in_shapes, outs
    return infer


_PROP_PARAMS = {
    "scales": (pFloatTuple, (4, 8, 16, 32)),
    "ratios": (pFloatTuple, (0.5, 1, 2)),
    "feature_stride": (pInt, 16), "rpn_pre_nms_top_n": (pInt, 6000),
    "rpn_post_nms_top_n": (pInt, 300), "threshold": (pFloat, 0.7),
    "rpn_min_size": (pInt, 16), "output_score": (pBool, False),
    "iou_loss": (pBool, False),
}

register("_contrib_Proposal", _proposal,
         input_names=("cls_prob", "bbox_pred", "im_info"),
         num_outputs=_prop_nout, params=_PROP_PARAMS,
         infer_shape=_prop_infer_shape(False), aliases=("Proposal",),
         doc="RPN proposal generation (anchors + bbox decode + NMS).")

register("_contrib_MultiProposal", _multi_proposal,
         input_names=("cls_prob", "bbox_pred", "im_info"),
         num_outputs=_prop_nout, params=_PROP_PARAMS,
         infer_shape=_prop_infer_shape(True), aliases=("MultiProposal",),
         doc="Batched RPN proposal generation.")


# ---------------------------------------------------------------------------
# PSROIPooling (ref: psroi_pooling-inl.h — position-sensitive ROI pooling)
# ---------------------------------------------------------------------------

def _cell_channels(C, g, p, device):
    """[C, p, p]: channel c * g * g + gh * g + gw of each output channel c
    and cell (ph, pw), gh = (ph * g) // p clipped to [0, g - 1]."""
    cell = torch.clamp(torch.arange(p, device=device) * g // p, 0, g - 1)
    return (torch.arange(C, device=device)[:, None, None] * g * g
            + cell[None, :, None] * g + cell[None, None, :])


def _psroi_pool(data, rois, spatial_scale=1.0, output_dim=1, pooled_size=1,
                group_size=0):
    g = int(group_size) or int(pooled_size)
    p = int(pooled_size)
    C = int(output_dim)
    N, Ct, H, W = data.shape
    dev = data.device
    b = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale
    y1 = torch.round(rois[:, 2]) * spatial_scale
    x2 = torch.round(rois[:, 3] + 1.0) * spatial_scale
    y2 = torch.round(rois[:, 4] + 1.0) * spatial_scale
    bin_w = _div(torch.clamp(x2 - x1, min=0.1), p)[:, None]
    bin_h = _div(torch.clamp(y2 - y1, min=0.1), p)[:, None]
    cell = torch.arange(p, dtype=rois.dtype, device=dev)
    hs = torch.clamp(torch.floor(y1[:, None] + cell * bin_h), 0, H).long()
    he = torch.clamp(torch.ceil(y1[:, None] + (cell + 1) * bin_h), 0,
                     H).long()
    ws = torch.clamp(torch.floor(x1[:, None] + cell * bin_w), 0, W).long()
    we = torch.clamp(torch.ceil(x1[:, None] + (cell + 1) * bin_w), 0,
                     W).long()                                # (R, p)
    # the bins' sums from a summed-area table of every channel plane
    table = torch.nn.functional.pad(
        data.double().cumsum(2).cumsum(3), (1, 0, 1, 0)).reshape(-1)
    plane = (b[:, None, None, None] * Ct
             + _cell_channels(C, g, p, dev)[None]) * ((H + 1) * (W + 1))

    def at(y, x):   # y [R, p] over ph, x [R, p] over pw -> [R, C, p, p]
        return table[plane + (y[:, None, :, None] * (W + 1)
                              + x[:, None, None, :])]

    s = at(he, we) - at(hs, we) - at(he, ws) + at(hs, ws)
    rows = torch.clamp(he - hs, min=0)[:, None, :, None]
    cols = torch.clamp(we - ws, min=0)[:, None, None, :]
    area = torch.clamp(rows * cols, min=1)
    out = torch.where((rows > 0) & (cols > 0), s / area, 0.0)
    return out.to(data.dtype)


def _pool_infer_shape(in_shapes, attrs):
    r = in_shapes[1]
    if r is None:
        return in_shapes, None
    p = int(attrs["pooled_size"])
    return in_shapes, [(r[0], int(attrs["output_dim"]), p, p)]


register("_contrib_PSROIPooling", _psroi_pool,
         input_names=("data", "rois"), infer_shape=_pool_infer_shape,
         params={"spatial_scale": (pFloat, 1.0), "output_dim": (pInt, 1),
                 "pooled_size": (pInt, 1), "group_size": (pInt, 0)},
         aliases=("PSROIPooling",),
         doc="Position-sensitive ROI pooling (R-FCN).")


# ---------------------------------------------------------------------------
# Deformable convolution (ref: deformable_convolution-inl.h)
# ---------------------------------------------------------------------------

def _deformable_convolution(data, offset, weight, *rest, kernel=(1, 1),
                            stride=None, dilate=None, pad=None, num_filter=1,
                            num_group=1, num_deformable_group=1, no_bias=False,
                            workspace=1024, layout=None):
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = (int(v) for v in (stride or (1, 1)))
    dh, dw = (int(v) for v in (dilate or (1, 1)))
    ph, pw = (int(v) for v in (pad or (0, 0)))
    N, C, H, W = data.shape
    F = int(num_filter)
    G = int(num_group)
    col = K.deformable_im2col(data, offset, (kh, kw), (sh, sw), (ph, pw),
                              (dh, dw), int(num_deformable_group))
    Ho, Wo = col.shape[4], col.shape[5]
    colg = col.reshape(N, G, (C // G) * kh * kw, Ho * Wo)
    wg = weight.reshape(G, F // G, (C // G) * kh * kw)
    if data.dtype in (torch.bfloat16, torch.float16):
        # the JAX package's preferred_element_type f32, then data's dtype
        out = torch.matmul(wg.float(), colg.float()).to(data.dtype)
    else:
        out = torch.matmul(wg, colg)                  # (N, G, F/G, Ho*Wo)
    out = out.reshape(N, F, Ho, Wo)
    if not no_bias:
        out = out + rest[0].reshape(1, F, 1, 1)
    return out


def _deform_conv_infer_shape(in_shapes, attrs):
    d = in_shapes[0]
    if d is None:
        return in_shapes, None
    kh, kw = (int(v) for v in attrs["kernel"])
    sh, sw = (int(v) for v in (attrs["stride"] or (1, 1)))
    dh, dw = (int(v) for v in (attrs["dilate"] or (1, 1)))
    ph, pw = (int(v) for v in (attrs["pad"] or (0, 0)))
    F, G = int(attrs["num_filter"]), int(attrs["num_group"])
    Ho = (d[2] + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (d[3] + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg = int(attrs["num_deformable_group"])
    shapes = [tuple(d), (d[0], 2 * dg * kh * kw, Ho, Wo),
              (F, d[1] // G, kh, kw)]
    if not attrs["no_bias"]:
        shapes.append((F,))
    return shapes, [(d[0], F, Ho, Wo)]


register("_contrib_DeformableConvolution", _deformable_convolution,
         input_names=("data", "offset", "weight", "bias"),
         infer_shape=_deform_conv_infer_shape,
         params={"kernel": (pShape, (1, 1)), "stride": (pShape, None),
                 "dilate": (pShape, None), "pad": (pShape, None),
                 "num_filter": (pInt, 1), "num_group": (pInt, 1),
                 "num_deformable_group": (pInt, 1), "no_bias": (pBool, False),
                 "workspace": (pInt, 1024), "layout": (lambda v: v, None)},
         aliases=("DeformableConvolution",),
         doc="Deformable convolution v1: bilinear-sampled im2col + matmul.")


# ---------------------------------------------------------------------------
# Deformable PSROI pooling (ref: deformable_psroi_pooling-inl.h)
# ---------------------------------------------------------------------------

def _deformable_psroi_pool(data, rois, *trans_opt, spatial_scale=1.0,
                           output_dim=1, group_size=1, pooled_size=1,
                           part_size=0, sample_per_part=1, trans_std=0.0,
                           no_trans=False):
    g = int(group_size)
    p = int(pooled_size)
    part = int(part_size) or p
    sp = int(sample_per_part)
    C = int(output_dim)
    N, Ct, H, W = data.shape
    R = rois.shape[0]
    dev, f64 = data.device, torch.float64
    b = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)[:, None, None]
    rh = torch.clamp(y2 - y1, min=0.1)[:, None, None]
    bin_h, bin_w = _div(rh, p), _div(rw, p)
    sub_h, sub_w = _div(bin_h, sp), _div(bin_w, sp)
    cell = torch.arange(p, dtype=rois.dtype, device=dev)
    if no_trans or not trans_opt:
        oy = ox = torch.zeros((), dtype=rois.dtype, device=dev)
    else:
        # the learned offset of each bin, class-agnostic: trans channels
        # 0 and 1 only (ROADMAP R16)
        pp = torch.clamp(torch.arange(p, device=dev) * part // p, 0,
                         part - 1)
        tr = trans_opt[0][:, :2][:, :, pp][:, :, :, pp]   # (R, 2, p, p)
        oy = tr[:, 0] * trans_std * rh
        ox = tr[:, 1] * trans_std * rw
    # the bins' first corners in f32, the samples' steps in f64 (the JAX
    # package's (arange(sp) + 0.5) * sub_h is float64 under x64)
    ystart = y1[:, None, None] + cell[:, None] * bin_h + oy   # (R, p, p)
    xstart = x1[:, None, None] + cell[None, :] * bin_w + ox
    steps = torch.arange(sp, dtype=f64, device=dev) + 0.5
    yy = (ystart.double()[..., None, None]
          + (steps * sub_h.double()[..., None])[..., None])   # (R,p,p,sp,1)
    xx = (xstart.double()[..., None, None]
          + (steps * sub_w.double()[..., None])[..., None, :])  # (R,p,p,1,sp)
    yy, xx = torch.broadcast_tensors(yy, xx)                  # (R,p,p,sp,sp)
    valid = (yy >= -0.5) & (yy <= H - 0.5) & (xx >= -0.5) & (xx <= W - 0.5)
    yc = torch.clamp(yy, 0.0, H - 1.0)
    xc = torch.clamp(xx, 0.0, W - 1.0)
    # bilinear taps of each output channel's cell channel
    plane = (b[:, None, None, None] * Ct
             + _cell_channels(C, g, p, dev)[None]) * (H * W)  # (R, C, p, p)
    flat = data.reshape(-1)
    y0, x0 = torch.floor(yc), torch.floor(xc)
    wy1, wx1 = (yc - y0)[:, None], (xc - x0)[:, None]         # (R,1,p,p,sp,sp)

    def tap(ty, tx):
        ok = (ty >= 0) & (ty <= H - 1) & (tx >= 0) & (tx <= W - 1)
        yi = torch.clamp(ty, 0, H - 1).long()
        xi = torch.clamp(tx, 0, W - 1).long()
        v = flat[plane[..., None, None] + (yi * W + xi)[:, None]]
        return v * ok[:, None].to(data.dtype)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    vals = (v00 * (1 - wy1) * (1 - wx1) + v01 * (1 - wy1) * wx1
            + v10 * wy1 * (1 - wx1) + v11 * wy1 * wx1)       # f64
    vals = vals * valid[:, None].to(vals.dtype)
    count = torch.clamp(valid.sum(dim=(-2, -1)), min=1)[:, None]
    out = vals.sum(dim=(-2, -1)) / count
    return out.to(data.dtype).reshape(R, C, p, p)


register("_contrib_DeformablePSROIPooling", _deformable_psroi_pool,
         input_names=("data", "rois", "trans"),
         infer_shape=_pool_infer_shape,
         params={"spatial_scale": (pFloat, 1.0), "output_dim": (pInt, 1),
                 "group_size": (pInt, 1), "pooled_size": (pInt, 1),
                 "part_size": (pInt, 0), "sample_per_part": (pInt, 1),
                 "trans_std": (pFloat, 0.0), "no_trans": (pBool, False)},
         aliases=("DeformablePSROIPooling",),
         doc="Deformable position-sensitive ROI pooling (sampled bins with "
             "learned offsets).")


# ---------------------------------------------------------------------------
# bipartite_matching (ref: contrib/bounding_box-inl.h:619)
# ---------------------------------------------------------------------------

def _bipartite_matching(score, is_ascend=False, threshold=0.0, topk=-1):
    """Greedy bipartite matching over a [..., rows, cols] score matrix.
    The JAX package walks the rows x cols pairs in stable score order,
    matching a pair when its row and column are free and its score passes
    the threshold; the first free pair that fails ends the walk, and so
    does the assignment that takes the count past ``topk`` (the
    reference's off-by-one).  A pair skipped there stays blocked (rows and
    columns are never freed), so the walk's next event is always the first
    free pair in the order: each step below takes it by an arg-min of the
    pairs' positions in the order over the free ones, and at most
    min(rows, cols) + 1 steps reach the end of the walk.  Outputs: the row
    and column marker arrays, -1 where unmatched, in the score's dtype."""
    rows, cols = score.shape[-2], score.shape[-1]
    lead = score.shape[:-2]
    flat = score.reshape(-1, rows * cols)
    B, dev = flat.shape[0], flat.device
    order = torch.argsort(flat if is_ascend else -flat, dim=1, stable=True)
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(rows * cols, device=dev).expand(B, -1))
    rm = torch.full((B, rows), -1, dtype=torch.long, device=dev)
    cm = torch.full((B, cols), -1, dtype=torch.long, device=dev)
    count = torch.zeros(B, dtype=torch.long, device=dev)
    stop = torch.zeros(B, dtype=torch.bool, device=dev)
    bidx = torch.arange(B, device=dev)
    end = rows * cols
    for _ in range(min(rows, cols) + 1):
        free = ((rm == -1)[:, :, None] & (cm == -1)[:, None, :]).reshape(B, -1)
        key = torch.where(free, pos, end)
        j = key.argmin(dim=1)
        found = key[bidx, j] < end
        r, c = j // cols, j % cols
        val = flat[bidx, j]
        good = (val < threshold) if is_ascend else (val > threshold)
        do = found & good & ~stop
        rm[bidx, r] = torch.where(do, c, rm[bidx, r])
        cm[bidx, c] = torch.where(do, r, cm[bidx, c])
        count += do.long()
        stop |= (found & ~good) | ((topk > 0) & (count > topk) & do)
    return (rm.reshape(lead + (rows,)).to(score.dtype),
            cm.reshape(lead + (cols,)).to(score.dtype))


def _bipartite_infer_shape(in_shapes, attrs):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None, None]
    return in_shapes, [tuple(d[:-1]), tuple(d[:-2]) + (d[-1],)]


register("_contrib_bipartite_matching", _bipartite_matching,
         num_inputs=1, num_outputs=2,
         infer_shape=_bipartite_infer_shape,
         params={"is_ascend": (pBool, False), "threshold": (pFloat, 0.0),
                 "topk": (pInt, -1)},
         doc="Greedy score-ordered bipartite matching (detection target "
             "assignment).")
