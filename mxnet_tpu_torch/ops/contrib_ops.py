"""Contrib operators: the CTC loss, the bounding-box ops, the MultiBox
(SSD) trio, quantize/dequantize and the FFT pair.

Counterpart of ``mxnet_tpu/ops/contrib_ops.py`` (ref:
src/operator/contrib/).  The JAX package replaces warp-ctc's kernels with a
log-space alpha recursion in a ``lax.scan``, differentiated by autodiff;
the port runs the same recursion step by step in torch ops, differentiated
by torch autograd.  Unreachable states hold -1e30, not -inf: ``logaddexp``
of two -inf has a NaN gradient.  So an impossible alignment gives a loss
of about 1e30, not inf (where ``torch.nn.functional.ctc_loss`` gives inf).
``logaddexp`` takes the JAX package's derivative, ``exp(x - out)`` for
each input: where -1e30 has absorbed ``log 2`` (two unreachable states
meet) that is 1 for each input, where torch's own derivative gives 1/2, so
the gradient of an impossible alignment is the JAX package's too.

``box_nms`` (and ``MultiBoxDetection``'s suppression) keeps the JAX
package's scan semantics: a stable descending sort by score; a box
suppresses only if it is valid and still kept; suppression is class-aware
unless ``force_suppress``; ``topk`` ranks among all boxes; suppressed rows
become -1 in the input order.  Its sweep is the ``nms`` kernel family of
``ops/kernels.py`` (``csrc/box_nms.cu`` on the card).  The MultiBox ops
follow the JAX bodies (ROADMAP R14): ``MultiBoxTarget`` matches by
threshold alone, ``MultiBoxDetection`` keeps anchor order.  Their float
tuple attrs (``sizes``, ``ratios``, ``steps``, ``offsets``,
``variances``) parse as floats, as MXNet 1.0's do, where the JAX
registry truncates them to ints.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import kernels as K
from .extra import _div
from .image_ops import _const, pFloatTuple
from .registry import pBool, pFloat, pInt, pStr, register

_NEG_INF = -1e30


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` with the JAX package's derivative."""

    @staticmethod
    def forward(ctx, x1, x2):
        out = torch.logaddexp(x1, x2)
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x1, x2, out = ctx.saved_tensors
        return grad * torch.exp(x1 - out), grad * torch.exp(x2 - out)


_logaddexp = _LogAddExp.apply


def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """data: [T, N, A] unnormalized activations; label: [N, L] padded with
    the blank (or any negative value).  Returns [N] negative log
    likelihoods."""
    T, N, A = data.shape
    L = label.shape[1]
    logp = torch.log_softmax(data, dim=-1)
    dev = data.device
    lab = label.to(torch.int64)
    blank = A - 1 if blank_label == "last" else 0
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.to(torch.int64)
    else:
        lab_len = ((lab != blank) & (lab >= 0)).sum(dim=1)
    if use_data_lengths and data_lengths is not None:
        seq_len = data_lengths.to(torch.int64)
    else:
        seq_len = torch.full((N,), T, dtype=torch.int64, device=dev)

    # extended sequence: blank, l1, blank, l2, ..., blank (length S=2L+1)
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    pos = torch.arange(S, device=dev)
    ext_valid = pos[None, :] < (2 * lab_len + 1)[:, None]
    # a step may skip from s-2 to s when ext[s] is neither blank nor ext[s-2]
    ext_m2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    # emit[t, n, s] = logp[t, n, ext[n, s]], gathered once for every step;
    # the class index as the JAX package's indexing takes it (a negative
    # one counts from the end, one out of range is clamped)
    cls = torch.where(ext < 0, ext + A, ext).clamp(0, A - 1)
    emit = torch.gather(logp, 2, cls[None].expand(T, N, S))

    neg = torch.full((N, S), _NEG_INF, dtype=logp.dtype, device=dev)
    first = (pos[None, :] == 0) | ((pos[None, :] == 1) & (lab_len > 0)[:, None])
    alpha = torch.where(first, emit[0], neg)
    pad1 = neg[:, :1]
    pad2 = neg[:, :2]
    for t in range(1, T):
        a_m1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a_m2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                           neg)
        merged = _logaddexp(_logaddexp(alpha, a_m1), a_m2)
        new_alpha = torch.where(ext_valid, merged + emit[t], neg)
        # frozen once past this sample's sequence length
        alpha = torch.where((t < seq_len)[:, None], new_alpha, alpha)
    # final prob: alpha at the last blank and at the last label
    last = 2 * lab_len
    idx = torch.arange(N, device=dev)
    a_last = alpha[idx, last]
    a_prev = torch.where(lab_len > 0, alpha[idx, torch.clamp(last - 1, min=0)],
                         neg[:, 0])
    return -_logaddexp(a_last, a_prev)


register("_contrib_CTCLoss", _ctc_loss,
         input_names=("data", "label", "data_lengths", "label_lengths"),
         num_inputs=lambda attrs: 2 + bool(attrs.get("use_data_lengths"))
         + bool(attrs.get("use_label_lengths")),
         aliases=("ctc_loss", "CTCLoss", "_contrib_ctc_loss"),
         params={"use_data_lengths": (pBool, False),
                 "use_label_lengths": (pBool, False),
                 "blank_label": (pStr, "first")})


# ---------------------------------------------------------------------------
# Bounding boxes (ref: src/operator/contrib/bounding_box-inl.h)
# ---------------------------------------------------------------------------

def _to_corner(x):
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _box_iou(lhs, rhs, format="corner"):
    if format == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    return K.pairwise_iou(lhs, rhs)


register("_contrib_box_iou", _box_iou, num_inputs=2,
         aliases=("box_iou",), params={"format": (pStr, "corner")})


def _box_nms(data, overlap_thresh=0.5, valid_thresh=0, topk=-1, coord_start=2,
             score_index=1, id_index=-1, force_suppress=False,
             in_format="corner", out_format="corner"):
    """Fixed-shape NMS over the last two axes [..., M, E]: the output keeps
    the input's shape, suppressed rows set to -1 (the reference's
    convention)."""
    if in_format != out_format:
        raise MXNetError("box_nms: in_format != out_format is not "
                         "supported (boxes pass through unchanged)")
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:])) if data.ndim > 2 \
        else data[None]
    scores = flat[..., score_index]
    boxes = flat[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _to_corner(boxes)
    cls = flat[..., id_index] if id_index >= 0 else torch.zeros_like(scores)
    valid = scores > valid_thresh
    order, rank = K.nms_order(scores)
    keep = K.box_nms_keep(boxes.detach().float(), cls.detach().float(),
                          valid, order, rank, overlap_thresh,
                          force_suppress) & valid
    if topk > 0:
        keep = keep & (rank < topk)
    return torch.where(keep[..., None], flat, -1.0).reshape(shape)


def _same_shape(in_shapes, attrs):
    return in_shapes, [in_shapes[0]]


register("_contrib_box_nms", _box_nms, num_inputs=1, aliases=("box_nms",),
         infer_shape=_same_shape,
         params={"overlap_thresh": (pFloat, 0.5), "valid_thresh": (pFloat, 0),
                 "topk": (pInt, -1), "coord_start": (pInt, 2),
                 "score_index": (pInt, 1), "id_index": (pInt, -1),
                 "force_suppress": (pBool, False),
                 "in_format": (pStr, "corner"),
                 "out_format": (pStr, "corner")})


# ---------------------------------------------------------------------------
# MultiBox (SSD) ops (ref: src/operator/contrib/multibox_*.cc)
# ---------------------------------------------------------------------------

def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchor boxes for a feature map [N, C, H, W] ->
    [1, H*W*(len(sizes)+len(ratios)-1), 4] on the data's device: computed
    in float64, as the JAX package computes them (it runs with x64 on),
    and returned in float32, where the JAX package's stay float64 (ROADMAP
    R15)."""
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    f64 = torch.float64
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=f64, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(W, dtype=f64, device=dev) + offsets[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([cxg.reshape(-1), cyg.reshape(-1)], dim=-1)
    whs = []
    for s in sizes:
        r = float(ratios[0]) ** 0.5
        whs.append((s * r, s / r))
    for r in list(ratios)[1:]:
        r = float(r) ** 0.5
        s = float(sizes[0])
        whs.append((s * r, s / r))
    # kept on each device once: a host-to-device copy cannot run inside a
    # CUDA-graph capture
    half = _const(tuple(whs), dev, f64)[None] / 2
    c = centers[:, None, :].expand(-1, len(whs), 2)   # [HW, K, 2]
    boxes = torch.cat([c - half, c + half], dim=-1).reshape(-1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0, 1)
    return boxes[None].to(torch.float32)


def _multibox_prior_shape(in_shapes, attrs):
    d = in_shapes[0]
    if d is None:
        return in_shapes, None
    k = len(attrs["sizes"]) + len(attrs["ratios"]) - 1
    return in_shapes, [(1, d[2] * d[3] * k, 4)]


register("_contrib_MultiBoxPrior", _multibox_prior, num_inputs=1,
         aliases=("MultiBoxPrior",), infer_shape=_multibox_prior_shape,
         params={"sizes": (pFloatTuple, (1.0,)),
                 "ratios": (pFloatTuple, (1.0,)),
                 "clip": (pBool, False),
                 "steps": (pFloatTuple, (-1.0, -1.0)),
                 "offsets": (pFloatTuple, (0.5, 0.5))})


def _anchor_geometry(anc):
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    return aw, ah, (anc[:, 0] + anc[:, 2]) / 2, (anc[:, 1] + anc[:, 3]) / 2


def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1, negative_mining_ratio=-1,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to ground-truth boxes by IoU threshold (the JAX
    package's matching: no bipartite step, no negative mining, no
    ``ignore_label``; ``cls_pred`` is not read).  anchor [1, A, 4]; label
    [N, O, 5] (class, 4 box; -1 padded) -> (loc_target [N, A*4], loc_mask
    [N, A*4], cls_target [N, A])."""
    A = anchor.shape[1]
    N = label.shape[0]
    anc = anchor[0]
    v = _const(tuple(variances), anc.device)
    gt_cls = label[..., 0]
    gt_box = label[..., 1:5]
    iou = K.pairwise_iou(anc, gt_box)                       # [N, A, O]
    iou = torch.where((gt_cls >= 0)[:, None, :], iou, -1.0)
    best_iou, best_gt = iou.max(dim=2)
    matched = best_iou > overlap_threshold
    tgt = torch.gather(gt_box, 1, best_gt[..., None].expand(N, A, 4))
    aw, ah, acx, acy = _anchor_geometry(anc)
    aw_ = torch.clamp(aw, min=1e-8)
    ah_ = torch.clamp(ah, min=1e-8)
    gw = torch.clamp(tgt[..., 2] - tgt[..., 0], min=1e-8)
    gh = torch.clamp(tgt[..., 3] - tgt[..., 1], min=1e-8)
    gcx = (tgt[..., 0] + tgt[..., 2]) / 2
    gcy = (tgt[..., 1] + tgt[..., 3]) / 2
    loc = torch.stack([(gcx - acx) / aw_ / v[0], (gcy - acy) / ah_ / v[1],
                       torch.log(gw / aw_) / v[2],
                       torch.log(gh / ah_) / v[3]], dim=-1)
    loc = torch.where(matched[..., None], loc, 0.0)
    mask = torch.where(matched[..., None], 1.0, 0.0).expand(N, A, 4)
    cls_t = torch.where(matched, torch.gather(gt_cls, 1, best_gt) + 1, 0.0)
    return loc.reshape(N, -1), mask.reshape(N, -1).to(loc.dtype), cls_t


def _multibox_target_shape(in_shapes, attrs):
    a, lab = in_shapes[0], in_shapes[1]
    if a is None or lab is None:
        return in_shapes, None
    return in_shapes, [(lab[0], a[1] * 4), (lab[0], a[1] * 4),
                       (lab[0], a[1])]


register("_contrib_MultiBoxTarget", _multibox_target,
         input_names=("anchor", "label", "cls_pred"), num_outputs=3,
         aliases=("MultiBoxTarget",), infer_shape=_multibox_target_shape,
         params={"overlap_threshold": (pFloat, 0.5),
                 "ignore_label": (pFloat, -1),
                 "negative_mining_ratio": (pFloat, -1),
                 "negative_mining_thresh": (pFloat, 0.5),
                 "minimum_negative_samples": (pInt, 0),
                 "variances": (pFloatTuple, (0.1, 0.1, 0.2, 0.2))})


def _multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                        background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode predictions into detections [N, A, 6] (class, score, 4 box)
    in anchor order, then the class-aware NMS with ``valid_thresh =
    threshold`` and ``topk = nms_topk``."""
    N = cls_prob.shape[0]
    A = anchor.shape[1]
    anc = anchor[0]
    v = _const(tuple(variances), anc.device)
    aw, ah, acx, acy = _anchor_geometry(anc)
    loc = loc_pred.reshape(N, A, 4)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw
    h = torch.exp(loc[..., 3] * v[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0, 1)
    # the best non-background class of each anchor
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    score, cls_id = fg.max(dim=1)
    keep = score > threshold
    det = torch.cat([torch.where(keep, cls_id.to(score.dtype),
                                 -1.0)[..., None], score[..., None], boxes],
                    dim=-1)
    return _box_nms(det, overlap_thresh=nms_threshold, valid_thresh=threshold,
                    topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                    force_suppress=force_suppress)


def _multibox_detection_shape(in_shapes, attrs):
    c, a = in_shapes[0], in_shapes[2]
    if c is None or a is None:
        return in_shapes, None
    return in_shapes, [(c[0], a[1], 6)]


register("_contrib_MultiBoxDetection", _multibox_detection,
         input_names=("cls_prob", "loc_pred", "anchor"),
         aliases=("MultiBoxDetection",),
         infer_shape=_multibox_detection_shape,
         params={"clip": (pBool, True), "threshold": (pFloat, 0.01),
                 "background_id": (pInt, 0),
                 "nms_threshold": (pFloat, 0.5),
                 "force_suppress": (pBool, False),
                 "variances": (pFloatTuple, (0.1, 0.1, 0.2, 0.2)),
                 "nms_topk": (pInt, -1)})


# ---------------------------------------------------------------------------
# Quantization (ref: src/operator/contrib/quantize*.cc int8 experiments)
# ---------------------------------------------------------------------------

def _quantize(data, min_range, max_range, out_type="uint8"):
    """Linear quantization to uint8 [0, 255] or int8 [-127, 127], rounding
    half to even; the range passes through."""
    if out_type == "uint8":
        qmin, qmax, dt = 0.0, 255.0, torch.uint8
    else:
        qmin, qmax, dt = -127.0, 127.0, torch.int8
    span = torch.clamp(max_range - min_range, min=1e-8)
    scale = torch.full_like(span, qmax - qmin) / span
    q = torch.clamp(torch.round((data - min_range) * scale + qmin), qmin,
                    qmax)
    return q.to(dt), min_range.view_as(min_range), \
        max_range.view_as(max_range)


register("_contrib_quantize", _quantize,
         input_names=("data", "min_range", "max_range"), num_outputs=3,
         aliases=("quantize",), params={"out_type": (pStr, "uint8")})


def _dequantize(data, min_range, max_range, out_type="float32"):
    if data.dtype == torch.uint8:
        qmin, qmax = 0.0, 255.0
    else:
        qmin, qmax = -127.0, 127.0
    scale = _div(max_range - min_range, qmax - qmin)
    return (data.to(torch.float32) - qmin) * scale + min_range


register("_contrib_dequantize", _dequantize,
         input_names=("data", "min_range", "max_range"),
         aliases=("dequantize",), params={"out_type": (pStr, "float32")})


# ---------------------------------------------------------------------------
# FFT (ref: src/operator/contrib/fft-inl.h; cuFFT through torch.fft on the
# card)
# ---------------------------------------------------------------------------

def _fft(data, compute_size=128):
    """FFT over the last axis of real data; the output interleaves real and
    imaginary parts ([..., 2n], the reference's layout).  ``compute_size``
    is accepted and ignored."""
    out = torch.view_as_real(torch.fft.fft(data, dim=-1))
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)).to(
        data.dtype)


register("_contrib_fft", _fft, num_inputs=1, aliases=("fft",),
         params={"compute_size": (pInt, 128)})


def _ifft(data, compute_size=128):
    """The real part of the inverse FFT of interleaved [..., 2n] data,
    times n (unnormalised, as the JAX package's)."""
    n = data.shape[-1] // 2
    c = data.reshape(data.shape[:-1] + (n, 2))
    comp = torch.complex(c[..., 0], c[..., 1])
    return torch.fft.ifft(comp, dim=-1).real.to(data.dtype) * n


register("_contrib_ifft", _ifft, num_inputs=1, aliases=("ifft",),
         params={"compute_size": (pInt, 128)})
