"""Contrib operators: the CTC loss.

Counterpart of the ``_contrib_CTCLoss`` op of
``mxnet_tpu/ops/contrib_ops.py`` (ref: src/operator/contrib/ctc_loss-inl.h);
the file's other ops wait for the rest of the op surface.  The JAX package
replaces warp-ctc's kernels with a log-space alpha recursion in a
``lax.scan``, differentiated by autodiff; the port runs the same recursion
step by step in torch ops, differentiated by torch autograd.  Unreachable
states hold -1e30, not -inf: ``logaddexp`` of two -inf has a NaN gradient.
So an impossible alignment gives a loss of about 1e30, not inf (where
``torch.nn.functional.ctc_loss`` gives inf).  ``logaddexp`` takes the JAX
package's derivative, ``exp(x - out)`` for each input: where -1e30 has
absorbed ``log 2`` (two unreachable states meet) that is 1 for each input,
where torch's own derivative gives 1/2, so the gradient of an impossible
alignment is the JAX package's too.
"""
from __future__ import annotations

import torch

from .registry import pBool, pStr, register

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
