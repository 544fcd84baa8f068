"""Expert parallelism: mixture-of-experts FFN with all_to_all dispatch.

Counterpart of ``mxnet_tpu/parallel/moe.py``.  Experts are split over
``ep``; each position routes its tokens to their top-1 expert into a
capacity buffer, an all_to_all over ``ep`` hands every position its
local experts' buffers from every source, the expert FFN runs as one
batched product per position (torch ``einsum``, as the JAX package's is
``jnp``), and the inverse all_to_all routes the results back.

Capacity is per position: ``max(1, int(capacity_factor * t_local //
n_exp))``, where ``t_local`` is the position's own token count after the
``batch_axis`` split, and slots are counted within that position's
tokens.  With ``batch_axis=None`` every ``ep`` position routes the whole
token set.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..context import current_context
from . import collectives
from .mesh import NamedSharding, P, assemble, current_mesh, split


def _route(x, gate_w, n_exp, capacity_factor):
    """One position's top-1 routing: its [n_exp, cap, d] dispatch buffer
    and what combining needs (target expert, slot, kept, gate)."""
    t_local, d = x.shape
    cap = max(1, int(capacity_factor * t_local // n_exp))

    # top-1 gating
    logits = x @ gate_w                               # [t, n_exp]
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)          # [t]
    gate = probs.gather(1, expert_idx[:, None])[:, 0]

    # position of each token within its expert's capacity buffer
    onehot = F.one_hot(expert_idx, n_exp).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) * onehot        # 1-based slot per token
    slot = pos.sum(dim=-1) - 1                        # [t]
    keep = slot < cap                                 # overflow tokens drop

    # scatter tokens into the [n_exp, cap, d] dispatch buffer
    target = torch.where(keep, expert_idx, torch.zeros_like(expert_idx))
    slot_c = torch.clamp(slot, 0, cap - 1).long()
    buf = torch.zeros((n_exp, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((target, slot_c),
                        torch.where(keep[:, None], x, torch.zeros_like(x)),
                        accumulate=True)
    return buf, (target, slot_c, keep, gate)


def _moe_local(xs, gate_ws, w1s, w2s, mesh, axis_name, capacity_factor):
    """The positions' MoE: xs [tokens_local, d] each; experts split on
    dim 0 of w1 [e_local, d, hidden] and w2 [e_local, hidden, d]."""
    ep = mesh.shape[axis_name]
    e_local = w1s[0].shape[0]
    n_exp = ep * e_local
    routed = [_route(x, g, n_exp, capacity_factor)
              for x, g in zip(xs, gate_ws)]
    cap, d = routed[0][0].shape[1:]

    # all_to_all: each position gets its local experts' buffers from every
    # source: [ep(target), e_local, cap, d] -> [ep(source), e_local, cap,
    # d] -> [e_local, ep*cap, d]
    bufs = collectives.all_to_all(
        [buf.reshape(ep, e_local, cap, d) for buf, _ in routed], mesh,
        axis_name, 0, 0)
    ys = []
    for buf, w1, w2 in zip(bufs, w1s, w2s):
        buf = buf.transpose(0, 1).reshape(e_local, ep * cap, d)
        # expert FFN: batched product over local experts
        h = torch.relu(torch.einsum("ecd,edh->ech", buf, w1))
        y = torch.einsum("ech,ehd->ecd", h, w2)
        ys.append(y.reshape(e_local, ep, cap, d).transpose(0, 1))
    # route back: inverse exchange
    ys = collectives.all_to_all(ys, mesh, axis_name, 0, 0)
    out = []
    for x, y, (_, (target, slot_c, keep, gate)) in zip(xs, ys, routed):
        y = y.reshape(n_exp, cap, d)
        o = y[target, slot_c] * keep[:, None].to(y.dtype) * gate[:, None]
        out.append(o.to(x.dtype))
    return out


def moe_ffn(x, gate_w, w1, w2, mesh=None, axis_name="ep",
            capacity_factor=1.25, batch_axis=None):
    """MoE FFN over a token batch.

    x: [tokens, d] (or [b, s, d], flattened internally); batch_axis
    optionally splits the token dim (e.g. 'dp');
    gate_w: [d, n_experts] replicated; w1: [n_experts, d, hidden] and
    w2: [n_experts, hidden, d], split over experts (dim 0) on `ep`.
    """
    mesh = mesh or current_mesh()
    orig_shape = x.shape
    if x.dim() == 3:
        x = x.reshape(-1, x.shape[-1])
    tokens = NamedSharding(mesh, P(batch_axis))
    experts = NamedSharding(mesh, P(axis_name))
    out = _moe_local(split(x, tokens),
                     split(gate_w, NamedSharding(mesh, P())),
                     split(w1, experts), split(w2, experts), mesh,
                     axis_name, capacity_factor)
    return assemble(out, tokens, x.device).reshape(orig_shape)


class MoELayer:
    """Parameter container for moe_ffn (gluon-free; used by the parallel
    tests and the multichip LM).  ``key`` is a seed or a
    ``torch.Generator`` (the JAX package's takes a PRNG key; the draws
    differ); the weights are drawn on the host and placed on ``ctx``
    (default: the current context)."""

    def __init__(self, n_experts, d_model, d_hidden, key,
                 dtype=torch.float32, ctx=None):
        gen = key if isinstance(key, torch.Generator) \
            else torch.Generator().manual_seed(int(key))
        dev = (ctx or current_context()).torch_device()
        s1 = (2.0 / d_model) ** 0.5

        def normal(*shape):
            return torch.randn(shape, generator=gen, dtype=dtype)
        self.gate_w = (normal(d_model, n_experts) * s1).to(dev)
        self.w1 = (normal(n_experts, d_model, d_hidden) * s1).to(dev)
        self.w2 = (normal(n_experts, d_hidden, d_model)
                   * (2.0 / d_hidden) ** 0.5).to(dev)

    def __call__(self, x, mesh=None):
        return moe_ffn(x, self.gate_w, self.w1, self.w2, mesh=mesh)
