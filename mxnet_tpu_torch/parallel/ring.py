"""Ring attention: exact attention over sequences split across positions.

Counterpart of ``mxnet_tpu/parallel/ring.py``.  The sequence axis is
split over the mesh's ``sp`` axis; each position holds a Q/K/V block.
For ``sp`` rounds every position attends its Q block to the K/V block it
holds, folding the result into a running online-softmax state (max m,
normalizer l, weighted sum acc), and then the K/V blocks move one
position along the ring (i -> i+1, ``collectives.ppermute``).  The
result is exact: single-block attention to float tolerance.

Layout: [batch, seq, heads, head_dim].  The block attention is torch
ops (``einsum``), as it is ``jnp`` in the JAX package; the port's flash
kernel is its single-block counterpart.
"""
from __future__ import annotations

import torch

from . import collectives
from .mesh import NamedSharding, P, assemble, current_mesh, split


def _block_attn(q, k, v, bias, scale):
    """One q-block x kv-block attention, returning (scores_max, exp_sums,
    weighted_values) for online-softmax accumulation.
    q: [B, Sq, H, D], k/v: [B, Sk, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)                              # [B, H, Sq]
    p = torch.exp(s - m[..., None])                 # [B, H, Sq, Sk]
    l = p.sum(dim=-1)                               # [B, H, Sq]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)       # [B, Sq, H, D]
    return m, l, o


def _causal_bias(q_idx, kv_idx, seq_local, sk, neg_inf, like):
    # global positions: row = q_idx*seq_local + i, col = kv_idx*seq_local + j
    rows = q_idx * seq_local + torch.arange(seq_local, device=like.device)
    cols = kv_idx * seq_local + torch.arange(sk, device=like.device)
    mask = rows[:, None] >= cols[None, :]
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    return torch.where(mask, zero, neg_inf.to(like.device))[None, None]


def _ring_attn_local(qs, ks, vs, mesh, axis_name, causal, scale):
    """The positions' ring: qs/ks/vs hold each position's local sequence
    blocks; returns each position's output block."""
    sp = mesh.shape[axis_name]
    idx = [mesh.coords(p)[axis_name] for p in range(mesh.size)]
    q0 = qs[0]
    seq_local = q0.shape[1]
    neg_inf = torch.tensor(torch.finfo(q0.dtype).max, dtype=q0.dtype) \
        * torch.tensor(-1.0, dtype=q0.dtype)
    b, _, h, _ = q0.shape
    m_acc = [torch.full((b, h, seq_local), float(neg_inf), dtype=q.dtype,
                        device=q.device) for q in qs]
    l_acc = [torch.zeros((b, h, seq_local), dtype=q.dtype, device=q.device)
             for q in qs]
    o_acc = [torch.zeros_like(q) for q in qs]
    kv_idx = list(idx)
    perm = [(j, (j + 1) % sp) for j in range(sp)]
    for _ in range(sp):
        for p, q in enumerate(qs):
            bias = _causal_bias(idx[p], kv_idx[p], seq_local, ks[p].shape[1],
                                neg_inf, q) if causal else None
            m_blk, l_blk, o_blk = _block_attn(q, ks[p], vs[p], bias, scale)
            m_new = torch.maximum(m_acc[p], m_blk)
            alpha = torch.exp(m_acc[p] - m_new)   # rescale old accumulator
            beta = torch.exp(m_blk - m_new)       # rescale new block
            l_acc[p] = l_acc[p] * alpha + l_blk * beta
            o_acc[p] = (o_acc[p] * alpha.transpose(1, 2)[..., None]
                        + o_blk * beta.transpose(1, 2)[..., None])
            m_acc[p] = m_new
        # rotate kv around the ring: position i sends to position i+1
        ks = collectives.ppermute(ks, mesh, axis_name, perm)
        vs = collectives.ppermute(vs, mesh, axis_name, perm)
        kv_idx = [(i - 1) % sp for i in kv_idx]
    out = []
    for l_fin, o_fin in zip(l_acc, o_acc):
        l_fin = torch.where(l_fin == 0, torch.ones_like(l_fin), l_fin)
        out.append(o_fin / l_fin.transpose(1, 2)[..., None])
    return out


def ring_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                   scale=None, batch_axis=None):
    """Exact multi-head attention with the sequence dim split over
    `axis_name`.  q/k/v: [batch, seq, heads, head_dim] global tensors;
    the output is global, on q's device.  batch_axis optionally splits
    dim 0 (e.g. 'dp') so data parallelism composes with the ring.

    With axis size 1 this is plain attention — same code path, the ring
    degenerates to one block.
    """
    mesh = mesh or current_mesh()
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    sharding = NamedSharding(mesh, P(batch_axis, axis_name, None, None))
    out = _ring_attn_local(split(q, sharding), split(k, sharding),
                           split(v, sharding), mesh, axis_name, causal,
                           scale)
    return assemble(out, sharding, q.device)


def ring_self_attention(x, wq, wk, wv, wo, num_heads, mesh=None,
                        axis_name="sp", causal=True, batch_axis=None):
    """qkv-projection + ring attention + output projection.
    x: [batch, seq, model_dim]; w*: [model_dim, model_dim]."""
    b, s, dm = x.shape
    dh = dm // num_heads

    def proj(w):
        return torch.einsum("bsm,mn->bsn", x, w).reshape(b, s, num_heads, dh)

    q, k, v = proj(wq), proj(wk), proj(wv)
    o = ring_attention(q, k, v, mesh=mesh, axis_name=axis_name,
                       causal=causal, batch_axis=batch_axis)
    return torch.einsum("bsn,nm->bsm", o.reshape(b, s, dm), wo)
