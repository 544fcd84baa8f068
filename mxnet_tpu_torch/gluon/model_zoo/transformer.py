"""Decoder-only transformer blocks for the model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/transformer.py``: the same
blocks, parameter names and graph, built on the port's Gluon.  Each
block's attention is one ``multi_head_attention`` op, whose core is the
flash kernel (``ops/kernels.py``); under ``autograd.record()`` it runs
the kernel's LSE variant and the blockwise flash backward.

Architecture: pre-LN residual blocks (LN -> MHA -> +x, LN -> FFN -> +x),
learned absolute positions, exact-GELU FFN, untied output head.
"""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock
from ..nn import Dense, Embedding, LayerNorm


class TransformerBlock(HybridBlock):
    """One pre-LN decoder block: causal MHA + GELU FFN, both residual.

    The attention projections are parameters of this block (not Dense
    children) because the ``multi_head_attention`` op carries them as
    direct inputs: one graph node per block attends."""

    def __init__(self, embed_dim, num_heads, ffn_dim=None, causal=True,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if embed_dim % num_heads:
            raise ValueError("embed_dim %d not divisible by num_heads %d"
                             % (embed_dim, num_heads))
        self._num_heads = num_heads
        self._causal = causal
        ffn_dim = ffn_dim or 4 * embed_dim
        with self.name_scope():
            self.ln1 = LayerNorm(in_channels=embed_dim, prefix="ln1_")
            self.ln2 = LayerNorm(in_channels=embed_dim, prefix="ln2_")
            for side in ("query", "key", "value", "out"):
                setattr(self, "%s_weight" % side, self.params.get(
                    "%s_weight" % side, shape=(embed_dim, embed_dim),
                    allow_deferred_init=True))
                setattr(self, "%s_bias" % side, self.params.get(
                    "%s_bias" % side, shape=(embed_dim,), init="zeros",
                    allow_deferred_init=True))
            self.ffn1 = Dense(ffn_dim, flatten=False, prefix="ffn1_")
            self.ffn2 = Dense(embed_dim, flatten=False, prefix="ffn2_")

    def hybrid_forward(self, F, x, query_weight, query_bias, key_weight,
                       key_bias, value_weight, value_bias, out_weight,
                       out_bias):
        h = self.ln1(x)
        attn = F.multi_head_attention(
            h, h, h, query_weight, query_bias, key_weight, key_bias,
            value_weight, value_bias, out_weight, out_bias,
            num_heads=self._num_heads, causal=self._causal, name="attn")
        x = x + attn
        f = self.ffn2(F.LeakyReLU(self.ffn1(self.ln2(x)),
                                  act_type="gelu", name="gelu"))
        return x + f


class TransformerLM(HybridBlock):
    """Decoder-only LM: token embedding + learned positions, N pre-LN
    blocks, final LayerNorm, untied vocab head.  Inputs are exactly
    ``seq_len`` tokens (the learned position table's size)."""

    def __init__(self, vocab_size, embed_dim=128, num_heads=4,
                 num_layers=2, seq_len=128, ffn_dim=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._cfg = dict(vocab_size=vocab_size, embed_dim=embed_dim,
                         num_heads=num_heads, num_layers=num_layers,
                         seq_len=seq_len, ffn_dim=ffn_dim or 4 * embed_dim)
        with self.name_scope():
            self.embed = Embedding(vocab_size, embed_dim, prefix="embed_")
            self.pos = self.params.get(
                "pos", shape=(seq_len, embed_dim), init="zeros",
                allow_deferred_init=True)
            self.blocks = []
            for i in range(num_layers):
                blk = TransformerBlock(embed_dim, num_heads,
                                       ffn_dim=self._cfg["ffn_dim"],
                                       prefix="l%d_" % i)
                setattr(self, "_block%d" % i, blk)  # registers the child
                self.blocks.append(blk)
            self.lnf = LayerNorm(in_channels=embed_dim, prefix="lnf_")
            self.head = Dense(vocab_size, flatten=False, prefix="head_")

    def hybrid_forward(self, F, tokens, pos):
        # tokens: [batch, seq] ids -> logits [batch, seq, vocab]
        h = self.embed(tokens)
        h = F.broadcast_add(h, F.expand_dims(pos, axis=0))
        for blk in self.blocks:
            h = blk(h)
        return self.head(self.lnf(h))

    @property
    def config(self):
        return dict(self._cfg)

    def decode_param_arrays(self):
        """The canonical f32 numpy parameter dict of the paged-KV decoder
        (``serving/decode.py``): ``embed``/``pos``, per layer
        ``l{i}.{ln1_g,ln1_b,wq,bq,wk,bk,wv,bv,wo,bo,ln2_g,ln2_b,w1,b1,w2,
        b2}``, then ``lnf_g/lnf_b/head_w/head_b`` — the JAX package's
        keys, free of Gluon name prefixes, so either package's decoder
        takes the dict of either package's model."""
        def arr(p):
            return p.data().asnumpy().astype(np.float32)

        out = {"embed": arr(self.embed.weight), "pos": arr(self.pos)}
        for i, blk in enumerate(self.blocks):
            pre = "l%d." % i
            for key, p in (("ln1_g", blk.ln1.gamma), ("ln1_b", blk.ln1.beta),
                           ("wq", blk.query_weight), ("bq", blk.query_bias),
                           ("wk", blk.key_weight), ("bk", blk.key_bias),
                           ("wv", blk.value_weight), ("bv", blk.value_bias),
                           ("wo", blk.out_weight), ("bo", blk.out_bias),
                           ("ln2_g", blk.ln2.gamma), ("ln2_b", blk.ln2.beta),
                           ("w1", blk.ffn1.weight), ("b1", blk.ffn1.bias),
                           ("w2", blk.ffn2.weight), ("b2", blk.ffn2.bias)):
                out[pre + key] = arr(p)
        out["lnf_g"] = arr(self.lnf.gamma)
        out["lnf_b"] = arr(self.lnf.beta)
        out["head_w"] = arr(self.head.weight)
        out["head_b"] = arr(self.head.bias)
        return out


def transformer_lm(vocab_size, **kwargs):
    """Zoo-style constructor."""
    return TransformerLM(vocab_size, **kwargs)
