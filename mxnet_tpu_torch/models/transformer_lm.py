"""Decoder-only transformer LM as a symbol graph.

The symbol-path counterpart of ``mxnet_tpu/gluon/model_zoo/transformer.py``
(``TransformerLM``), kept as a check on the port's Gluon:
:func:`transformer_lm_symbol` writes, node for node, the graph that
``TransformerLM.export()`` writes — the same ops, node names, attrs,
argument names and order — and the tests hold the port's Gluon export
(``gluon.model_zoo.TransformerLM``) to it, so an export of either
package serves here unchanged.

Architecture: token embedding plus learned positions, ``num_layers``
pre-LN blocks (LN -> multi_head_attention (causal) -> +x, LN -> FFN with
exact GELU -> +x), final LN and an untied vocab head.  Input ``data`` is
(batch, seq_len) token ids; output is (batch, seq_len, vocab_size) logits.
"""
from __future__ import annotations

from .. import symbol as sym


def _param(name, shape, init=None):
    """A parameter variable with the attrs Gluon's export writes."""
    attrs = {"__shape__": str(tuple(shape)), "__dtype__": "float32",
             "__lr_mult__": "1.0", "__wd_mult__": "1.0"}
    if init is not None:
        attrs["__init__"] = '["%s", {}]' % init
    return sym.var(name, attr=attrs)


def _layer_norm(x, prefix, embed_dim):
    return sym.LayerNorm(x, _param(prefix + "gamma", (embed_dim,), "one"),
                         _param(prefix + "beta", (embed_dim,), "zero"),
                         axis=-1, eps=1e-05, name="layernorm0")


def _dense(x, prefix, units):
    # Gluon's Dense(flatten=False) with a deferred input width
    return sym.FullyConnected(x, _param(prefix + "weight", (units, 0)),
                              _param(prefix + "bias", (units,), "zero"),
                              num_hidden=units, flatten=False, name="fwd")


def transformer_lm_symbol(vocab_size, embed_dim=128, num_heads=4,
                          num_layers=2, seq_len=128, ffn_dim=None,
                          prefix="transformerlm0_"):
    """The TransformerLM graph (see the module docstring)."""
    if embed_dim % num_heads:
        raise ValueError("embed_dim %d not divisible by num_heads %d"
                         % (embed_dim, num_heads))
    ffn_dim = ffn_dim or 4 * embed_dim
    data = sym.var("data")
    h = sym.Embedding(data, _param(prefix + "embed_weight",
                                   (vocab_size, embed_dim)),
                      input_dim=vocab_size, output_dim=embed_dim,
                      dtype="float32", name="fwd")
    pos = _param(prefix + "pos", (seq_len, embed_dim), "zero")
    h = sym.broadcast_add(h, sym.expand_dims(pos, axis=0,
                                             name="expand_dims0"),
                          name="broadcast_add0")
    for i in range(num_layers):
        p = "%sl%d_" % (prefix, i)
        x = _layer_norm(h, p + "ln1_", embed_dim)
        proj = []
        for side in ("query", "key", "value", "out"):
            proj.append(_param(p + side + "_weight", (embed_dim, embed_dim)))
            proj.append(_param(p + side + "_bias", (embed_dim,), "zero"))
        attn = sym.multi_head_attention(x, x, x, *proj, num_heads=num_heads,
                                        causal=True, name="attn")
        h = sym.elemwise_add(h, attn, name="elemwise_add0")
        f = _dense(_layer_norm(h, p + "ln2_", embed_dim), p + "ffn1_",
                   ffn_dim)
        f = sym.LeakyReLU(f, act_type="gelu", name="gelu")
        h = sym.elemwise_add(h, _dense(f, p + "ffn2_", embed_dim),
                             name="elemwise_add1")
    return _dense(_layer_norm(h, prefix + "lnf_", embed_dim),
                  prefix + "head_", vocab_size)
