"""Fused Gluon RNN layers (ref: python/mxnet/gluon/rnn/rnn_layer.py).

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``.  Every layer runs
the fused ``RNN`` op (``ops/rnn_op.py``: cuDNN's RNN kernels on the card,
torch's on the host).  Parameters are stored per layer and direction
under the reference's names (``{l,r}{i}_{i2h,h2h}_{weight,bias}``) and
concatenated into the op's flat vector at every forward, so their
gradients flow back through the concatenation.
"""
from __future__ import annotations

from ..block import Block
from ... import ndarray as nd

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(Block):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                self._register_param("%s%d_i2h_weight" % (j, i),
                                     (ng * nh, ni), i2h_weight_initializer)
                self._register_param("%s%d_h2h_weight" % (j, i),
                                     (ng * nh, nh), h2h_weight_initializer)
                self._register_param("%s%d_i2h_bias" % (j, i),
                                     (ng * nh,), i2h_bias_initializer)
                self._register_param("%s%d_h2h_bias" % (j, i),
                                     (ng * nh,), h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        if func is None:
            func = nd.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            info = dict(info)
            info.update(kwargs)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **info))
        return states

    def _flat_params(self, ctx):
        """Concatenate per-layer params into the fused op's flat layout
        (all W,R first, then all biases — rnn_op._unpack_params order)."""
        ws, bs = [], []
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                ws.append(getattr(self, "%s%d_i2h_weight" % (j, i))
                          .data(ctx).reshape((-1,)))
                ws.append(getattr(self, "%s%d_h2h_weight" % (j, i))
                          .data(ctx).reshape((-1,)))
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                bs.append(getattr(self, "%s%d_i2h_bias" % (j, i)).data(ctx))
                bs.append(getattr(self, "%s%d_h2h_bias" % (j, i)).data(ctx))
        return nd.concat(*(ws + bs), dim=0)

    def forward(self, inputs, states=None):
        ctx = inputs.context
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=ctx)
        if isinstance(states, nd.NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(state.shape)))
        if self._input_size == 0:
            # finish deferred param init from the observed input size
            for i in (["l", "r"] if self._dir == 2 else ["l"]):
                p = getattr(self, "%s0_i2h_weight" % i)
                if not p.shape or p.shape[1] == 0:
                    p.shape = (self._gates * self._hidden_size,
                               inputs.shape[-1])
            self._input_size = inputs.shape[-1]
        for _, p in self.params.items():
            p._finish_deferred_init()
        if self._layout == "NTC":
            inputs = nd.swapaxes(inputs, dim1=0, dim2=1)
        flat = self._flat_params(ctx)
        rnn_args = [inputs, flat] + states
        outputs = nd.RNN(*rnn_args, state_size=self._hidden_size,
                         num_layers=self._num_layers,
                         bidirectional=self._dir == 2,
                         p=self._dropout, state_outputs=True,
                         mode=self._mode)
        if self._mode == "lstm":
            outputs, states = outputs[0], [outputs[1], outputs[2]]
        else:
            outputs, states = outputs[0], [outputs[1]]
        if self._layout == "NTC":
            outputs = nd.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, states

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        mapping = "{0} -> {1}".format(
            self._input_size if self._input_size else None, self._hidden_size)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)


class RNN(_RNNLayer):
    """Elman RNN with tanh or relu activation (ref: rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "rnn_" + activation,
                         **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (ref: rnn_layer.py LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (ref: rnn_layer.py GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
