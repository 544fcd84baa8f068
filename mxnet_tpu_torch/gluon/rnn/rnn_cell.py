"""Gluon recurrent cells (ref: python/mxnet/gluon/rnn/rnn_cell.py).

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: per-step cells for
explicit unrolling, with the JAX package's names, gate orders (LSTM
i, f, g, o; GRU r, z, n, as the fused ``RNN`` op) and structure.  The
fused layers of ``rnn_layer.py`` are the fast path.  As in the reference
MXNet, ``unroll`` makes its begin state on the inputs' context.  Dropout
and zoneout masks come from the port's generator (``mx.random.seed``),
so their bits differ from the JAX package's.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ... import random as _random
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "ModifierCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children:
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            info.update(kwargs)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **info)
                          if "name" not in func.__code__.co_varnames
                          else func(name="%sbegin_state_%d" % (
                              self.prefix, self._init_counter),
                              shape=shape, **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        seq, batch_size = _time_steps(inputs, length, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=seq[0].context)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(seq[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        return super().forward(inputs, states)


def _time_steps(inputs, length, layout):
    """(list of per-step inputs, batch size) from a list of steps or one
    array in ``layout``."""
    if isinstance(inputs, (list, tuple)):
        return list(inputs), inputs[0].shape[0]
    axis = layout.find("T")
    return ([nd.squeeze(nd.slice_axis(inputs, axis, i, i + 1), axis=axis)
             for i in range(length)], inputs.shape[layout.find("N")])


class HybridRecurrentCell(RecurrentCell):
    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _cell_param(cell, name, shape, init):
    return cell.params.get(name, shape=shape, init=init,
                           allow_deferred_init=True)


class RNNCell(HybridRecurrentCell):
    """Simple Elman cell: h' = act(W x + R h + b)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = _cell_param(self, "i2h_weight",
                                      (hidden_size, input_size),
                                      i2h_weight_initializer)
        self.h2h_weight = _cell_param(self, "h2h_weight",
                                      (hidden_size, hidden_size),
                                      h2h_weight_initializer)
        self.i2h_bias = _cell_param(self, "i2h_bias", (hidden_size,),
                                    i2h_bias_initializer)
        self.h2h_bias = _cell_param(self, "h2h_bias", (hidden_size,),
                                    h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM (gate order i,f,g,o to match the fused RNN op / cuDNN layout)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = _cell_param(self, "i2h_weight",
                                      (4 * hidden_size, input_size),
                                      i2h_weight_initializer)
        self.h2h_weight = _cell_param(self, "h2h_weight",
                                      (4 * hidden_size, hidden_size),
                                      h2h_weight_initializer)
        self.i2h_bias = _cell_param(self, "i2h_bias", (4 * hidden_size,),
                                    i2h_bias_initializer)
        self.h2h_bias = _cell_param(self, "h2h_bias", (4 * hidden_size,),
                                    h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4)
        in_gate = F.Activation(slices[0], act_type="sigmoid")
        forget_gate = F.Activation(slices[1], act_type="sigmoid")
        in_transform = F.Activation(slices[2], act_type="tanh")
        out_gate = F.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU (gate order r,z,n to match the fused RNN op / cuDNN layout)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = _cell_param(self, "i2h_weight",
                                      (3 * hidden_size, input_size),
                                      i2h_weight_initializer)
        self.h2h_weight = _cell_param(self, "h2h_weight",
                                      (3 * hidden_size, hidden_size),
                                      h2h_weight_initializer)
        self.i2h_bias = _cell_param(self, "i2h_bias", (3 * hidden_size,),
                                    i2h_bias_initializer)
        self.h2h_bias = _cell_param(self, "h2h_bias", (3 * hidden_size,),
                                    h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = (s for s in F.SliceChannel(i2h, num_outputs=3))
        h2h_r, h2h_z, h2h_n = (s for s in F.SliceChannel(h2h, num_outputs=3))
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset_gate * h2h_n,
                                  act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells (ref: rnn_cell.py SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, batch_size, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children:
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, batch_size, **kwargs):
    return sum([c.begin_state(batch_size, **kwargs) for c in cells], [])


class ModifierCell(HybridRecurrentCell):
    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(HybridRecurrentCell):
    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate)
        return inputs, states


def _zoneout_mask(like, rate):
    """Where to keep the previous value: True with probability ``rate``,
    drawn from the port's generator on ``like``'s device."""
    t = like.tensor
    draw = torch.rand(t.shape, device=t.device,
                      generator=_random.generator(t.device))
    return nd.NDArray((draw < rate).to(t.dtype))


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if self._zoneout_outputs > 0:
            mask = _zoneout_mask(next_output, self._zoneout_outputs)
            prev = self._prev_output
            if prev is None:
                prev = nd.zeros(next_output.shape, ctx=next_output.context,
                                dtype=next_output.dtype)
            next_output = nd.where(mask, prev, next_output)
        if self._zoneout_states > 0:
            next_states = [nd.where(_zoneout_mask(new_s, self._zoneout_states),
                                    old_s, new_s)
                           for new_s, old_s in zip(next_states, states)]
        self._prev_output = next_output
        self._counter += 1
        return next_output, next_states

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class ResidualCell(ModifierCell):
    def __init__(self, base_cell):
        super().__init__(base_cell)

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, batch_size, **kwargs)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        seq, batch_size = _time_steps(inputs, length, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=seq[0].context)
        l_cell, r_cell = self._children
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, seq, begin_state[:n_l], layout="NTC",
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, list(reversed(seq)), begin_state[n_l:], layout="NTC",
            merge_outputs=False)
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError
