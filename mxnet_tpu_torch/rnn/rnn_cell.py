"""The legacy symbol-level RNN cells: ``mx.rnn``'s cells.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (ref: python/mxnet/rnn/
rnn_cell.py).  Cells unroll into symbol graphs for ``BucketingModule``
training.  ``FusedRNNCell`` emits the fused ``RNN`` op (cuDNN's recurrent
kernels on the card, ``ops/rnn_op.py``) and packs/unpacks between the op's
flat parameter vector and per-layer, per-gate weights, in the op's order
(used by ``initializer.FusedRNN`` and checkpoint conversion).  Pieces
come back as copies, so writing one never changes the flat vector.
"""
from __future__ import annotations

from .. import symbol as sym
from ..base import MXNetError
from ..initializer import FusedRNN as _FusedRNNInit, LSTMBias
from ..ndarray import concatenate

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "RNNParams"]


class RNNParams:
    """The variables of a cell, created once per name under its prefix."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    def begin_state(self, func=sym.zeros, **kwargs):
        assert not self._modified
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is None:
                state = func(name="%sbegin_state_%d" % (
                    self._prefix, self._init_counter), **kwargs)
            else:
                kw = dict(kwargs)
                kw.update(info)
                state = func(name="%sbegin_state_%d" % (
                    self._prefix, self._init_counter), **kw)
            states.append(state)
        return states

    def unpack_weights(self, args):
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args["%s%s_weight" % (self._prefix, group_name)] = \
                concatenate(weight)
            args["%s%s_bias" % (self._prefix, group_name)] = \
                concatenate(bias)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    assert inputs is not None
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, sym.Symbol):
        if merge is False:
            if len(inputs.list_outputs()) != 1:
                raise ValueError("unroll doesn't allow grouped symbol as "
                                 "input.")
            inputs = list(sym.SliceChannel(inputs, axis=in_axis,
                                           num_outputs=length,
                                           squeeze_axis=True))
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [sym.expand_dims(i, axis=axis) for i in inputs]
            inputs = sym.Concat(*inputs, dim=axis)
            in_axis = axis
    if isinstance(inputs, sym.Symbol) and axis != in_axis:
        inputs = sym.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB, num_hidden=self._num_hidden,
                                 name="%sh2h" % name)
        output = sym.Activation(i2h + h2h, act_type=self._activation,
                                name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = sym.SliceChannel(gates, num_outputs=4,
                                       name="%sslice" % name)
        in_gate = sym.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = sym.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = sym.Activation(slice_gates[2], act_type="tanh")
        out_gate = sym.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=prev_h, weight=self._hW, bias=self._hB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%sh2h" % name)
        i2h_r, i2h_z, i2h = sym.SliceChannel(i2h, num_outputs=3,
                                             name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h = sym.SliceChannel(h2h, num_outputs=3,
                                             name="%sh2h_slice" % name)
        reset_gate = sym.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = sym.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = sym.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """A multi-layer RNN as one fused ``RNN`` op, cuDNN's on the card."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter_prefix = ""
        self._parameter = self.params.get(
            "parameters",
            init=_FusedRNNInit(None, num_hidden, num_layers, mode,
                               bidirectional, forget_bias))

    @property
    def state_info(self):
        b = self._num_layers * len(self._directions)
        n = (self._mode == "lstm") + 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """{name: piece} of the flat parameter vector per layer, direction
        and gate, in ``ops.rnn_op._unpack_params`` order."""
        args = {}
        gate_names = self._gate_names
        directions = self._directions
        b = len(directions)
        p = 0
        for layer in range(self._num_layers):
            for direction in directions:
                for group_name in ["i2h", "h2h"]:
                    ni = li if layer == 0 else self._num_hidden * b
                    if group_name == "h2h":
                        ni = lh
                    size = lh * ni * self._num_gates
                    mat = arr[p:p + size].reshape(
                        (self._num_gates * lh, ni))
                    for gi, gate in enumerate(gate_names):
                        args["%s%s%d_%s%s_weight" % (
                            self._prefix, direction, layer, group_name,
                            gate)] = mat[gi * lh:(gi + 1) * lh]
                    p += size
        for layer in range(self._num_layers):
            for direction in directions:
                for group_name in ["i2h", "h2h"]:
                    vec = arr[p:p + lh * self._num_gates]
                    for gi, gate in enumerate(gate_names):
                        args["%s%s%d_%s%s_bias" % (
                            self._prefix, direction, layer, group_name,
                            gate)] = vec[gi * lh:(gi + 1) * lh]
                    p += lh * self._num_gates
        return args

    def unpack_weights(self, args):
        args = dict(args)
        arr = args.pop(self._parameter_prefix + self._prefix + "parameters",
                       None)
        if arr is None:
            arr = args.pop(self._parameter_prefix + "parameters")
        h = self._num_hidden
        # the input size, solved from the total parameter count
        total = arr.shape[0]
        b = len(self._directions)
        g = self._num_gates
        # solve: total = b*g*h*(li + h) + (L-1)*b*g*h*(h*b + h) + L*b*2*g*h
        rest = (self._num_layers - 1) * b * g * h * (h * b + h) \
            + self._num_layers * b * 2 * g * h
        li = (total - rest) // (b * g * h) - h
        sliced = self._slice_weights(arr, li, h)
        args.update({k: v.copy() for k, v in sliced.items()})
        return args

    def pack_weights(self, args):
        """The flat vector, the per-gate pieces concatenated in
        ``ops.rnn_op._unpack_params`` order."""
        args = dict(args)
        h = self._num_hidden
        pieces = []
        for layer in range(self._num_layers):
            for direction in self._directions:
                for group_name in ["i2h", "h2h"]:
                    for gate in self._gate_names:
                        name = "%s%s%d_%s%s_weight" % (
                            self._prefix, direction, layer, group_name, gate)
                        pieces.append(args.pop(name).reshape((-1,)))
        for layer in range(self._num_layers):
            for direction in self._directions:
                for group_name in ["i2h", "h2h"]:
                    for gate in self._gate_names:
                        name = "%s%s%d_%s%s_bias" % (
                            self._prefix, direction, layer, group_name, gate)
                        pieces.append(args.pop(name).reshape((-1,)))
        args["%sparameters" % self._prefix] = concatenate(pieces)
        return args

    def __call__(self, inputs, states):
        raise MXNetError(
            "FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:
            inputs = sym.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        rnn_args = {}
        if self._mode == "lstm":
            rnn_args["state_cell"] = states[1]
        rnn = sym.RNN(data=inputs, parameters=self._parameter,
                      state=states[0],
                      state_size=self._num_hidden,
                      num_layers=self._num_layers,
                      bidirectional=self._bidirectional,
                      p=self._dropout,
                      state_outputs=self._get_next_state,
                      mode=self._mode, name=self._prefix + "rnn",
                      **rnn_args)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = sym.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, states

    def unfuse(self):
        """Return an unfused SequentialRNNCell with the same structure."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (
                                          self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = sym.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=sym.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(init_sym, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath " \
            "instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: sym.Dropout(  # noqa: E731
            sym.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else sym.zeros_like(next_output)
        output = (sym.where(mask(p_outputs, next_output), next_output,
                            prev_output)
                  if p_outputs != 0.0 else next_output)
        states = ([sym.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0.0 else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    def __init__(self, base_cell):
        super().__init__(base_cell)

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        if merge_outputs:
            inputs, _ = _normalize_sequence(length, inputs, layout, True)
            outputs = outputs + inputs
        else:
            inputs, _ = _normalize_sequence(length, inputs, layout, False)
            outputs = [out + inp for out, inp in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def __call__(self, inputs, states):
        raise MXNetError(
            "Bidirectional cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info)],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):],
            layout=layout, merge_outputs=False)
        outputs = [sym.Concat(l_o, r_o, dim=1,
                              name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs = [sym.expand_dims(o, axis=axis) for o in outputs]
            outputs = sym.Concat(*outputs, dim=axis)
        states = l_states + r_states
        return outputs, states


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args
