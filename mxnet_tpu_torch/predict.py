"""Deployment/inference API (parity: c_predict_api — MXPredCreate,
SetInput, Forward, GetOutput).

Counterpart of ``mxnet_tpu/predict.py``: a symbol JSON plus parameters,
bound forward-only on one device (by default the current context,
``gpu(0)``); ``quantize="int8"`` rewrites the graph onto the int8 ops of
``ops/quantize.py`` before binding."""
from __future__ import annotations

import numpy as np

from .base import MXNetError
from .context import Context, current_context
from .ndarray import NDArray, array as nd_array, load as nd_load, loads
from .symbol import load_json as sym_load_json


class Predictor:
    """MXPredCreate equivalent: (symbol_json, params) -> forward machine.

    ``params`` is a {"arg:name"/"aux:name" or bare name: NDArray} dict,
    the raw bytes of a ``.params`` file, or its path.  The device is
    ``ctx``, else ``dev_type`` ("cpu" or "gpu") and ``dev_id``, else the
    current context.  ``quantize="int8"``
    serves the int8 rewrite of the graph (per-channel weight scales;
    ``calibration`` pins activation ranges, else they are dynamic)."""

    def __init__(self, symbol_json, param_bytes_or_file, input_shapes,
                 dev_type=None, dev_id=0, ctx=None, quantize=None,
                 calibration=None):
        if isinstance(symbol_json, str) \
                and symbol_json.lstrip().startswith("{"):
            self._symbol = sym_load_json(symbol_json)
        else:
            with open(symbol_json) as f:
                self._symbol = sym_load_json(f.read())
        if isinstance(param_bytes_or_file, dict):
            params = param_bytes_or_file
        elif isinstance(param_bytes_or_file, (bytes, bytearray)):
            params = loads(bytes(param_bytes_or_file))
        else:
            params = nd_load(param_bytes_or_file)
        arg_params = {k[4:]: v for k, v in params.items()
                      if k.startswith("arg:")}
        aux_params = {k[4:]: v for k, v in params.items()
                      if k.startswith("aux:")}
        if not arg_params and not aux_params:
            arg_params = params
        if quantize:
            from .ops import quantize as _quant
            self._symbol, arg_params, aux_params = _quant.quantize_symbol(
                self._symbol, arg_params, aux_params, mode=quantize,
                calibration=calibration)
        self._quantize = quantize
        if ctx is None and dev_type is not None:  # MXPredCreate's
            ctx = Context(dev_type, dev_id)
        self._ctx = ctx = ctx or current_context()
        shape_kwargs = dict(input_shapes) if isinstance(input_shapes, dict) \
            else {"data": tuple(input_shapes)}
        self._exe = self._symbol.simple_bind(ctx, grad_req="null",
                                             **shape_kwargs)
        self._exe.copy_params_from(arg_params, aux_params,
                                   allow_extra_params=True)
        self._input_names = set(shape_kwargs)
        # which args are real weights (from the param blob) vs data-like
        # extras — reshaped() treats them differently
        self._param_names = set(arg_params) | set(aux_params)
        self._out_shapes = self._infer_out_shapes()

    def _infer_out_shapes(self):
        """Output shapes from the bound argument shapes, valid before the
        first forward (C consumers size their buffers with them)."""
        bound = {n: a.shape for n, a in self._exe.arg_dict.items()}
        _, out_shapes, _ = self._symbol.infer_shape(**bound)
        return [tuple(s) for s in out_shapes]

    def set_input(self, name, data):
        """MXPredSetInput."""
        if name not in self._exe.arg_dict:
            raise MXNetError("unknown input %r" % name)
        if not isinstance(data, NDArray):
            data = nd_array(np.asarray(data), ctx=self._ctx)
        data.copyto(self._exe.arg_dict[name])

    def forward(self, **inputs):
        """MXPredForward; inputs may be passed as kwargs."""
        for k, v in inputs.items():
            self.set_input(k, v)
        self._exe.forward(is_train=False)

    def get_output(self, index=0):
        """MXPredGetOutput."""
        return self._exe.outputs[index]

    @property
    def output_names(self):
        """Positional output names — the order ``get_output`` indexes."""
        return list(self._symbol.list_outputs())

    @property
    def num_outputs(self):
        return len(self._symbol.list_outputs())

    def reshape(self, input_shapes):
        """MXPredReshape in place: re-bind this predictor to new input
        shapes (the executor's ``reshape``, sharing every array whose
        shape is unchanged).  As in the C predict contract, any new input
        size is allowed and dependent arrays (labels, states) reshape
        implicitly."""
        self._exe = self._exe.reshape(partial_shaping=True,
                                      allow_up_sizing=True, **input_shapes)
        self._out_shapes = self._infer_out_shapes()
        return self

    def get_output_shape(self, index=0):
        """MXPredGetOutputShape — valid immediately after create."""
        if self._exe.outputs:
            return self._exe.outputs[index].shape
        return self._out_shapes[index]

    def reshaped(self, input_shapes):
        """A NEW predictor bound to ``input_shapes`` that shares this
        one's weights (the same device arrays, not copies); this one keeps
        working with its old shapes (the MXPredReshape contract).  Only
        data-like arguments may change shape."""
        new = object.__new__(Predictor)
        new._symbol = self._symbol  # already quantized when this one is
        new._quantize = self._quantize
        new._ctx = self._ctx
        shape_kwargs = dict(input_shapes)
        weights = {k: v for k, v in self._exe.arg_dict.items()
                   if k not in self._input_names}
        weights.update(self._exe.aux_dict)
        new._exe = new._symbol.simple_bind(new._ctx, grad_req="null",
                                           shared_args=weights,
                                           **shape_kwargs)
        for table in (new._exe.arg_dict, new._exe.aux_dict):
            for k, v in table.items():
                if k in self._param_names and v is not weights.get(k):
                    raise MXNetError(
                        "MXPredReshape: weight %r changes shape %s -> %s "
                        "under the new input shapes; only batch-size "
                        "changes are reshapable"
                        % (k, weights[k].shape, v.shape))
        new._input_names = set(shape_kwargs)
        new._param_names = set(self._param_names)
        new._out_shapes = new._infer_out_shapes()
        return new


def load_checkpoint_predictor(prefix, epoch, input_shapes, ctx=None):
    """A Predictor over the artifacts of ``save_checkpoint``."""
    from .model import load_checkpoint
    sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
    params = {"arg:%s" % k: v for k, v in arg_params.items()}
    params.update({"aux:%s" % k: v for k, v in aux_params.items()})
    return Predictor(sym.tojson(), params, input_shapes, ctx=ctx)
