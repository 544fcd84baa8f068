"""PipelineModule: pipeline parallelism through the Module API.

Counterpart of ``mxnet_tpu/module/pipeline_module.py``, with its symbol
contracts and errors.  The user says what repeats; the model is

    stem  ->  n_stages x body  ->  head

The body is one Symbol whose parameters are instantiated per stage and
stacked on a leading dim sharded over the mesh's ``pp`` axis.  Training
runs the GPipe microbatch schedule (``parallel.pipeline_stages``) with
dp on the batch dim of the same mesh.

Symbol contracts:
  stem: maps the data variable to the pipeline input  (optional)
  body: input variable named "x", single output, SAME shape as input
  head: input variable named "x" (+ the label variable), must end in
        SoftmaxOutput — training minimizes its NLL, whose logit
        gradient (p - onehot) is exactly SoftmaxOutput's backward
Auxiliary states (BatchNorm moving stats) are not supported inside
pipeline stages in this module; use ShardedModule or express the norm
statelessly (LayerNorm).

A step assembles the global parameters on the mesh's first position,
runs the stem and the head there over the global batch and the body
through ``pipeline_stages`` (which splits the stacked stage parameters
and the microbatches over the positions and runs each position's
stages there), differentiates it all with torch autograd and updates
each position's shard of every parameter and momentum.
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError
from ..context import cpu
from ..initializer import Uniform, InitDesc
from ..io import DataDesc
from ..ndarray import NDArray
from ..parallel import collectives
from ..parallel.mesh import NamedSharding, P, _as_tensor, shard, split
from .base_module import BaseModule
from .module import _descs


def _host(value):
    return _as_tensor(value).detach().to("cpu")


class PipelineModule(BaseModule):
    """Train stem -> n_stages x body -> head with pp x dp parallelism."""

    def __init__(self, body, n_stages, head, stem=None, mesh=None,
                 n_micro=None, data_names=("data",),
                 label_names=("softmax_label",), logger=logging):
        super().__init__(logger=logger)
        from .sharded import _as_mesh
        self.mesh = _as_mesh(mesh)
        self._body = body
        self._head = head
        self._stem = stem
        self._n_stages = int(n_stages)
        self._data_names = list(data_names)
        self._label_names = list(label_names)
        self._n_micro = n_micro
        pp = self.mesh.shape.get("pp", 1)
        if self._n_stages % max(pp, 1):
            raise MXNetError("n_stages=%d must divide over pp=%d"
                             % (self._n_stages, pp))
        for name, sym in (("body", body), ("head", head), ("stem", stem)):
            if sym is not None and sym.list_auxiliary_states():
                raise MXNetError(
                    "%s symbol has auxiliary states (%s); PipelineModule "
                    "stages are stateless — see module docstring"
                    % (name, sym.list_auxiliary_states()))
        self._n_micro_arg = n_micro  # user request; resolved per bind
        self.collectives = None
        self._reset_bind()

    def _reset_bind(self):
        """Pristine unbound state: everything built for one bind's
        shapes (also run by bind(force_rebind=True): the step bakes in
        rescale_grad=1/batch and the microbatch split)."""
        self._step = None
        self._fwd = None
        self._loss = None
        self._mom = None
        self._n_micro = self._n_micro_arg
        self.optimizer_initialized = False
        self.params_initialized = False

    # -- introspection -------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._head.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._output_shapes

    # -- binding -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad or shared_module is not None:
            raise MXNetError("PipelineModule does not support "
                             "inputs_need_grad or shared_module")
        preserved = None
        if self.binded:
            # carry trained params across the rebind (shapes are
            # batch-independent), drop every built step
            if self.params_initialized:
                preserved = self.get_params()[0]
            self._reset_bind()
        from ..executor import _Program

        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)
        self.for_training = for_training
        batch = int(self._data_shapes[0].shape[0])
        self._full_batch = batch
        dp = self.mesh.shape.get("dp", 1)
        if batch % dp:
            raise MXNetError("batch %d does not divide over dp=%d"
                             % (batch, dp))
        if self._n_micro is None:
            # >=2 microbatches per dp replica keeps the bubble bounded
            # (pipeline.py's layout heuristic); must divide the batch,
            # so take the largest batch divisor <= 2*dp
            want = min(batch, 2 * dp)
            self._n_micro = next(m for m in range(want, 0, -1)
                                 if batch % m == 0)
        if batch % self._n_micro:
            raise MXNetError("batch %d not divisible by n_micro %d"
                             % (batch, self._n_micro))

        known = {d.name: tuple(d.shape) for d in self._data_shapes}

        # stem: data -> x
        if self._stem is not None:
            self._stem_prog = _Program(self._stem, known)
            _, stem_outs, _ = self._stem.infer_shape(**known)
            x_shape = tuple(stem_outs[0])
        else:
            self._stem_prog = None
            x_shape = tuple(self._data_shapes[0].shape)
        self._x_shape = x_shape

        # body: x -> x, shape-preserving; its program runs on one
        # position's microbatch (pipeline_stages' layout), so dims an attr
        # leaves to the bound shapes are filled at that many rows
        pp = self.mesh.shape.get("pp", 1)
        rows = batch // self._n_micro
        if not (self._n_micro % dp == 0
                and (pp == 1 or self._n_micro // dp >= 2)):
            rows //= dp
        self._body_prog = _Program(self._body,
                                   {"x": (max(rows, 1),) + x_shape[1:]})
        body_args, body_outs, _ = self._body.infer_shape(x=x_shape)
        if tuple(body_outs[0]) != x_shape:
            raise MXNetError(
                "body must preserve shape: x %s -> %s"
                % (x_shape, tuple(body_outs[0])))
        self._body_param_shapes = {
            n: tuple(s) for n, s in zip(self._body.list_arguments(),
                                        body_args) if n != "x"}

        # head: x (+label) -> outputs
        hk = dict({"x": x_shape},
                  **{l.name: tuple(l.shape) for l in self._label_shapes})
        head_known = {k: v for k, v in hk.items()
                      if k in self._head.list_arguments()}
        head_args = self._head.list_arguments()
        if not self._label_shapes and self._label_names \
                and self._label_names[0] in head_args:
            # label-less bind (predict-style) but the head graph still
            # takes the label input (SoftmaxOutput always does): infer
            # its shape from x and synthesize zero labels at feed time
            # — SoftmaxOutput's forward ignores label values
            p_args, _, _ = self._head.infer_shape_partial(**head_known)
            shp = dict(zip(head_args, p_args)).get(self._label_names[0])
            if not shp or any(int(d) == 0 for d in shp):
                raise MXNetError(
                    "cannot infer the %r shape from the head graph for a "
                    "label-less bind; pass label_shapes"
                    % self._label_names[0])
            self._label_shapes = [DataDesc(self._label_names[0],
                                           tuple(int(d) for d in shp))]
        self._head_prog = _Program(self._head, head_known)
        _, head_outs, _ = self._head.infer_shape(**head_known)
        self._output_shapes = list(zip(self._head.list_outputs(),
                                       [tuple(s) for s in head_outs]))
        for tag, sym in (("stem", self._stem), ("body", self._body),
                         ("head", self._head)):
            if sym is not None and _draws(sym):
                raise MXNetError(
                    "%s graph contains rng ops (Dropout etc.); "
                    "PipelineModule's fused step does not thread PRNG "
                    "keys through the pipeline schedule yet" % tag)
        self.binded = True
        if preserved is not None:
            self.init_params(initializer=None, arg_params=preserved,
                             force_init=True)

    # -- parameters ----------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        from ..ndarray import zeros as nd_zeros
        from ..parallel.mesh import shard_params_rule

        attrs = {}
        for sym in (self._stem, self._body, self._head):
            if sym is not None:
                attrs.update(sym.attr_dict())

        def host_init(name, shape, attr_name=None):
            if arg_params and name in arg_params:
                return _host(arg_params[name]).float()
            if arg_params is not None and not allow_missing:
                raise MXNetError(
                    "%s is not presented (pass allow_missing=True to "
                    "initializer-fill parameters absent from arg_params)"
                    % name)
            fill = initializer or Uniform(0.01)
            h = nd_zeros(shape, cpu(), dtype="float32")
            fill(InitDesc(name, attrs.get(attr_name or name)), h)
            return h.tensor.clone()

        params, sharding = {}, {}
        inputs = set(self._data_names) | set(self._label_names) | {"x"}

        # stage params: n_stages independent inits stacked on dim 0,
        # sharded over pp (each stage group's positions hold their
        # slice); attrs are keyed by the body's own argument names
        for n, shp in self._body_param_shapes.items():
            stack = torch.stack(
                [host_init("stage%d_%s" % (s, n), shp, attr_name=n)
                 for s in range(self._n_stages)])
            key = "body:" + n
            sharding[key] = NamedSharding(
                self.mesh, P(*(("pp",) + (None,) * len(shp))))
            params[key] = shard(stack, sharding[key])

        for tag, sym in (("stem", self._stem), ("head", self._head)):
            if sym is None:
                continue
            known = {d.name: tuple(d.shape) for d in self._data_shapes} \
                if tag == "stem" else {"x": self._x_shape}
            if tag == "head":
                known.update((l.name, tuple(l.shape))
                             for l in self._label_shapes
                             if l.name in sym.list_arguments())
            arg_shapes, _, _ = sym.infer_shape(**known)
            for n, shp in zip(sym.list_arguments(), arg_shapes):
                if n in inputs:
                    continue
                key = tag + ":" + n
                sharding[key] = shard_params_rule(self.mesh, n, tuple(shp))
                params[key] = shard(host_init(n, tuple(shp)), sharding[key])

        self._params = params
        self._param_sharding = sharding
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        args = {}
        for key, v in self._params.items():
            tag, n = key.split(":", 1)
            host = v.global_tensor(torch.device("cpu")).detach()
            if tag == "body":
                for s in range(self._n_stages):
                    args["stage%d_%s" % (s, n)] = NDArray(host[s].clone())
            else:
                args[n] = NDArray(host.clone())
        return args, {}

    # -- the pipelined step --------------------------------------------------
    # The head ends in SoftmaxOutput, whose backward ignores the upstream
    # cotangent and gives (p - onehot) per sample: SoftmaxOutput IS the
    # loss.  So the step takes gradients with head gradients of ones and
    # scales them by rescale_grad (1/batch), as ShardedModule does, and
    # not through an extra NLL, which would count the loss scale twice.
    def _build_loss_fn(self, is_train=True):
        from ..parallel.pipeline import pipeline_stages

        stem_prog, body_prog, head_prog = (self._stem_prog,
                                           self._body_prog, self._head_prog)
        head_sym = self._head
        data_name = self._data_names[0]
        label_name = self._label_names[0] if self._label_names else None
        n_micro, mesh = self._n_micro, self.mesh
        body_param_names = list(self._body_param_shapes)
        pp = mesh.shape.get("pp", 1)
        stages_per_position = self._n_stages // max(pp, 1)

        def body_fn(stage_params, xm):
            # stage_params: this position's [stages_per_position, ...]
            # slices; apply its stages in order (virtual stages)
            x = xm
            for s in range(stages_per_position):
                m = {"x": x}
                m.update((n, stage_params[n][s]) for n in body_param_names)
                outs, _ = body_prog.evaluate(m, train=is_train,
                                             device=x.device)
                x = outs[0]
            return x

        def loss_fn(params, batch):
            data = batch[data_name]
            if stem_prog is not None:
                m = {data_name: data}
                m.update((k.split(":", 1)[1], v) for k, v in params.items()
                         if k.startswith("stem:"))
                outs, _ = stem_prog.evaluate(m, train=is_train,
                                             device=data.device)
                x = outs[0]
            else:
                x = data
            # stacked [n_stages, ...] -> [pp, per_position, ...] so that
            # the pp split hands each position its stage group
            grouped = {
                n: params["body:" + n].reshape(
                    (pp, stages_per_position)
                    + tuple(params["body:" + n].shape[1:]))
                for n in body_param_names}
            x = pipeline_stages(
                grouped, x, body_fn, n_micro=n_micro, mesh=mesh,
                params_spec={n: P("pp") for n in body_param_names},
                batch_axis="dp")
            hm = {"x": x}
            if label_name is not None and \
                    label_name in head_sym.list_arguments():
                hm[label_name] = batch[label_name]
            hm.update((k.split(":", 1)[1], v) for k, v in params.items()
                      if k.startswith("head:"))
            outs, _ = head_prog.evaluate(hm, train=is_train, device=x.device)
            return outs

        def nll_of(outs, batch):
            probs = outs[0].detach()
            labels = batch[label_name].to(torch.int64)
            logp = torch.log(torch.clamp(probs, 1e-30, 1.0))
            return torch.mean(-torch.gather(logp, -1, labels[..., None]))

        return loss_fn, nll_of

    def init_optimizer(self, kvstore=None, optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        opts = dict(optimizer_params)
        if not isinstance(optimizer, str) or optimizer not in ("sgd",):
            raise MXNetError("PipelineModule compiles an sgd(+momentum) "
                             "step; got %r" % (optimizer,))
        self._lr = float(opts.get("learning_rate", 0.01))
        self._momentum = float(opts.get("momentum", 0.0))
        self._wd = float(opts.get("wd", 0.0))
        self._rescale = float(opts.get("rescale_grad",
                                       1.0 / self._full_batch))
        self._train_fn, self._nll_of = self._build_loss_fn(is_train=True)
        self._mom = {
            k: shard(torch.zeros(v.shape, dtype=v.dtype),
                     self._param_sharding[k])
            for k, v in self._params.items()}
        self._step = self._train_step
        self.optimizer_initialized = True

    def _global_params(self, requires_grad):
        dev = self.mesh.torch_devices[0]
        return {k: v.global_tensor(dev).detach().requires_grad_(
                    requires_grad)
                for k, v in self._params.items()}

    def _train_step(self, batch):
        """``g = grad*rescale + wd*p; m = momentum*m + g; p -= lr*m`` on
        every position's shard, the momentum sharded like its
        parameter."""
        params = self._global_params(True)
        with torch.enable_grad():
            outs = self._train_fn(params, batch)
        ys = [o for o in outs if o.requires_grad]
        keys = list(params)
        grads = torch.autograd.grad(
            ys, [params[k] for k in keys], [torch.ones_like(y) for y in ys],
            allow_unused=True) if ys else [None] * len(keys)
        lr, momentum, wd, rescale = (self._lr, self._momentum, self._wd,
                                     self._rescale)
        with torch.no_grad():
            for k, grad in zip(keys, grads):
                if grad is None:
                    grad = torch.zeros_like(params[k])
                blocks = split(grad, self._param_sharding[k])
                param, mom = self._params[k], self._mom[k]
                for p, gb in enumerate(blocks):
                    w, v = param.shards[p], mom.shards[p]
                    g = gb.to(w.device) * rescale + wd * w
                    m = momentum * v + g
                    w.copy_(w - lr * m)
                    v.copy_(m)
            self._loss = self._nll_of(outs, batch)
        return outs

    def _build_eval(self):
        """The eval-mode step; optimizer-independent, built lazily so
        bind -> init_params -> score works without an optimizer."""
        eval_fn, _ = self._build_loss_fn(is_train=False)

        def run(batch):
            with torch.no_grad():
                return eval_fn(self._global_params(False), batch)
        self._fwd = run

    # -- compute -------------------------------------------------------------
    def _batch_dict(self, data_batch):
        # every input on the first position, where the step assembles the
        # global batch.  Label-less batches (predict/score without labels)
        # get zero labels of the bound shape — SoftmaxOutput's forward
        # ignores label values
        dev = self.mesh.torch_devices[0]
        out = {}
        for n, v in zip(self._data_names, data_batch.data):
            out[n] = _host(v).to(dev)
        labels = data_batch.label or []
        for i, l in enumerate(self._label_shapes):
            if i < len(labels) and labels[i] is not None:
                out[l.name] = _host(labels[i]).to(dev)
            else:
                out[l.name] = torch.zeros(l.shape, dtype=torch.float32,
                                          device=dev)
        return out

    def forward_backward(self, data_batch):
        assert self.optimizer_initialized, "call init_optimizer first"
        batch = self._batch_dict(data_batch)
        with collectives.watch() as record:
            outs = self._step(batch)
        self.collectives = record.counts
        self._outputs = [NDArray(o.detach()) for o in outs]

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if self._fwd is None:
            self._build_eval()
        outs = self._fwd(self._batch_dict(data_batch))
        self._outputs = [NDArray(o) for o in outs]

    def backward(self, out_grads=None):
        raise MXNetError("PipelineModule fuses backward into "
                         "forward_backward")

    def update(self):
        pass  # the fused step already applied the optimizer

    def get_outputs(self, merge_multi_context=True):
        return list(self._outputs)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self._outputs)

    @property
    def loss(self):
        """Mean NLL of the last forward_backward step."""
        return None if self._loss is None else float(self._loss)


def _draws(symbol):
    """Whether any op of ``symbol`` draws random numbers."""
    from ..ops.registry import get_op
    return any(not n.is_var and get_op(n.op_name).needs_rng
               for n in symbol._topo())
