"""Batch-reducing ops across data-parallel groups: the lockstep evaluator.

New in the port; the JAX package has no counterpart.  There,
``ShardedModule`` runs the graph once over the whole batch inside one
jitted step (``mxnet_tpu/module/sharded.py:378-390``) and GSPMD splits
it over the mesh.  So BatchNorm's training statistics and
``SoftmaxOutput``'s ``'batch'``/``'valid'`` normalisation see every row
for free.  The port runs each dp group on its own rows, on the group's
first position.  An op that reduces over the batch must therefore reduce
across the groups, or the groups train different math.

:class:`GroupProgram` runs one ``executor._Program`` over a list of
per-group value maps and advances every group one op at a time.  A
synced BatchNorm needs every group's partial sums at the same node, so
running group 0's whole graph before group 1's cannot work.  Each op
runs in one of three ways:

- **shared**: no input carries batch rows (parameters, constants).  It
  runs per group on the group's own copies.
- **rows**: an op of :data:`ROW_WISE`, which acts on each row of the
  leading dim alone.  It runs per group with its ``impl``.
- **cross**: an op of :data:`CROSS`.  Its cross-group form runs once
  over every group's inputs.  BatchNorm in training takes
  ``bn_channel_sums`` of each group's rows and psums the partial
  ``(sum x, sum x^2)`` forward and ``(sum dy, sum dy*x)`` backward over
  the groups.  ``SoftmaxOutput`` divides by the global row count
  (``'batch'``) or by the psum of the groups' valid counts
  (``'valid'``).

Every group's tensors sit in one torch autograd graph.  A caller takes
all gradients with one ``torch.autograd.grad`` over every group's
outputs.  A graph with an op that is in neither table cannot be split:
:attr:`GroupProgram.reason` names the first such op, and the caller runs
the graph over the global batch instead.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import kernels as _kernels
from ..ops import nn as _nn
from ..ops.registry import eval_shape_op, get_op
from ..parallel import collectives

# -- which ops act on each row alone ----------------------------------------


def _axes(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(int(a) % ndim for a in axis)


def _off0(key="axis", new_axis=False):
    """The op works along ``attrs[key]``, which must be set and miss dim
    0 (``new_axis``: an axis of the output, one rank up)."""
    def check(attrs, shapes, batched):
        ax = _axes(attrs.get(key), len(shapes[0]) + bool(new_axis))
        return bool(ax) and 0 not in ax
    return check


def _reduce_off0(attrs, shapes, batched):
    ax = _axes(attrs.get("axis"), len(shapes[0]))
    if not ax:  # None or (): every axis
        return False
    return (0 in ax) if attrs.get("exclude") else (0 not in ax)


def _data_only(attrs, shapes, batched):
    """Only the first input carries rows; the rest are weights."""
    return batched[0] and not any(batched[1:])


def _always(attrs, shapes, batched):
    return True


def _transpose(attrs, shapes, batched):
    axes = attrs.get("axes")
    return bool(axes) and int(axes[0]) % len(shapes[0]) == 0


def _swapaxis(attrs, shapes, batched):
    nd = len(shapes[0])
    return int(attrs["dim1"]) % nd != 0 and int(attrs["dim2"]) % nd != 0


def _tile(attrs, shapes, batched):
    reps = tuple(attrs.get("reps") or ())
    nd = len(shapes[0])
    return len(reps) < nd or (len(reps) == nd and int(reps[0]) == 1)


def _pad(attrs, shapes, batched):
    pw = tuple(attrs.get("pad_width") or ())
    return len(pw) < 2 or (int(pw[0]) == 0 and int(pw[1]) == 0)


def _slice(attrs, shapes, batched):
    begin = tuple(attrs.get("begin") or ())
    step = tuple(attrs.get("step") or ())
    return (not begin or begin[0] in (None, 0)) \
        and (not step or step[0] in (None, 1))


def _dot(attrs, shapes, batched):
    return batched[0] and not batched[1] and not attrs.get("transpose_a")


def _take(attrs, shapes, batched):
    axis = int(attrs.get("axis", 0)) % len(shapes[0])
    if batched[0]:
        return not batched[1] and axis != 0
    return axis == 0


def _mha(attrs, shapes, batched):
    return not any(batched[3:11])


_UNARY = (
    "abs arccos arccosh arcsin arcsinh arctan arctanh cbrt ceil cos cosh "
    "degrees erf exp expm1 fix floor gamma gammaln log log10 log1p log2 "
    "logical_not negative radians rcbrt reciprocal relu rint round rsqrt "
    "sigmoid sign sin sinh softsign sqrt square tan tanh trunc "
    "Activation BlockGrad Cast _copy clip Dropout Flatten ones_like "
    "zeros_like argmax_channel SoftmaxActivation L2Normalization LRN "
    "Pooling one_hot").split()
_ELEMENTWISE = (
    "elemwise_add elemwise_sub elemwise_mul elemwise_div elemwise_power "
    "elemwise_maximum elemwise_minimum elemwise_mod elemwise_hypot "
    "_grad_add _equal _not_equal _greater _greater_equal _lesser "
    "_lesser_equal add_n where UpSampling reshape_like batch_dot "
    "broadcast_to broadcast_add broadcast_sub broadcast_mul broadcast_div "
    "broadcast_power broadcast_maximum broadcast_minimum broadcast_mod "
    "broadcast_hypot broadcast_equal broadcast_not_equal broadcast_greater "
    "broadcast_greater_equal broadcast_lesser broadcast_lesser_equal "
    "Reshape scaled_dot_product_attention").split()
_SCALAR = (
    "_plus_scalar _minus_scalar _rminus_scalar _mul_scalar _div_scalar "
    "_rdiv_scalar _power_scalar _rpower_scalar _maximum_scalar "
    "_minimum_scalar _mod_scalar _rmod_scalar _hypot_scalar _equal_scalar "
    "_not_equal_scalar _greater_scalar _greater_equal_scalar _lesser_scalar "
    "_lesser_equal_scalar").split()

# op name -> predicate(attrs, global input shapes, which inputs carry
# rows): whether the op, so configured, acts on each row of the leading
# dim alone.  Every op here also passes the shape check of
# ``GroupProgram`` (its output at a group's batch is that group's rows).
ROW_WISE = dict.fromkeys(_UNARY + _ELEMENTWISE + _SCALAR, _always)
ROW_WISE.update({
    # ops with weights: only the data input carries rows
    "FullyConnected": _data_only, "Convolution": _data_only,
    "Deconvolution": _data_only, "Embedding": _data_only,
    "InstanceNorm": _data_only, "_PReLU": _data_only,
    "LeakyReLU": _always, "multi_head_attention": _mha,
    "LayerNorm": lambda a, s, b: _data_only(a, s, b)
    and _off0()(a, s, b),
    # loss heads whose backward is per row (SoftmaxOutput is in CROSS)
    "LinearRegressionOutput": _always, "LogisticRegressionOutput": _always,
    "MAERegressionOutput": _always, "SVMOutput": _always,
    "MakeLoss": _always,
    # ops with an axis: the axis must miss dim 0
    "softmax": _off0(), "log_softmax": _off0(), "Concat": _off0("dim"),
    "SliceChannel": _off0(), "slice_axis": _off0(), "reverse": _off0(),
    "repeat": _off0(), "pick": _off0(), "topk": _off0(), "sort": _off0(),
    "argsort": _off0(), "argmax": _off0(), "argmin": _off0(),
    "broadcast_axis": _off0(), "squeeze": _off0(),
    "expand_dims": _off0(new_axis=True), "stack": _off0(new_axis=True),
    "sum": _reduce_off0, "mean": _reduce_off0, "max": _reduce_off0,
    "min": _reduce_off0, "prod": _reduce_off0, "nansum": _reduce_off0,
    "nanprod": _reduce_off0, "norm": _off0(),
    "transpose": _transpose, "SwapAxis": _swapaxis, "tile": _tile,
    "Pad": _pad, "slice": _slice, "dot": _dot, "take": _take,
})


# -- ops with a cross-group form --------------------------------------------

def _group_sum(blocks, mesh):
    """Each group gets the sum of every group's tensor (one all-reduce
    over ``mesh``, the groups' devices on dp, in group order)."""
    return collectives.psum(blocks, mesh, "dp")


class _SyncBNFn(torch.autograd.Function):
    """Training BatchNorm over NCHW across groups: ``_BNTrainFn``
    (``ops/nn.py``) with the groups' partial sums psum'd.  Inputs: the
    groups' mesh, eps, then every group's x, every group's gamma and
    every group's beta.  Outputs: every group's y, then the global mean
    and variance (on group 0's device)."""

    @staticmethod
    def forward(fctx, mesh, eps, *tensors):
        n = len(tensors) // 3
        xs, gs, bs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        c = xs[0].shape[1]
        count = sum(x.shape[0] * x.shape[2] * x.shape[3] for x in xs)
        sums = _group_sum([torch.cat(_kernels.bn_channel_sums(x))
                           for x in xs], mesh)
        means, variances, invs, outs = [], [], [], []
        for x, g, b, s in zip(xs, gs, bs, sums):
            mean = s[:c] / count
            var = torch.clamp_min(s[c:] / count - mean * mean, 0.0)
            inv = torch.rsqrt(var + eps)
            outs.append(_nn._bn_affine(x, g, b, mean, inv, (1, c, 1, 1)))
            means.append(mean)
            variances.append(var)
            invs.append(inv)
        fctx.save_for_backward(*xs, *gs, *means, *invs)
        fctx.n, fctx.count, fctx.mesh = n, count, mesh
        return tuple(outs) + (means[0], variances[0])

    @staticmethod
    def backward(fctx, *grads):
        n, count = fctx.n, fctx.count
        saved = fctx.saved_tensors
        xs, gs = saved[:n], saved[n:2 * n]
        means, invs = saved[2 * n:3 * n], saved[3 * n:]
        dys, dmean, dvar = grads[:n], grads[n], grads[n + 1]
        c = xs[0].shape[1]
        bshape = (1, c, 1, 1)
        local = [_kernels.bn_channel_sums(dy.to(x.dtype), x)
                 for dy, x in zip(dys, xs)]
        total = _group_sum([torch.cat(p) for p in local], fctx.mesh)
        dxs, dgs, dbs = [], [], []
        for x, g, mean, inv, dy, (sdy, sdyx), tot in zip(
                xs, gs, means, invs, dys, local, total):
            sum_dy, sum_dy_xc = tot[:c], tot[c:] - mean * tot[:c]
            xc = x.float() - mean.reshape(bshape)
            g32 = g.float()
            dx = (g32 * inv).reshape(bshape) * (
                dy.float() - (sum_dy / count).reshape(bshape)
                - xc * (inv * inv * sum_dy_xc / count).reshape(bshape))
            dm, dv = dmean.to(x.device), dvar.to(x.device)
            dx = dx + (dm / count).reshape(bshape) \
                + xc * (2.0 * dv / count).reshape(bshape)
            dxs.append(dx.to(x.dtype))
            # this group's rows' share of the parameter gradients; the
            # caller's gradient psum adds the groups' shares
            dgs.append(((sdyx - mean * sdy) * inv).to(g.dtype))
            dbs.append(sdy.to(g.dtype))
        return (None, None) + tuple(dxs) + tuple(dgs) + tuple(dbs)


def _bn_plain_across(xs, gs, bs, ax, eps, mesh):
    """Training BatchNorm outside the kernel's NCHW domain across groups:
    ``_bn_train_plain``'s f32 sums per group, psum'd, differentiated by
    autograd."""
    red = tuple(i for i in range(xs[0].ndim) if i != ax)
    bshape = tuple(-1 if i == ax else 1 for i in range(xs[0].ndim))
    c = xs[0].shape[ax]
    count = sum(x.numel() // c for x in xs)
    parts = []
    for x in xs:
        x32 = x.float()
        parts.append(torch.cat([x32.sum(dim=red), (x32 * x32).sum(dim=red)]))
    sums = _group_sum(parts, mesh)
    outs, stats = [], None
    for x, g, b, s in zip(xs, gs, bs, sums):
        mean = s[:c] / count
        var = torch.clamp_min(s[c:] / count - mean * mean, 0.0)
        outs.append(_nn._bn_affine(x, g, b, mean, torch.rsqrt(var + eps),
                                   bshape))
        stats = stats or (mean, var)
    return outs, stats[0], stats[1]


def _batch_norm_across(ins, attrs, train, mesh):
    if not train or attrs["use_global_stats"]:
        return [_nn._batch_norm(*i, **attrs, _train=train) for i in ins]
    xs = [i[0] for i in ins]
    gs = [torch.ones_like(i[1]) if attrs["fix_gamma"] else i[1] for i in ins]
    bs = [i[2] for i in ins]
    ax = int(attrs["axis"]) % xs[0].ndim
    eps = float(attrs["eps"])
    if xs[0].ndim == 4 and ax == 1 and xs[0].is_floating_point():
        res = _SyncBNFn.apply(mesh, eps, *xs, *gs, *bs)
        outs, mean, var = res[:len(xs)], res[-2], res[-1]
    else:
        outs, mean, var = _bn_plain_across(xs, gs, bs, ax, eps, mesh)
    mm, mv, momentum = ins[0][3], ins[0][4], attrs["momentum"]
    with torch.no_grad():  # every group's moving statistics are these
        new_mm = mm * momentum + mean.to(mm) * (1 - momentum)
        new_mv = mv * momentum + var.to(mv) * (1 - momentum)
    res = []
    for x, out in zip(xs, outs):
        extra = (mean.to(x.device, x.dtype), var.to(x.device, x.dtype)) \
            if attrs["output_mean_var"] else ()
        res.append((out,) + extra + (new_mm.to(x.device),
                                     new_mv.to(x.device)))
    return res


class _SoftmaxOutputAcrossFn(torch.autograd.Function):
    """``SoftmaxOutput`` on one group's rows whose backward divides by a
    denominator counted over every group."""

    @staticmethod
    def forward(fctx, data, label, cfg, denom):
        out = _nn._softmax_fwd(data, cfg[4], cfg[5])
        fctx.save_for_backward(out, label)
        fctx.cfg, fctx.denom = cfg, denom
        return out

    @staticmethod
    def backward(fctx, _head_grad):
        out, label = fctx.saved_tensors
        scale, ignore, use_ignore, _, multi = fctx.cfg[:5]
        grad = _nn._softmax_output_grad(out, label, 1.0, ignore, use_ignore,
                                        "null", multi)
        denom = fctx.denom
        if isinstance(denom, torch.Tensor):
            denom = denom.to(out.device)
        return (grad / denom * scale).to(out.dtype), None, None, None


def _softmax_output_across(ins, attrs, train, mesh):
    norm = attrs["normalization"]
    if norm not in ("batch", "valid") or not train:
        return [_nn._softmax_output(*i, **attrs) for i in ins]
    if norm == "batch":
        denom = [sum(i[0].shape[0] for i in ins)] * len(ins)
    else:
        counts = []
        for data, label in ins:
            valid = (label != attrs["ignore_label"]).to(data.dtype) \
                if attrs["use_ignore"] else torch.ones(
                    label.shape, dtype=data.dtype, device=data.device)
            counts.append(valid.sum())
        denom = [torch.clamp_min(t, 1.0) for t in _group_sum(counts, mesh)]
    cfg = (float(attrs["grad_scale"]), float(attrs["ignore_label"]),
           bool(attrs["use_ignore"]), str(norm), bool(attrs["multi_output"]),
           bool(attrs["preserve_shape"]))
    return [_SoftmaxOutputAcrossFn.apply(data, label, cfg, d)
            for (data, label), d in zip(ins, denom)]


def _bn_accepts(batched):
    return batched[0] and not any(batched[1:])


def _softmax_accepts(batched):
    return all(batched)


# op name -> (cross-group form(inputs per group, attrs, train, the groups'
# mesh) -> outputs per group, which inputs may carry rows)
CROSS = {
    "BatchNorm": (_batch_norm_across, _bn_accepts),
    "SoftmaxOutput": (_softmax_output_across, _softmax_accepts),
}


# -- the evaluator ----------------------------------------------------------

def _out_shapes(op, attrs, in_shapes, in_dtypes, n_out):
    if op.infer_shape is not None:
        if op.bidirectional_infer:
            _, outs = op.infer_shape(list(in_shapes), attrs, [None] * n_out)
        else:
            _, outs = op.infer_shape(list(in_shapes), attrs)
        if outs is not None and all(o is not None for o in outs[:n_out]):
            return [tuple(int(d) for d in o) for o in outs[:n_out]]
    outs, _ = eval_shape_op(op, in_shapes, in_dtypes, attrs)
    return outs[:n_out]


class GroupProgram:
    """``symbol`` over ``n_groups`` groups in lockstep.  ``shapes`` are
    the bound (global) shapes of the graph's inputs, ``batch_names`` the
    inputs whose dim 0 is the batch; each group gets an equal share of
    the rows, and ``group_mesh`` (one position a group, on dp) carries
    the cross-group sums.  ``prog`` is the graph's ``_Program`` at one group's
    shapes (an attr whose 0 dims the plan fills, such as ``Reshape``'s
    kept dims, is filled at the group's batch).

    ``reason`` is None when the graph splits, else the first op that
    prevents it (``"<op> (node <name>)"``)."""

    def __init__(self, symbol, shapes, batch_names, n_groups, group_mesh):
        from ..executor import _Program
        self.n = n = int(n_groups)
        self.mesh = group_mesh
        self.reason = None
        self.plan = None
        shapes = {k: tuple(v) for k, v in shapes.items()}
        batch_names = {n for n in batch_names if n in shapes}
        for name in batch_names:
            if shapes[name][0] % n:
                self.reason = "the batch (%d rows of %s) does not divide " \
                    "over %d groups" % (shapes[name][0], name, n)
                return
        self.prog = prog = _Program(symbol, {
            k: ((v[0] // n,) + v[1:] if k in batch_names else v)
            for k, v in shapes.items()})
        entries = self._entries(symbol)
        gshapes, dtypes = symbol._infer(shapes, {})
        batched = {s for name, s in prog.var_slots if name in batch_names}
        plan = []
        for k, (op, attrs, ins, first, n_out, _, _) in enumerate(prog.steps):
            node_name = prog.taps[k][0]
            in_b = [s in batched for s in ins]
            if not any(in_b):
                plan.append("shared")
                continue
            in_shapes = [gshapes[entries[s]] for s in ins]
            outs = [gshapes.get(entries[first + i]) for i in range(n_out)]
            if op.name in CROSS:
                ok = CROSS[op.name][1](in_b)
                plan.append(op.name)
                bout = range(1)
            else:
                check = ROW_WISE.get(op.name)
                ok = check is not None and check(attrs, in_shapes, in_b) \
                    and self._splits(op, attrs, in_shapes, in_b, outs,
                                     [dtypes.get(entries[s]) or "float32"
                                      for s in ins])
                plan.append("rows")
                bout = range(n_out)
            if not ok:
                self.reason = "%s (node %s)" % (op.name, node_name)
                return
            batched.update(first + i for i in bout)
        self.plan = plan
        self.batched_outputs = [s in batched for s in prog.out_slots]

    @staticmethod
    def _entries(symbol):
        """(node, output index) of every slot, in the order ``_Program``
        numbers them."""
        entries = []
        for node in symbol._topo():
            if node.is_var:
                entries.append((node, 0))
                continue
            op = get_op(node.op_name)
            attrs = op.normalize_attrs(node.attrs, len(node.inputs))
            entries += [(node, i) for i in range(op.str_outputs(attrs))]
        return entries

    def _splits(self, op, attrs, in_shapes, in_b, outs, in_dtypes):
        """Whether the op, given each group's rows, returns each group's
        rows of its global output: the output at the group batch is the
        global one with dim 0 cut n ways, and each input row maps to
        whole output rows."""
        n = self.n
        rows = next(s[0] for s, b in zip(in_shapes, in_b) if b)
        if any(b and s[0] % n for s, b in zip(in_shapes, in_b)):
            return False
        local = [(s[0] // n,) + tuple(s[1:]) if b else tuple(s)
                 for s, b in zip(in_shapes, in_b)]
        try:
            got = _out_shapes(op, attrs, local, in_dtypes, len(outs))
        except Exception:  # the op refuses a group's shapes
            return False
        for g, o in zip(outs, got):
            if g is None or len(g) != len(o) or tuple(o[1:]) != tuple(g[1:]) \
                    or o[0] * n != g[0] or g[0] % rows:
                return False
        return True

    def evaluate(self, groups, train, devices):
        """Run the plan: ``groups`` holds each group's {variable name:
        tensor}, ``devices`` each group's device.  Returns (each group's
        outputs, {aux name: new value}) — the new BatchNorm moving
        statistics, one value for every group."""
        if self.plan is None:
            raise MXNetError("the graph does not split over dp groups: %s"
                             % self.reason)
        prog = self.prog
        envs = []
        for values in groups:
            env = [None] * prog.n_slots
            for name, s in prog.var_slots:
                if name not in values:
                    raise MXNetError("unbound variable %r" % name)
                env[s] = values[name]
            envs.append(env)
        new_aux = {}
        for k, (op, attrs, ins, first, n_out, free, mutates) in enumerate(
                prog.steps):
            if op.takes_train_flag:
                attrs = dict(attrs, _train=train)
            mode = self.plan[k]
            if mode in ("shared", "rows"):
                outs = [op.impl(*[env[s] for s in ins],
                                **(dict(attrs, _device=dev)
                                   if op.takes_device else attrs))
                        for env, dev in zip(envs, devices)]
            else:
                call = dict(attrs)
                call.pop("_train", None)
                outs = CROSS[mode][0]([[env[s] for s in ins] for env in envs],
                                      call, train, self.mesh)
            for env, out in zip(envs, outs):
                if not isinstance(out, tuple):
                    out = (out,)
                env[first:first + n_out] = out[:n_out]
                for j, name in mutates:
                    new_aux.setdefault(name, out[n_out + j])
                for s in free:
                    env[s] = None
        return [[env[s] for s in prog.out_slots] for env in envs], new_aux
