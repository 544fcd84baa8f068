"""Symbol: the symbolic graph API.

Counterpart of ``mxnet_tpu/symbol/symbol.py``.  A Symbol is a list of
output entries over a DAG of ``_Node`` records; composition creates the
missing weight variables as ``{name}_{input_name}``, as nnvm does.

Nodes are keyed by identity, and by index in the JSON — never by name.
Gluon's export gives many nodes one name (every FFN ``FullyConnected`` is
``fwd``, every ``LayerNorm`` is ``layernorm0``), so only variables, whose
names are the argument names, are ever looked up by name.

The JSON layout is nnvm's (``{"nodes", "arg_nodes", "heads", ...}``) and
the same as the JAX package's, so a graph saved by either loads in both.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading

from ..base import MXNetError, attr_to_str, dtype_name, str_to_attr
from ..context import current_context
from ..ops.registry import eval_shape_op, get_op


class NameManager:
    """Auto-naming for anonymous op nodes (ref: python/mxnet/name.py)."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    @classmethod
    def current(cls):
        if not hasattr(cls._current, "value"):
            cls._current.value = NameManager()
        return cls._current.value

    def __enter__(self):
        self._old = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, *args):
        NameManager._current.value = self._old


class AttrScope:
    """Attributes given to every variable and op composed inside the
    scope: ``with mx.AttrScope(ctx_group="dev1"): ...`` (ref:
    python/mxnet/attribute.py).  Nested scopes merge, the inner winning."""

    _current = threading.local()

    def __init__(self, **kwargs):
        self._attr = kwargs

    def get(self, attr):
        """The scope's attributes updated with ``attr``, as a new dict."""
        base = dict(AttrScope._current.value._attr) \
            if hasattr(AttrScope._current, "value") else {}
        if attr:
            base.update(attr)
        return base

    @classmethod
    def current(cls):
        if not hasattr(cls._current, "value"):
            cls._current.value = AttrScope()
        return cls._current.value

    def __enter__(self):
        self._old = AttrScope.current()
        merged = dict(self._old._attr)
        merged.update(self._attr)
        self._attr = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, *args):
        AttrScope._current.value = self._old


class _Node:
    """Graph node: op application or variable (op_name None)."""

    __slots__ = ("op_name", "name", "attrs", "inputs", "_is_aux")

    def __init__(self, op_name, name, attrs=None, inputs=None):
        self.op_name = op_name
        self.name = name
        self.attrs = dict(attrs or {})   # string attrs (JSON-compatible)
        self.inputs = list(inputs or [])  # [(node, out_idx)]
        self._is_aux = False

    @property
    def is_var(self):
        return self.op_name is None

    def num_outputs(self):
        if self.is_var:
            return 1
        op = get_op(self.op_name)
        return op.str_outputs(op.normalize_attrs(self.attrs))


# the reference's names of multi-output ops' outputs (the rest are
# ``<name>_output<i>``)
_OUTPUT_SUFFIXES = {"BatchNorm": ("output", "mean", "var"),
                    "topk": ("output", "indices")}


class Symbol:
    def __init__(self, entries):
        self._entries = list(entries)  # [(node, out_idx)]
        self._shash = None

    # -- graph walks ---------------------------------------------------------
    def _topo(self):
        """Nodes in DFS post-order from the heads (inputs in order) — the
        order nnvm and the JAX package number them in."""
        order, seen = [], set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for n, _ in node.inputs:
                visit(n)
            order.append(node)

        for node, _ in self._entries:
            visit(node)
        return order

    def _mark_aux(self, order):
        """Variables that feed an op's aux slot are auxiliary states."""
        for node in order:
            if node.is_var:
                continue
            op = get_op(node.op_name)
            if op.aux_names and op.input_names:
                for i, (inp, _) in enumerate(node.inputs):
                    if i >= len(op.input_names) and inp.is_var:
                        inp._is_aux = True

    def _vars(self):
        order = self._topo()
        self._mark_aux(order)
        return [n for n in order if n.is_var]

    def list_arguments(self):
        return [n.name for n in self._vars() if not n._is_aux]

    def list_auxiliary_states(self):
        return [n.name for n in self._vars() if n._is_aux]

    def list_outputs(self):
        out = []
        for node, idx in self._entries:
            if node.is_var:
                out.append(node.name)
            elif node.num_outputs() == 1:
                out.append(node.name + "_output")
            elif idx < len(_OUTPUT_SUFFIXES.get(node.op_name, ())):
                out.append("%s_%s" % (node.name,
                                      _OUTPUT_SUFFIXES[node.op_name][idx]))
            else:
                out.append("%s_output%d" % (node.name, idx))
        return out

    def __getitem__(self, index):
        """One output of a multi-output symbol, by position or name."""
        if isinstance(index, str):
            outs = self.list_outputs()
            if index not in outs:
                raise MXNetError("cannot find output %r" % index)
            index = outs.index(index)
        return Symbol([self._entries[index]])

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (self[i] for i in range(len(self._entries)))

    def get_internals(self):
        """Every output of every node, in topological order."""
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs())])

    def get_children(self):
        """The inputs of a single-output symbol's node, grouped (None for
        a variable or a group)."""
        if len(self._entries) == 1:
            node = self._entries[0][0]
            if node.inputs:
                return Symbol(list(node.inputs))
        return None

    def _set_attr(self, **kwargs):
        for node, _ in self._entries:
            node.attrs.update({k: str(v) for k, v in kwargs.items()})
        self._shash = None

    def attr(self, key):
        """Attribute ``key`` of a single-output symbol's node, else None."""
        if len(self._entries) == 1:
            return self._entries[0][0].attrs.get(key)
        return None

    def list_attr(self, recursive=False):
        """The node's attributes; with ``recursive``, every node's."""
        if recursive:
            return self.attr_dict()
        if len(self._entries) == 1:
            return dict(self._entries[0][0].attrs)
        return {}

    def attr_dict(self):
        """{node name: its attrs} for every node that has attrs."""
        return {node.name: dict(node.attrs) for node in self._topo()
                if node.attrs}

    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    # arithmetic: elementwise ops between Symbols, scalar ops with numbers
    def _binary(self, other, op_sym, op_sc, reverse=False):
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _create(op_sym, [lhs, rhs], {})
        return _create(op_sc, [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._binary(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "elemwise_sub", "_rminus_scalar",
                            reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "elemwise_div", "_rdiv_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _create("negative", [self], {})

    # comparisons compose comparison nodes, ``==`` and ``!=`` too; the hash
    # stays the identity's
    def __eq__(self, o):
        return self._binary(o, "_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binary(o, "_not_equal", "_not_equal_scalar")

    def __hash__(self):
        return id(self)

    def __gt__(self, o):
        return self._binary(o, "_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "_lesser_equal", "_lesser_equal_scalar")

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "Grouped")

    def __copy__(self):
        return Symbol(list(self._entries))

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

    # -- inference -----------------------------------------------------------
    def _arg_entry_values(self, table):
        vars_ = self._vars()
        args = [table.get((n, 0)) for n in vars_ if not n._is_aux]
        auxs = [table.get((n, 0)) for n in vars_ if n._is_aux]
        outs = [table.get((n, i)) for n, i in self._entries]
        return args, outs, auxs

    def infer_shape(self, *args, **kwargs):
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {n: tuple(s) for n, s in zip(arg_names, args)
                 if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes, _ = self._infer(known, {})
        arg_shapes, out_shapes, aux_shapes = self._arg_entry_values(shapes)

        def incomplete(s):
            return s is None or any(int(d) == 0 for d in s)

        if not partial and any(incomplete(s)
                               for s in arg_shapes + out_shapes):
            missing = [n for n, s in zip(arg_names, arg_shapes)
                       if incomplete(s)]
            raise MXNetError("infer_shape incomplete; unknown: %s" % missing)
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """Like the JAX package's: argument, output and aux dtypes, as
        numpy types (torch.bfloat16 for bfloat16)."""
        from ..base import np_dtype
        arg_names = self.list_arguments()
        known = {n: t for n, t in zip(arg_names, args) if t is not None}
        known.update({k: v for k, v in kwargs.items() if v is not None})
        _, dtypes = self._infer({}, {k: dtype_name(v)
                                     for k, v in known.items()})
        return tuple([None if t is None else np_dtype(t) for t in vals]
                     for vals in self._arg_entry_values(dtypes))

    def _infer(self, known_shapes, known_dtypes):
        """Joint fixed-point shape and dtype inference over the graph
        (ref: infer_graph_attr_pass.cc).  Tables are keyed by
        (node object, output index); dtypes are names.

        A 0 dim means "unknown dim" (MXNet's partial shapes); partials
        merge per dim as information arrives."""
        order = self._topo()
        shapes, dtypes = {}, {}
        for node in order:
            if node.is_var:
                s = known_shapes.get(node.name)
                if s is None and "__shape__" in node.attrs:
                    s = tuple(str_to_attr(node.attrs["__shape__"]))
                if s is not None and all(int(d) == 0 for d in s):
                    s = None  # all-unknown partial carries no information
                shapes[(node, 0)] = tuple(s) if s is not None else None
                dt = known_dtypes.get(node.name)
                if dt is None and "__dtype__" in node.attrs:
                    dt = dtype_name(node.attrs["__dtype__"])
                dtypes[(node, 0)] = dt

        def complete(s):
            return s is not None and all(int(d) != 0 for d in s)

        def merge(old, new):
            if new is None:
                return old
            new = tuple(int(d) for d in new)
            if old is None or len(old) != len(new):
                return new
            return tuple(n if o == 0 else o for o, n in zip(old, new))

        def store(table, key, new_s):
            merged = merge(table.get(key), new_s)
            if merged != table.get(key):
                table[key] = merged
                return True
            return False

        def eval_partial(op, eval_ins, dts, attrs):
            """Meta-tensor evaluation with unknown (0) dims: partial
            inputs run twice with the unknown dims set to two sentinels;
            output dims that differ depend on an unknown and stay 0."""
            if all(complete(s) for s in eval_ins):
                return eval_shape_op(op, eval_ins, dts, attrs)

            def sub(v):
                return [tuple(v if int(d) == 0 else int(d) for d in s)
                        for s in eval_ins]
            out1, dts1 = eval_shape_op(op, sub(1), dts, attrs)
            out2, _ = eval_shape_op(op, sub(2), dts, attrs)
            return [tuple(a if a == b else 0 for a, b in zip(s1, s2))
                    if len(s1) == len(s2) else None
                    for s1, s2 in zip(out1, out2)], dts1

        node_info = {}
        for node in order:
            if not node.is_var:
                op = get_op(node.op_name)
                node_info[node] = (op, op.normalize_attrs(node.attrs,
                                                         len(node.inputs)),
                                   node.num_outputs())

        for _ in range(len(order) + 10):
            changed = False
            for node in order:
                if node.is_var:
                    continue
                op, attrs, n_out = node_info[node]
                in_entries = node.inputs
                in_shapes = [shapes.get(e) for e in in_entries]
                in_dtypes = [dtypes.get(e) for e in in_entries]
                if all(complete(shapes.get((node, i))) for i in range(n_out)) \
                        and all(complete(s) for s in in_shapes) \
                        and all(dtypes.get((node, i)) is not None
                                for i in range(n_out)):
                    continue
                if op.infer_type is not None:
                    try:
                        t_filled, t_outs = op.infer_type(in_dtypes, attrs)
                    except Exception:
                        t_filled = t_outs = None
                    for e, d in zip(in_entries, t_filled or ()):
                        if d is not None and dtypes.get(e) is None:
                            dtypes[e] = dtype_name(d)
                            changed = True
                    for i, d in enumerate((t_outs or [])[:n_out]):
                        if d is not None and dtypes.get((node, i)) is None:
                            dtypes[(node, i)] = dtype_name(d)
                            changed = True
                filled, out_shapes = None, None
                if op.infer_shape is not None:
                    try:
                        if op.bidirectional_infer:
                            cur = [shapes.get((node, i)) for i in range(n_out)]
                            filled, out_shapes = op.infer_shape(
                                in_shapes, attrs, cur)
                        else:
                            filled, out_shapes = op.infer_shape(in_shapes,
                                                                attrs)
                    except Exception:
                        filled = None
                elif all(s is not None for s in in_shapes):
                    eval_ins = in_shapes
                    # elementwise ops need identical input shapes, so
                    # partials heal each other per dim
                    if op.name.startswith("elemwise_") \
                            and len({len(s) for s in in_shapes}) == 1:
                        acc = in_shapes[0]
                        for s in in_shapes[1:]:
                            acc = merge(acc, s)
                        eval_ins = [acc] * len(in_shapes)
                        filled = eval_ins
                    dts = [d or "float32" for d in in_dtypes]
                    try:
                        out_shapes, out_dts = eval_partial(op, eval_ins, dts,
                                                           attrs)
                    except Exception:
                        out_shapes, out_dts = None, None
                    if out_shapes is not None \
                            and all(d is not None for d in in_dtypes):
                        for i in range(min(n_out, len(out_dts))):
                            if dtypes.get((node, i)) is None:
                                dtypes[(node, i)] = out_dts[i]
                                changed = True
                if filled is not None:
                    for e, s in zip(in_entries, filled):
                        changed |= store(shapes, e, s)
                if out_shapes is not None:
                    for i, s in enumerate(out_shapes[:n_out]):
                        changed |= store(shapes, (node, i), s)
                # default dtype rule: the first known input dtype
                known_dt = next((d for d in in_dtypes if d is not None), None)
                if known_dt is not None and op.infer_type is None:
                    for i in range(n_out):
                        if dtypes.get((node, i)) is None:
                            dtypes[(node, i)] = known_dt
                            changed = True
                    for e, d in zip(in_entries, in_dtypes):
                        if d is None and dtypes.get(e) is None:
                            dtypes[e] = known_dt
                            changed = True
            if not changed:
                break
        return shapes, dtypes

    def structural_hash(self):
        """sha256 over the canonical topo serialization (ops, names,
        attrs, wiring by index, heads): equal exactly when two Symbols
        describe the same graph."""
        if self._shash is None:
            order = self._topo()
            nid = {id(n): i for i, n in enumerate(order)}
            h = hashlib.sha256()
            for n in order:
                h.update(repr((
                    n.op_name, n.name,
                    tuple(sorted((k, str(v)) for k, v in n.attrs.items())),
                    tuple((nid[id(src)], idx) for src, idx in n.inputs),
                )).encode())
            h.update(repr([(nid[id(n)], idx)
                           for n, idx in self._entries]).encode())
            self._shash = h.hexdigest()
        return self._shash

    # -- serialization -------------------------------------------------------
    def tojson(self):
        order = self._topo()
        nid = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            entry = {"op": "null" if n.is_var else n.op_name,
                     "name": n.name,
                     "inputs": [[nid[id(src)], idx, 0]
                                for src, idx in n.inputs]}
            if n.attrs:
                entry["attrs"] = {k: str(v) for k, v in n.attrs.items()}
            nodes.append(entry)
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(order) if n.is_var],
            "node_row_ptr": [],
            "heads": [[nid[id(n)], idx, 0] for n, idx in self._entries],
            "attrs": {"mxnet_version": ["int", 10001]}}, indent=2)

    def save(self, fname):
        from ..filesystem import is_remote, open_uri
        if is_remote(fname):
            with open_uri(fname, "w") as f:
                f.write(self.tojson())
            return
        tmp = fname + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.tojson())
        os.replace(tmp, fname)

    # -- binding -------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_arg_names=None, shared_exec=None,
                    shared_buffer=None, shared_args=None, shared_grads=None,
                    logger=None, **kwargs):
        """Bind with freshly allocated arrays shaped by inference from the
        ``name=shape`` kwargs, with a gradient buffer for every argument
        whose ``grad_req`` is not ``"null"``.

        - ``shared_exec``: its aux states, and its arguments named in
          ``shared_arg_names`` with their gradients, are bound as they are
          wherever their shape and dtype fit (MXNet's memory sharing).
        - ``shared_buffer`` ({name: NDArray}): other arguments of a name
          in it are bound to its array where that fits; each argument
          allocated anew is added to it.
        - ``shared_args`` ({name: NDArray}, arguments and aux states) and
          ``shared_grads``: bound the same way (how bucket executors share
          one set of weights); a shared name that no longer fits is
          allocated zeroed, with a warning to ``logger``.
        - ``group2ctx`` ({ctx_group: context}, manual model
          parallelism): each argument and aux state of a group is
          allocated on its group's context (``_group_contexts``), with its
          gradient; the executor computes on ``ctx``."""
        from ..executor import Executor
        ctx = ctx or current_context()
        shared_args = dict(shared_args or {})
        shared_grads = dict(shared_grads or {})
        if shared_exec is not None:
            for name in shared_arg_names or ():
                if name in shared_exec.arg_dict:
                    shared_args[name] = shared_exec.arg_dict[name]
                    if shared_exec.grad_dict.get(name) is not None:
                        shared_grads[name] = shared_exec.grad_dict[name]
            shared_args.update(shared_exec.aux_dict)
        return Executor._simple_bind(self, ctx, grad_req, type_dict, kwargs,
                                     shared_args=shared_args,
                                     shared_grads=shared_grads,
                                     logger=logger, buffer=shared_buffer,
                                     placed=_group_contexts(self, group2ctx))

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind to the caller's arrays, not copies: ``args``,
        ``args_grad`` and ``aux_states`` as lists in
        ``list_arguments``/``list_auxiliary_states`` order or as dicts;
        ``grad_req`` a string, a list or a dict.  An array lies on
        ``ctx`` or, with ``group2ctx``, on one of its contexts."""
        from ..executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states,
                              others=set((group2ctx or {}).values()))

    def eval(self, ctx=None, **kwargs):
        """The outputs for the argument arrays ``kwargs`` (bound as they
        are)."""
        return self.bind(ctx or current_context(), kwargs).forward()


def _group_contexts(symbol, group2ctx):
    """{variable name: context} under ``group2ctx`` (the reference's
    ``ctx_group`` attribute and ``PlaceDevice``): a variable in a group
    goes to the group's context, and a variable that an op in a group
    reads goes there too unless placed already (so an op's auto-created
    weights follow the op)."""
    placed = {}
    for node in symbol._topo() if group2ctx else ():
        group = node.attrs.get("__ctx_group__") or node.attrs.get("ctx_group")
        if group not in group2ctx:
            continue
        if node.is_var:
            placed[node.name] = group2ctx[group]
        else:
            for src, _ in node.inputs:
                if src.is_var:
                    placed.setdefault(src.name, group2ctx[group])
    return placed


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """Create a variable symbol (ref: mx.sym.Variable).  ``init`` is an
    initializer's ``dumps()`` string or an initializer.  ``stype`` is taken
    and, as in the JAX package, left out of the graph: every array of a
    bound graph is dense."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = AttrScope.current().get(attr)
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(_Node(None, name, attrs), 0)])


Variable = var


def Group(symbols):
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def _create(op_name, sym_inputs, attrs, name=None):
    """Compose an op node over input symbols, creating variables for the
    op's missing named inputs like nnvm composition does."""
    op = get_op(op_name)
    name = NameManager.current().get(name, op_name.strip("_"))
    entries = []
    for s in sym_inputs:
        if len(s._entries) != 1:
            raise MXNetError("cannot compose multi-output symbol as one input")
        entries.append(s._entries[0])
    if op.input_names:
        full = list(op.input_names) + list(op.aux_names)
        nattrs = op.normalize_attrs(attrs)
        n_expected = op.num_inputs(nattrs) if callable(op.num_inputs) \
            else len(full)
        if op_name in ("FullyConnected", "Convolution", "Deconvolution") \
                and nattrs.get("no_bias"):
            n_expected -= 1
        while len(entries) < n_expected:
            vname = "%s_%s" % (name, full[len(entries)])
            entries.append((_Node(None, vname, AttrScope.current().get(None)),
                            0))
    str_attrs = {k: v if isinstance(v, str) else attr_to_str(v)
                 for k, v in attrs.items() if v is not None}
    for k, v in AttrScope.current().get(None).items():
        str_attrs.setdefault(k, v)
    node = _Node(op_name, name, str_attrs, entries)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def load_json(json_str):
    data = json.loads(json_str)
    built = []
    for meta in data["nodes"]:
        attrs = meta.get("attrs", meta.get("param", {})) or {}
        if meta["op"] == "null":
            node = _Node(None, meta["name"], attrs)
        else:
            inputs = [(built[nid], idx) for nid, idx, *_ in meta["inputs"]]
            node = _Node(meta["op"], meta["name"], attrs, inputs)
        built.append(node)
    heads = data.get("heads", [[len(built) - 1, 0, 0]])
    return Symbol([(built[nid], idx) for nid, idx, *_ in heads])


def load(fname):
    from ..filesystem import open_uri
    with open_uri(fname, "r") as f:
        return load_json(f.read())


def zeros(shape, dtype="float32", **kwargs):
    """A ``_zeros`` node; like the JAX package's, it takes no ``name``, so
    auto names (``zeros0``, ...) and the JSON match.  A 0 dim is filled in
    by shape inference at bind (an RNN's begin state of batch 0)."""
    return _create("_zeros", [], {"shape": shape, "dtype": dtype})


def ones(shape, dtype="float32", **kwargs):
    return _create("_ones", [], {"shape": shape, "dtype": dtype})


def arange(start, stop=None, step=1.0, repeat=1, name=None, dtype="float32"):
    """An ``_arange`` node: evenly spaced values in [start, stop), each
    ``repeat`` times."""
    return _create("_arange", [], {"start": start, "stop": stop, "step": step,
                                   "repeat": repeat, "dtype": dtype},
                   name=name)
