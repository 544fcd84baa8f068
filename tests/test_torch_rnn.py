"""The port's recurrent pieces (``mxnet_tpu_torch``: the fused ``RNN`` op,
``gluon.rnn`` layers and cells, a small LSTM language model trained one
step) against the JAX package, on the CPU, from seeded numpy inputs.

Tolerances: f32 forward values atol=rtol=1e-5 (XLA:CPU's scan and
torch's fused call sum in other orders); gradients atol=rtol=1e-4;
names and shapes exactly.  Dropout and zoneout rates are 0 wherever
values are compared: the port draws its masks from torch's generator,
so their bits differ from JAX's; at rates above 0 the port's shapes, the
share kept and the 1/(1-p) scaling are checked instead.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
from mxnet_tpu_torch.symbol import NameManager

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
PKGS = (mx, jmx)


def names(pkg):
    return NameManager() if pkg is mx else JNameManager()


def arr(pkg, a):
    return pkg.nd.array(np.asarray(a, np.float32), ctx=pkg.cpu())


def close(got, want, tol):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


# ---------------------------------------------------------------------------
# the RNN op
# ---------------------------------------------------------------------------

T, N, C, H = 5, 3, 4, 6
OP_CASES = [(mode, layers, bid, so, None)
            for mode in ("rnn_relu", "rnn_tanh", "lstm", "gru")
            for layers in (1, 2) for bid in (False, True)
            for so in (False, True)]
OP_CASES += [("lstm", 2, bid, so, (-0.2, 0.3))
             for bid in (False, True) for so in (False, True)]


def op_inputs(mode, layers, bid, seed=0):
    """(inputs, cotangents of every output) as seeded numpy arrays."""
    r = np.random.RandomState(seed)
    dirs = 2 if bid else 1
    states = 2 if mode == "lstm" else 1
    ins = [r.normal(size=(T, N, C)),
           r.uniform(-0.4, 0.4, rnn_param_size(layers, C, H, bid, mode))]
    ins += [r.normal(size=(layers * dirs, N, H)) for _ in range(states)]
    cts = [r.normal(size=(T, N, H * dirs))]
    cts += [r.normal(size=(layers * dirs, N, H)) for _ in range(states)]
    return ([a.astype(np.float32) for a in ins],
            [c.astype(np.float32) for c in cts])


def op_attrs(mode, layers, bid, clip):
    attrs = dict(state_size=H, num_layers=layers, bidirectional=bid,
                 mode=mode)
    if clip:
        attrs.update(lstm_state_clip_min=clip[0], lstm_state_clip_max=clip[1])
    return attrs


_JAX_OP = {}


def jax_rnn_op(mode, layers, bid, clip):
    """The JAX package's ``RNN`` impl as one jitted program: every output,
    and the input gradients for the output's cotangent alone and for all
    outputs' cotangents.  Cached per case: ``state_outputs`` only changes
    which outputs are visible."""
    key = (mode, layers, bid, clip)
    if key not in _JAX_OP:
        import functools
        import jax
        from mxnet_tpu.ops.rnn_op import _rnn_impl
        fn = functools.partial(_rnn_impl, jax.random.PRNGKey(0),
                               state_outputs=True, _train=False,
                               **op_attrs(*key))

        def run(ins, cts):
            outs, vjp = jax.vjp(fn, *ins)
            only_out = [cts[0]] + [c * 0 for c in cts[1:]]
            return outs, vjp(tuple(only_out)), vjp(tuple(cts))

        ins, cts = op_inputs(mode, layers, bid)
        outs, g_out, g_all = jax.jit(run)(ins, cts)
        _JAX_OP[key] = ([np.asarray(o) for o in outs],
                        [np.asarray(g) for g in g_out],
                        [np.asarray(g) for g in g_all])
    return _JAX_OP[key]


def run_rnn_op(case):
    """The port's ``nd.RNN`` under ``autograd.record()``: its visible
    outputs and the gradients of every input."""
    mode, layers, bid, so, clip = case
    ins, cts = op_inputs(mode, layers, bid)
    nds = [arr(mx, a) for a in ins]
    for a in nds:
        a.attach_grad()
    with mx.autograd.record():
        outs = mx.nd.RNN(*nds, state_outputs=so,
                         **op_attrs(mode, layers, bid, clip))
        outs = outs if isinstance(outs, list) else [outs]
        loss = sum((o * arr(mx, c)).sum() for o, c in zip(outs, cts))
    loss.backward()
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in nds]


@pytest.mark.parametrize("case", OP_CASES,
                         ids=lambda c: "-".join(str(v) for v in c))
def test_rnn_op_forward_and_gradients_match_the_jax_package(case):
    mode, layers, bid, so, clip = case
    outs, grads = run_rnn_op(case)
    jouts, jg_out, jg_all = jax_rnn_op(mode, layers, bid, clip)
    n_vis = len(jouts) if so else 1
    assert len(outs) == n_vis
    for got, want in zip(outs, jouts):
        close(got, want, FWD)
    for got, want in zip(grads, jg_all if so else jg_out):
        close(got, want, GRAD)


def test_rnn_op_clip_bounds_only_the_final_cell_state():
    outs, _ = run_rnn_op(("lstm", 2, False, True, (-0.2, 0.3)))
    free, _ = run_rnn_op(("lstm", 2, False, True, None))
    assert outs[2].min() >= -0.2 and outs[2].max() <= 0.3
    assert np.abs(free[2]).max() > 0.3  # the clip did act
    np.testing.assert_array_equal(outs[0], free[0])  # outputs untouched


@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
@pytest.mark.parametrize("bid", [False, True])
def test_rnn_op_shape_inference_matches_the_jax_package(mode, bid):
    got, want = [], []
    for pkg, out in ((mx, got), (jmx, want)):
        data = pkg.sym.var("data")
        s = pkg.sym.RNN(data, state_size=H, num_layers=2, bidirectional=bid,
                        mode=mode, state_outputs=True, name="rnn")
        out.append((s.list_arguments(), s.infer_shape(data=(T, N, C))))
    assert got == want


def test_rnn_op_dropout_between_layers_only_in_training():
    r = np.random.RandomState(3)
    x = arr(mx, r.normal(size=(T, N, C)))

    def run(layers, p, seed=1):
        params = arr(mx, np.random.RandomState(4).uniform(
            -1, 1, rnn_param_size(layers, C, H, False, "gru")))
        h0 = mx.nd.zeros((layers, N, H), ctx=mx.cpu())
        mx.random.seed(seed)
        return mx.nd.RNN(x, params, h0, state_size=H, num_layers=layers,
                         mode="gru", p=p).asnumpy()

    base = run(2, 0.0)
    np.testing.assert_array_equal(run(2, 0.5), base)  # predict mode
    with mx.autograd.train_mode():
        a, b, c = run(2, 0.5), run(2, 0.5), run(2, 0.5, seed=2)
        # one layer: nothing lies between layers to drop
        np.testing.assert_array_equal(run(1, 0.5), run(1, 0.0))
    np.testing.assert_array_equal(a, b)  # mx.random.seed decides the mask
    assert not np.allclose(a, base) and not np.allclose(a, c)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

# kind: (class, its kwargs, bidirectional)
LAYER_KINDS = {"rnn_relu": ("RNN", dict(activation="relu"), True),
               "rnn_tanh": ("RNN", dict(activation="tanh"), False),
               "lstm": ("LSTM", {}, True), "gru": ("GRU", {}, False)}


def seeded(params, seed):
    r = np.random.RandomState(seed)
    return {k: r.uniform(-0.4, 0.4, p.shape).astype(np.float32)
            for k, p in sorted(params.items())}


def set_params(pkg, params, values):
    for k, p in params.items():
        if pkg is mx:
            p.set_data(mx.nd.array(values[k], ctx=mx.cpu()))
        else:
            p._load_init(jmx.nd.array(values[k], ctx=jmx.cpu()), jmx.cpu())


def to_layout(a, layout):
    """A (T, N, ...) array in ``layout``; the swap is its own inverse."""
    return a if layout == "TNC" else np.swapaxes(a, 0, 1)


def split_flat(layer, flat):
    """{parameter name: array} from a flat vector in the fused op's layout
    (all i2h/h2h weights layer by layer and direction by direction, then
    all biases in the same order)."""
    dirs = ["l", "r"] if layer._dir == 2 else ["l"]
    order = ["%s%d_%s" % (j, i, n) for i in range(layer._num_layers)
             for j in dirs for n in ("i2h_weight", "h2h_weight")]
    order += ["%s%d_%s" % (j, i, n) for i in range(layer._num_layers)
              for j in dirs for n in ("i2h_bias", "h2h_bias")]
    out, off = {}, 0
    for name in order:
        p = getattr(layer, name)
        size = int(np.prod(p.shape))
        out[p.name] = flat[off:off + size].reshape(p.shape)
        off += size
    assert off == flat.size
    return out


def layer_case(pkg, kind, layout):
    """Two stacked layers of ``kind`` in ``layout``; the port's with a
    deferred input width, the JAX package's given it."""
    cls, kwargs, bid = LAYER_KINDS[kind]
    with names(pkg):
        return getattr(pkg.gluon.rnn, cls)(
            H, num_layers=2, layout=layout, bidirectional=bid,
            input_size=0 if pkg is mx else C, **kwargs)


@pytest.mark.parametrize("kind", sorted(LAYER_KINDS))
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
def test_layer_matches_the_jax_package(kind, layout):
    """The port's layer against the JAX package's: the same parameter
    names and shapes (the port's found from its first input), the JAX
    layer's flat vector from them (``_flat_params``), and the output,
    final states and every gradient against the JAX ``RNN`` program of
    that flat vector (the JAX layer's forward is that op between two
    axis swaps).  The port's NTC layer gets the TNC data swapped."""
    mode = "rnn_" + LAYER_KINDS[kind][1]["activation"] \
        if LAYER_KINDS[kind][0] == "RNN" else kind
    bid = LAYER_KINDS[kind][2]
    ins, cts = op_inputs(mode, 2, bid)
    jouts, _, jgrads = jax_rnn_op(mode, 2, bid, None)
    jlayer = layer_case(jmx, kind, "TNC")
    jlayer.initialize(ctx=jmx.cpu())
    values = split_flat(jlayer, ins[1])
    set_params(jmx, jlayer.collect_params(), values)
    np.testing.assert_array_equal(
        jlayer._flat_params(jmx.cpu()).asnumpy(), ins[1])

    layer = layer_case(mx, kind, layout)
    layer.initialize(ctx=mx.cpu())
    x = arr(mx, to_layout(ins[0], layout))
    layer(x)  # finishes the deferred init from the input's width
    params = layer.collect_params()
    assert {k: tuple(p.shape) for k, p in params.items()} == \
        {k: tuple(p.shape) for k, p in jlayer.collect_params().items()}
    set_params(mx, params, values)
    x.attach_grad()
    with mx.autograd.record():
        out, states = layer(x, [arr(mx, a) for a in ins[2:]])
        loss = (out * arr(mx, to_layout(cts[0], layout))).sum() + sum(
            (s * arr(mx, c)).sum() for s, c in zip(states, cts[1:]))
    loss.backward()
    got = [to_layout(out.asnumpy(), layout)] + [s.asnumpy() for s in states]
    for g, want in zip(got, jouts):
        close(g, want, FWD)
    close(to_layout(x.grad.asnumpy(), layout), jgrads[0], GRAD)
    want = split_flat(jlayer, jgrads[1])
    for k, p in params.items():
        close(p.grad().asnumpy(), want[k], GRAD)


def test_layer_without_states_returns_the_output_only():
    with names(mx):
        layer = mx.gluon.rnn.GRU(H, input_size=C)
    layer.initialize(ctx=mx.cpu())
    out = layer(mx.nd.zeros((T, N, C), ctx=mx.cpu()))
    assert isinstance(out, mx.nd.NDArray) and out.shape == (T, N, H)
    with pytest.raises(ValueError):
        layer(mx.nd.zeros((T, N, C), ctx=mx.cpu()),
              [mx.nd.zeros((2, N, H), ctx=mx.cpu())])
    assert repr(layer) == "GRU(4 -> 6, TNC)"


def test_layer_off_the_host_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with names(mx):
        layer = mx.gluon.rnn.LSTM(H, input_size=C)
    with pytest.raises(mx.MXNetError):
        layer.initialize()
        layer(mx.nd.zeros((T, N, C)))


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def make_cell(pkg, kind):
    rnn = pkg.gluon.rnn
    if kind == "rnn_tanh":
        return rnn.RNNCell(H)
    if kind == "rnn_relu":
        return rnn.RNNCell(H, activation="relu")
    if kind == "lstm":
        return rnn.LSTMCell(H)
    if kind == "gru":
        return rnn.GRUCell(H)
    if kind == "sequential":
        cell = rnn.SequentialRNNCell()
        with cell.name_scope():
            cell.add(rnn.LSTMCell(H))
            cell.add(rnn.DropoutCell(0.0))
            cell.add(rnn.GRUCell(H))
        return cell
    if kind == "zoneout":
        return rnn.ZoneoutCell(rnn.LSTMCell(H), 0.0, 0.0)
    if kind == "residual":
        return rnn.ResidualCell(rnn.GRUCell(C))
    if kind == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(H, prefix="l_"),
                                     rnn.GRUCell(H, prefix="r_"))
    raise ValueError(kind)


CELLS = ["rnn_tanh", "rnn_relu", "lstm", "gru", "sequential", "zoneout",
         "residual", "bidirectional"]


def run_cell(pkg, kind, layout, merge, hybrid, seed=0):
    """``unroll`` of a cell over seeded TNC data (swapped into
    ``layout``): parameter shapes, then the per-step outputs and the
    final states, and the gradients of every parameter and of the data
    (back in TNC)."""
    r = np.random.RandomState(seed)
    x0 = r.normal(size=(T, N, C))
    with names(pkg):
        cell = make_cell(pkg, kind)
    cell.initialize(ctx=pkg.cpu())
    if hybrid:
        cell.hybridize()
    x = arr(pkg, to_layout(x0, layout))
    cell.unroll(T, x, layout=layout)  # finishes the deferred init
    params = cell.collect_params()
    shapes = {k: tuple(p.shape) for k, p in params.items()}
    set_params(pkg, params, seeded(params, seed + 1))
    x.attach_grad()
    with pkg.autograd.record():
        outs, states = cell.unroll(T, x, layout=layout,
                                   merge_outputs=merge)
        hout = outs.shape[-1] if merge else outs[0].shape[-1]
        heads = np.random.RandomState(seed + 2).normal(size=(T, N, hout))
        if merge:
            loss = (outs * arr(pkg, to_layout(heads, layout))).sum()
            steps = list(to_layout(outs.asnumpy(), layout))
        else:
            loss = sum((o * arr(pkg, h)).sum() for o, h in zip(outs, heads))
            steps = [o.asnumpy() for o in outs]
        r2 = np.random.RandomState(seed + 3)
        loss = loss + sum((s * arr(pkg, r2.normal(size=s.shape))).sum()
                          for s in states)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in params.items()}
    grads["data"] = to_layout(x.grad.asnumpy(), layout)
    return shapes, steps + [s.asnumpy() for s in states], grads


_JAX_CELL = {}


@pytest.mark.parametrize("kind", CELLS)
@pytest.mark.parametrize("layout,merge,hybrid",
                         [("NTC", True, False), ("TNC", False, False),
                          ("TNC", True, True)],
                         ids=["ntc-merged", "tnc-list", "tnc-hybrid"])
def test_cell_unroll_matches_the_jax_package(kind, layout, merge, hybrid):
    """The port's unroll in each form against the JAX package's
    imperative TNC unroll with merged outputs (run once per kind).  The
    JAX side runs imperatively: its hybridized cell, stepped more than
    once in one ``record()``, gets wrong gradients (ROADMAP R4)."""
    if kind not in _JAX_CELL:
        _JAX_CELL[kind] = run_cell(jmx, kind, "TNC", True, False)
    shapes, outs, grads = run_cell(mx, kind, layout, merge, hybrid)
    jshapes, jouts, jgrads = _JAX_CELL[kind]
    assert shapes == jshapes and shapes
    assert len(outs) == len(jouts) > T
    for got, want in zip(outs, jouts):
        close(got, want, FWD)
    assert grads.keys() == jgrads.keys()
    for k in grads:
        close(grads[k], jgrads[k], GRAD)


def test_modified_cell_refuses_its_own_begin_state():
    with names(mx):
        base = mx.gluon.rnn.GRUCell(H)
        zone = mx.gluon.rnn.ZoneoutCell(base, 0.1, 0.1)
    assert isinstance(zone, mx.gluon.rnn.ModifierCell)
    with pytest.raises(AssertionError):
        base.begin_state(N, ctx=mx.cpu())
    assert [s.shape for s in zone.begin_state(N, ctx=mx.cpu())] == [(N, H)]
    with pytest.raises(NotImplementedError):
        mx.gluon.rnn.BidirectionalCell(mx.gluon.rnn.GRUCell(H),
                                       mx.gluon.rnn.GRUCell(H))(None, [])


def test_dropout_cell_keeps_one_minus_p_and_scales_the_kept():
    mx.random.seed(5)
    with names(mx):
        cell = mx.gluon.rnn.DropoutCell(0.25)
    x = mx.nd.ones((400, 50), ctx=mx.cpu())
    with mx.autograd.train_mode():
        out, states = cell(x, [])
    y = out.asnumpy()
    assert out.shape == x.shape and states == []
    kept = y != 0
    assert abs(kept.mean() - 0.75) < 0.02
    np.testing.assert_allclose(y[kept], 1 / 0.75, rtol=1e-6)
    np.testing.assert_array_equal(cell(x, [])[0].asnumpy(), x.asnumpy())


def test_zoneout_keeps_the_previous_values_at_its_rate():
    mx.random.seed(6)
    with names(mx):
        cell = mx.gluon.rnn.ZoneoutCell(mx.gluon.rnn.LSTMCell(32), 0.3, 0.6)
    cell.initialize(ctx=mx.cpu())
    x = arr(mx, np.random.RandomState(0).normal(size=(64, 3, 8)))
    outs, states = cell.unroll(3, x, layout="NTC", merge_outputs=False)
    assert [o.shape for o in outs] == [(64, 32)] * 3
    assert [s.shape for s in states] == [(64, 32)] * 2
    # one step from zero states: a zoned-out value is the previous one, 0
    outs, states = cell.unroll(1, x, layout="NTC", merge_outputs=False)
    assert abs((outs[0].asnumpy() == 0).mean() - 0.3) < 0.04
    for s in states:
        assert abs((s.asnumpy() == 0).mean() - 0.6) < 0.04


def test_lstm_cell_unroll_matches_the_fused_layer():
    r = np.random.RandomState(7)
    with names(mx):
        layer = mx.gluon.rnn.LSTM(H, input_size=C, layout="NTC")
        cell = mx.gluon.rnn.LSTMCell(H, input_size=C)
    layer.initialize(ctx=mx.cpu())
    cell.initialize(ctx=mx.cpu())
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        value = mx.nd.array(r.uniform(-0.5, 0.5, getattr(cell, name).shape)
                            .astype(np.float32), ctx=mx.cpu())
        getattr(cell, name).set_data(value)
        getattr(layer, "l0_" + name).set_data(value)
    x = arr(mx, r.normal(size=(N, T, C)))
    h = [arr(mx, r.normal(size=(N, H))) for _ in range(2)]
    outs, (hT, cT) = cell.unroll(T, x, begin_state=h, layout="NTC",
                                 merge_outputs=True)
    fused, (fh, fc) = layer(x, [s.reshape((1, N, H)) for s in h])
    close(outs.asnumpy(), fused.asnumpy(), FWD)
    close(hT.asnumpy(), fh.asnumpy()[0], FWD)
    close(cT.asnumpy(), fc.asnumpy()[0], FWD)


# ---------------------------------------------------------------------------
# a small LSTM language model, one Trainer step
# ---------------------------------------------------------------------------

VOCAB, EMBED, BPTT, BATCH = 17, 8, 6, 4


def lm_step(pkg, seed=0):
    gluon = pkg.gluon
    r = np.random.RandomState(seed)
    with names(pkg):
        net = gluon.nn.Sequential()
        with net.name_scope():
            net.add(gluon.nn.Embedding(VOCAB, EMBED))
            net.add(gluon.nn.Dropout(0.0))
        rnn = gluon.rnn.LSTM(EMBED, num_layers=2, input_size=EMBED)
        head = gluon.nn.Dense(VOCAB, flatten=False, in_units=EMBED)
    blocks = (net, rnn, head)
    for b in blocks:
        b.initialize(ctx=pkg.cpu())
    params = {}
    for b in blocks:
        params.update(b.collect_params().items())
    set_params(pkg, params, seeded(params, seed + 1))
    before = {k: p.data().asnumpy() for k, p in params.items()}
    x = arr(pkg, r.randint(0, VOCAB, (BPTT, BATCH)))
    y = arr(pkg, r.randint(0, VOCAB, (BPTT, BATCH)))
    state = rnn.begin_state(BATCH, ctx=pkg.cpu())
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 1.0})
    with pkg.autograd.record():
        out, state = rnn(net(x), state)
        logits = head(out).reshape((-3, -1))
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(logits,
                                                    y.reshape((-1,)))
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in params.items()}
    norm = gluon.utils.clip_global_norm(
        [p.grad() for p in params.values()], 0.1 * BPTT * BATCH)
    trainer.step(BATCH)
    after = {k: p.data().asnumpy() for k, p in params.items()}
    return loss.asnumpy(), grads, norm, before, after


def test_small_lstm_lm_trains_one_step_like_the_jax_package():
    (loss, grads, norm, before, after), (jloss, jgrads, jnorm, _, jafter) = (
        lm_step(pkg) for pkg in PKGS)
    close(loss, jloss, FWD)
    assert grads.keys() == jgrads.keys() and len(grads) == 11
    for k in grads:
        close(grads[k], jgrads[k], GRAD)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-5)
    assert norm > 0.1 * BPTT * BATCH  # the clip acted
    for k in after:
        close(after[k], jafter[k], GRAD)
        assert not np.array_equal(after[k], before[k]), k
