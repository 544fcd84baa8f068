"""``mx.rnn``, the legacy symbol cells and the bucketing iterator: the
port against the JAX package on the CPU.

Each cell is unrolled in both packages under a fresh NameManager; the
graphs must have the same arguments, inferred shapes and JSON, and the
same predict-mode forward (within 1e-5) from the same seeded numpy
weights and inputs.  ``FusedRNNCell``'s unpack/pack/unfuse round trip
and the ``FusedRNN`` initializer's pieces are checked exactly, and
``BucketSentenceIter`` must give the same buckets and batches under one
seed, in both layouts.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-5)
N, T, C, H = 3, 4, 5, 6


def _cells(mx, kind):
    r = mx.rnn
    return {
        "rnn_tanh": lambda: r.RNNCell(H, prefix="rnn_"),
        "rnn_relu": lambda: r.RNNCell(H, activation="relu", prefix="rr_"),
        "lstm": lambda: r.LSTMCell(H, forget_bias=0.5),
        "gru": lambda: r.GRUCell(H),
        "fused_lstm": lambda: r.FusedRNNCell(H, num_layers=2, mode="lstm",
                                             get_next_state=True),
        "fused_gru_bi": lambda: r.FusedRNNCell(
            H, num_layers=1, mode="gru", bidirectional=True, prefix="g_"),
        "fused_relu": lambda: r.FusedRNNCell(H, num_layers=2,
                                             mode="rnn_relu"),
        "sequential": lambda: _stack(r),
        "zoneout": lambda: r.ZoneoutCell(r.LSTMCell(H, prefix="z_"), 0.5,
                                         0.5),
        "residual": lambda: r.ResidualCell(r.GRUCell(C, prefix="res_")),
        "bidirectional": lambda: r.BidirectionalCell(
            r.LSTMCell(H, prefix="l_"), r.LSTMCell(H, prefix="r_")),
    }[kind]()


def _stack(r):
    stack = r.SequentialRNNCell()
    stack.add(r.LSTMCell(H, prefix="l0_"))
    stack.add(r.DropoutCell(0.5, prefix="d0_"))
    stack.add(r.GRUCell(H, prefix="l1_"))
    return stack


def _unrolled(mx, kind, layout, merge):
    with mx.sym.NameManager():
        cell = _cells(mx, kind)
        out, states = cell.unroll(T, inputs=mx.sym.Variable("data"),
                                  layout=layout, merge_outputs=merge)
        outs = [out] if not isinstance(out, list) else list(out)
        return mx.sym.Group(outs + list(states))


CASES = [(k, layout, merge) for k in (
    "rnn_tanh", "rnn_relu", "lstm", "gru", "fused_lstm", "fused_gru_bi",
    "fused_relu", "sequential", "zoneout", "residual", "bidirectional")
    for layout, merge in (("NTC", True), ("TNC", False))]


@pytest.mark.parametrize("kind,layout,merge", CASES,
                         ids=["%s-%s-%s" % c for c in CASES])
def test_cell_unroll_matches_jax(kind, layout, merge):
    got = _unrolled(mt, kind, layout, merge)
    want = _unrolled(mj, kind, layout, merge)
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    assert got.list_arguments() == want.list_arguments()
    assert got.list_outputs() == want.list_outputs()
    assert got.tojson() == want.tojson()
    shapes_t = got.infer_shape(data=shape)
    shapes_j = want.infer_shape(data=shape)
    assert [[tuple(s) for s in part] for part in shapes_t] == \
        [[tuple(s) for s in part] for part in shapes_j]
    r = np.random.RandomState(hash(kind) % 1000)
    values = {n: r.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in zip(got.list_arguments(), shapes_t[0])}
    outs = []
    for mx, sym in ((mt, got), (mj, want)):
        exe = sym.simple_bind(mx.cpu(), data=shape)
        for n, v in values.items():
            exe.arg_dict[n][:] = v
        outs.append([o.asnumpy() for o in exe.forward(is_train=False)])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, **TOL)


def _fused(mx, mode, bidirectional, layers=2):
    return mx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                               bidirectional=bidirectional, prefix="f_")


@pytest.mark.parametrize("mode,bidirectional", [
    ("lstm", False), ("gru", True), ("rnn_tanh", False)])
def test_fused_cell_unpack_pack_unfuse_round_trip(mode, bidirectional):
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    n = rnn_param_size(2, C, H, bidirectional, mode)
    flat = np.arange(n, dtype=np.float32)
    pieces = {}
    for mx in (mt, mj):
        cell = _fused(mx, mode, bidirectional)
        un = cell.unpack_weights(
            {"f_parameters": mx.nd.array(flat, ctx=mx.cpu())})
        pieces[mx] = {k: v.asnumpy() for k, v in un.items()}
        back = cell.pack_weights(un)
        np.testing.assert_array_equal(back["f_parameters"].asnumpy(), flat)
        # the unfused stack names exactly the unpacked pieces
        stack = cell.unfuse()
        with mx.sym.NameManager():
            out, _ = stack.unroll(T, inputs=mx.sym.Variable("data"),
                                  merge_outputs=True)
        args = set(out.list_arguments()) - {"data"}
        assert args == set(stack.pack_weights(dict(un)))
    assert sorted(pieces[mt]) == sorted(pieces[mj])
    for k in pieces[mj]:
        np.testing.assert_array_equal(pieces[mt][k], pieces[mj][k],
                                      err_msg=k)


def test_fused_and_unfused_forward_agree():
    """The unfused stack with the unpacked weights computes the fused
    op's forward (within 1e-5), in the port."""
    cell = _fused(mt, "lstm", False)
    with mt.sym.NameManager():
        fused_out, _ = cell.unroll(T, inputs=mt.sym.Variable("data"),
                                   merge_outputs=True)
        stack = cell.unfuse()
        unfused_out, _ = stack.unroll(T, inputs=mt.sym.Variable("data"),
                                      merge_outputs=True)
    r = np.random.RandomState(4)
    shapes, _, _ = fused_out.infer_shape(data=(N, T, C))
    flat = r.uniform(-0.4, 0.4, shapes[1]).astype(np.float32)
    x = r.rand(N, T, C).astype(np.float32)
    exe = fused_out.simple_bind(mt.cpu(), data=(N, T, C))
    exe.arg_dict["f_parameters"][:] = flat
    exe.arg_dict["data"][:] = x
    want = exe.forward()[0].asnumpy()
    pieces = cell.unpack_weights(
        {"f_parameters": mt.nd.array(flat, ctx=mt.cpu())})
    exe2 = unfused_out.simple_bind(mt.cpu(), data=(N, T, C))
    for k, v in stack.pack_weights(pieces).items():
        exe2.arg_dict[k][:] = v
    exe2.arg_dict["data"][:] = x
    np.testing.assert_allclose(exe2.forward()[0].asnumpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_fused_rnn_initializer_pieces(mode):
    """The FusedRNN initializer (as FusedRNNCell attaches it) gives the
    pieces the JAX package's gives: the same names, zero biases, and the
    LSTM forget-gate biases at forget_bias, with every weight drawn."""
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    n = rnn_param_size(2, C, H, False, mode)
    got = {}
    for mx in (mt, mj):
        init = mx.initializer.FusedRNN(None, H, 2, mode, forget_bias=0.75)
        arr = mx.nd.zeros((n,), ctx=mx.cpu())
        init(mx.initializer.InitDesc(
            "f_parameters", global_init=mx.initializer.Uniform(0.1)), arr)
        cell = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode, prefix="")
        got[mx] = {k: v.asnumpy() for k, v in
                   cell.unpack_weights({"parameters": arr}).items()}
    assert sorted(got[mt]) == sorted(got[mj])
    for k, v in got[mt].items():
        if k.endswith("_f_bias") and mode == "lstm":
            np.testing.assert_array_equal(v, 0.75)
            np.testing.assert_array_equal(got[mj][k], 0.75)
        elif k.endswith("_bias"):
            np.testing.assert_array_equal(v, 0.0)
            np.testing.assert_array_equal(got[mj][k], 0.0)
        else:
            assert np.abs(v).max() <= 0.1 and np.abs(v).min() > 0, k


def test_fused_cell_parameter_initialized_through_module():
    """A Module initializes the cell's flat vector through the FusedRNN
    initializer the cell attaches to its variable."""
    cell = mt.rnn.FusedRNNCell(H, num_layers=1, mode="lstm", forget_bias=2.0)
    with mt.sym.NameManager():
        out, _ = cell.unroll(T, inputs=mt.sym.Variable("data"),
                             merge_outputs=True)
    mod = mt.mod.Module(mt.sym.MakeLoss(mt.sym.sum(out)), label_names=None,
                        context=mt.cpu())
    mod.bind([("data", (N, T, C))])
    mod.init_params(mt.initializer.Xavier())
    flat = mod.get_params()[0]["lstm_parameters"]
    pieces = cell.unpack_weights({"lstm_parameters": flat})
    np.testing.assert_array_equal(pieces["lstm_l0_i2h_f_bias"].asnumpy(),
                                  2.0)
    np.testing.assert_array_equal(pieces["lstm_l0_h2h_i_bias"].asnumpy(),
                                  0.0)


def _sentences(seed):
    r = np.random.RandomState(seed)
    return [list(r.randint(1, 30, r.randint(2, 14))) for _ in range(60)]


@pytest.mark.parametrize("layout", ["NT", "TN"])
@pytest.mark.parametrize("buckets", [[5, 10, 15], None],
                         ids=["given", "auto"])
def test_bucket_sentence_iter_matches_jax(layout, buckets):
    batches = {}
    for mx in (mt, mj):
        random.seed(7)
        np.random.seed(7)
        it = mx.rnn.BucketSentenceIter(_sentences(1), 4, buckets=buckets,
                                       invalid_label=0, layout=layout)
        seen = []
        for _ in range(2):  # two epochs: the reset-time shuffle too
            for batch in it:
                seen.append((batch.bucket_key, batch.data[0].asnumpy(),
                             batch.label[0].asnumpy(),
                             [tuple(d.shape) for d in batch.provide_data],
                             [tuple(d.shape) for d in batch.provide_label]))
            it.reset()
        batches[mx] = (it.buckets, it.default_bucket_key,
                       [tuple(d.shape) for d in it.provide_data], seen)
    got, want = batches[mt], batches[mj]
    assert got[:3] == want[:3]
    assert len(got[3]) == len(want[3]) > 0
    for a, b in zip(got[3], want[3]):
        assert a[0] == b[0] and a[3:] == b[3:]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
        axis = 1 if layout == "NT" else 0
        assert a[1].shape[axis] == a[0]
