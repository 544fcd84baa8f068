"""Bucketed training: the port's BucketingModule against the JAX
package's, on the CPU.

A small LSTM language model of ``examples/rnn/lstm_bucketing.py``'s
shape (Embedding -> FusedRNNCell.unroll -> FullyConnected ->
SoftmaxOutput; vocabulary 20, hidden 8, two layers, buckets 5 and 10)
trains six batches that alternate between the buckets.  Both packages
start from the same numpy weights (``set_params``; their initializers
draw from different generators) and see the same seeded batches.

The JAX package's default BucketingModule trains only the anchor
bucket through its fused step and the others through the Updater, so
an optimizer with state keeps two states per parameter there (ROADMAP
R6).  The port keeps one.  So the port is held, within 1e-5, to the JAX
package's general path (its fused step switched off by a monkeypatch of
``FusedTrainStep.supports`` inside the test) for SGD with momentum and
Adam, and to its default path for stateless SGD.
"""
import logging
import random

import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu.module.fused_step as fused_j

import mxnet_tpu_torch as mt

VOCAB, EMBED, HIDDEN, LAYERS, BATCH = 20, 6, 8, 2, 4
BUCKETS = (5, 10)
TOL = dict(rtol=1e-5, atol=1e-5)


def sym_gen_for(mx, layers=LAYERS, auto_names=False):
    """``examples/rnn/lstm_bucketing.py``'s sym_gen at test widths; with
    ``auto_names`` the FullyConnected is left unnamed."""
    stack = mx.rnn.FusedRNNCell(HIDDEN, num_layers=layers, mode="lstm")

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=VOCAB,
                                 output_dim=EMBED, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = mx.sym.FullyConnected(
            data=pred, num_hidden=VOCAB,
            name=None if auto_names else "pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def lm_params(seed=0, layers=LAYERS):
    """Seeded numpy weights for every parameter of the LM."""
    r = np.random.RandomState(seed)
    n_rnn = 0
    for layer in range(layers):
        n_in = EMBED if layer == 0 else HIDDEN
        n_rnn += 4 * HIDDEN * (n_in + HIDDEN) + 8 * HIDDEN
    return {
        "embed_weight": r.uniform(-0.5, 0.5, (VOCAB, EMBED)),
        "lstm_parameters": r.uniform(-0.3, 0.3, (n_rnn,)),
        "pred_weight": r.uniform(-0.3, 0.3, (VOCAB, HIDDEN)),
        "pred_bias": r.uniform(-0.1, 0.1, (VOCAB,)),
    }


def batch_for(mx, key, seed):
    """One seeded next-token batch of bucket ``key``."""
    r = np.random.RandomState(seed)
    data = r.randint(1, VOCAB, (BATCH, key)).astype(np.float32)
    label = np.concatenate([data[:, 1:], np.zeros((BATCH, 1), np.float32)],
                           axis=1)
    return mx.io.DataBatch(
        [mx.nd.array(data, ctx=mx.cpu())],
        [mx.nd.array(label, ctx=mx.cpu())], pad=0, bucket_key=key,
        provide_data=[mx.io.DataDesc("data", (BATCH, key))],
        provide_label=[mx.io.DataDesc("softmax_label", (BATCH, key))])


def bucketing_module(mx, optimizer, params, layers=LAYERS, seed=0):
    mod = mx.mod.BucketingModule(sym_gen_for(mx, layers),
                                 default_bucket_key=max(BUCKETS),
                                 context=mx.cpu())
    first = batch_for(mx, max(BUCKETS), 0)
    mod.bind(first.provide_data, first.provide_label)
    mod.init_params(initializer=mx.initializer.Uniform(0.1))
    mod.set_params({k: mx.nd.array(v.astype(np.float32), ctx=mx.cpu())
                    for k, v in lm_params(seed, layers).items()}, {})
    mod.init_optimizer(optimizer=optimizer, optimizer_params=dict(params))
    return mod


def train(mod, mx, keys, seed0=100):
    for i, key in enumerate(keys):
        mod.forward_backward(batch_for(mx, key, seed0 + i))
        mod.update()


def host_params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


ALTERNATING = [10, 5, 10, 5, 10, 5]


@pytest.fixture
def jax_fused_off(monkeypatch):
    """The JAX package with its fused step switched off: every bucket on
    its general path, one Updater state per parameter."""
    monkeypatch.setattr(fused_j.FusedTrainStep, "supports",
                        staticmethod(lambda module: False))


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-5}),
    ("adam", {"learning_rate": 0.01}),
], ids=["sgd-momentum", "adam"])
def test_stateful_optimizers_match_the_jax_general_path(
        jax_fused_off, optimizer, params):
    got_mod = bucketing_module(mt, optimizer, params)
    want_mod = bucketing_module(mj, optimizer, params)
    train(got_mod, mt, ALTERNATING)
    train(want_mod, mj, ALTERNATING)
    # every bucket of the port trained through its fused step
    assert all(m._fused_step is not None
               for m in got_mod._buckets.values())
    assert_params_close(host_params(got_mod), host_params(want_mod))


def test_stateless_sgd_matches_the_jax_default_path():
    params = {"learning_rate": 0.5, "wd": 1e-5}
    got_mod = bucketing_module(mt, "sgd", params)
    want_mod = bucketing_module(mj, "sgd", params)
    train(got_mod, mt, ALTERNATING)
    train(want_mod, mj, ALTERNATING)
    assert want_mod._buckets[10]._fused_step is not None
    assert_params_close(host_params(got_mod), host_params(want_mod))


def test_buckets_share_tensors_and_one_optimizer_state():
    mod = bucketing_module(mt, "sgd", {"learning_rate": 0.5,
                                       "momentum": 0.9})
    train(mod, mt, ALTERNATING)
    a, b = (mod._buckets[k] for k in BUCKETS)
    exe_a, exe_b = a._exec_group.execs[0], b._exec_group.execs[0]
    for name in lm_params():
        assert exe_a.arg_dict[name].tensor.data_ptr() == \
            exe_b.arg_dict[name].tensor.data_ptr(), name
        assert exe_a.grad_dict[name] is exe_b.grad_dict[name], name
    fa, fb = a._fused_step, b._fused_step
    assert fa is not fb and fa.exe is not fb.exe
    assert fa.shared is fb.shared
    for ma, mb in zip(fa._masters, fb._masters):
        assert ma is mb
    for sa, sb in zip(fa.states, fb.states):
        assert sa is sb
    # the host masters are one dict too
    assert a._arg_params is b._arg_params
    # num_update counts batches, whichever bucket they went through
    assert mod._optimizer.num_update == len(ALTERNATING)


def test_one_state_across_buckets_against_one_module():
    """Alternating buckets of equal weights train exactly like one
    module that sees every batch: the shared momentum is one momentum."""
    params = {"learning_rate": 0.5, "momentum": 0.9}
    mod = bucketing_module(mt, "sgd", params)
    train(mod, mt, ALTERNATING)
    ref = bucketing_module(mt, "sgd", params)
    for m in ref._buckets.values():
        m._fused_step.retire(m._updater)
    train(ref, mt, ALTERNATING)
    for m in ref._buckets.values():
        assert m._fused_step is None
    assert_params_close(host_params(mod), host_params(ref))


def test_bucket_parameter_names_and_json_match_jax():
    """Auto names line up across buckets (one parameter, not one per
    bucket), as the JAX package's ``_spawn`` makes them."""
    for mx in (mt, mj):
        mx.sym.NameManager.current()._counter.clear()
    mods = {}
    for name, mx in (("port", mt), ("jax", mj)):
        mod = mx.mod.BucketingModule(sym_gen_for(mx, auto_names=True),
                                     default_bucket_key=10,
                                     context=mx.cpu())
        first = batch_for(mx, 10, 0)
        mod.bind(first.provide_data, first.provide_label)
        mod.init_params()
        mod.switch_bucket(5, batch_for(mx, 5, 1).provide_data,
                          batch_for(mx, 5, 1).provide_label)
        mods[name] = mod
    for key in BUCKETS:
        got = mods["port"]._buckets[key]
        want = mods["jax"]._buckets[key]
        assert got.symbol.list_arguments() == want.symbol.list_arguments()
        assert "fullyconnected0_weight" in got.symbol.list_arguments()
        assert got.symbol.tojson() == want.symbol.tojson()
    assert sorted(mods["port"].get_params()[0]) == \
        sorted(mods["jax"].get_params()[0])


def _iterators(mx, seed):
    random.seed(seed)
    np.random.seed(seed)
    r = np.random.RandomState(seed)
    sentences = [list(r.randint(1, VOCAB, r.randint(3, 10)))
                 for _ in range(96)]
    train_it = mx.rnn.BucketSentenceIter(sentences[:64], BATCH,
                                         buckets=list(BUCKETS),
                                         invalid_label=0)
    val_it = mx.rnn.BucketSentenceIter(sentences[64:], BATCH,
                                       buckets=list(BUCKETS),
                                       invalid_label=0)
    return train_it, val_it


def test_fit_with_eval_data_and_perplexity_matches_jax():
    """``fit`` over BucketSentenceIter with ``eval_data`` and
    ``Perplexity(0)``: the same training and validation values a epoch."""
    seen = {}
    for name, mx in (("port", mt), ("jax", mj)):
        train_it, val_it = _iterators(mx, 3)
        mod = mx.mod.BucketingModule(sym_gen_for(mx), default_bucket_key=10,
                                     context=mx.cpu())
        values = []
        mod.fit(train_it, eval_data=val_it,
                eval_metric=mx.metric.Perplexity(0), optimizer="sgd",
                optimizer_params={"learning_rate": 0.5, "wd": 1e-5},
                arg_params={k: mx.nd.array(v.astype(np.float32),
                                           ctx=mx.cpu())
                            for k, v in lm_params(1).items()},
                eval_end_callback=lambda p: values.extend(
                    p.eval_metric.get_name_value()),
                num_epoch=2)
        seen[name] = (values, host_params(mod))
    (got, got_p), (want, want_p) = seen["port"], seen["jax"]
    assert [n for n, _ in got] == [n for n, _ in want] == ["perplexity"] * 2
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               **TOL)
    assert_params_close(got_p, want_p)


def example_sentences(n, seed):
    """``examples/rnn/lstm_bucketing.py``'s synthetic_sentences at the
    test vocabulary: lengths 5-39, each word a Markov step from the
    last."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        s = [int(rng.randint(1, VOCAB))]
        for _ in range(rng.randint(5, 40) - 1):
            s.append(int((s[-1] * 7 + rng.randint(0, 3)) % VOCAB) or 1)
        out.append(s)
    return out


def test_fit_at_the_example_settings_matches_jax():
    """The example's fit (buckets 10-40, SGD lr 0.01 without momentum, wd
    1e-5, two epochs) on its generator's sentences: the eval split's
    Perplexity(0) and perplexity over every label after each epoch are
    the JAX package's default path's (1e-5).  Learning the padding label
    0 first moves probability off the real words, so Perplexity(0) rises
    in both while the perplexity over every label falls."""
    buckets = [10, 20, 30, 40]
    sentences = example_sentences(160, 7)
    seen = {}
    for mx in (mt, mj):
        random.seed(7)
        np.random.seed(7)
        train_it = mx.rnn.BucketSentenceIter(sentences[:128], BATCH,
                                             buckets=buckets,
                                             invalid_label=0)
        val_it = mx.rnn.BucketSentenceIter(sentences[128:], BATCH,
                                           buckets=buckets, invalid_label=0)
        mod = mx.mod.BucketingModule(sym_gen_for(mx), default_bucket_key=40,
                                     context=mx.cpu())
        values = []

        def objective(*_):
            values.append(dict(mod.score(val_it, mx.metric.Perplexity(
                None)))["perplexity"])

        mod.fit(train_it, eval_data=val_it,
                eval_metric=mx.metric.Perplexity(0), optimizer="sgd",
                optimizer_params={"learning_rate": 0.01, "momentum": 0.0,
                                  "wd": 1e-5},
                arg_params={k: mx.nd.array(v.astype(np.float32),
                                           ctx=mx.cpu())
                            for k, v in lm_params(2).items()},
                epoch_end_callback=objective,
                eval_end_callback=lambda p: values.extend(
                    v for _, v in p.eval_metric.get_name_value()),
                num_epoch=2)
        seen[mx] = values
    got, want = seen[mt], seen[mj]
    np.testing.assert_allclose(got, want, **TOL)
    # per epoch: the objective, then Perplexity(0)
    objective, real = got[0::2], got[1::2]
    assert real[1] > real[0] and objective[1] < objective[0], got


def test_monitor_retires_every_bucket_and_carries_the_state(
        jax_fused_off):
    """A monitor installed after four fused batches retires the fused
    step of every bucket; the state it held goes to the Updater, so the
    run ends where the JAX package's general path does, and the monitor
    sees every op output of the monitored batches."""
    params = {"learning_rate": 0.5, "momentum": 0.9}
    got_mod = bucketing_module(mt, "sgd", params)
    want_mod = bucketing_module(mj, "sgd", params)
    train(got_mod, mt, ALTERNATING[:4])
    train(want_mod, mj, ALTERNATING[:4])
    mon = mt.Monitor(1, pattern=".*")
    got_mod.install_monitor(mon)
    assert all(m._fused_step is None for m in got_mod._buckets.values())
    rows = []
    for i, key in enumerate(ALTERNATING[4:]):
        mon.tic()
        got_mod.forward_backward(batch_for(mt, key, 104 + i))
        got_mod.update()
        rows.append(mon.toc())
    train(want_mod, mj, ALTERNATING[4:], seed0=104)
    assert_params_close(host_params(got_mod), host_params(want_mod))
    for key, stats in zip(ALTERNATING[4:], rows):
        sym = got_mod._buckets[key].symbol
        want = {node.name + ("_output" if i == 0 else "_output%d" % i)
                for node in sym._topo() if not node.is_var
                for i in range(node.num_outputs())}
        want |= set(sym.list_arguments())
        assert {name for _, name, _ in stats} == want
        for _, _, value in stats:
            assert np.isfinite(float(value.split(",")[0]))


def test_monitor_before_init_optimizer_trains_every_bucket_generally(
        jax_fused_off):
    """bind -> install_monitor -> init_optimizer, as the JAX package's
    ``fit`` orders them: no bucket gets a fused step, the monitor reports
    the anchor's batches, and the run ends where the JAX package's
    general path does (1e-5)."""
    params = {"learning_rate": 0.5, "momentum": 0.9}
    mods = {}
    for mx in (mt, mj):
        mod = mx.mod.BucketingModule(sym_gen_for(mx),
                                     default_bucket_key=max(BUCKETS),
                                     context=mx.cpu())
        first = batch_for(mx, max(BUCKETS), 0)
        mod.bind(first.provide_data, first.provide_label)
        mon = mx.Monitor(1, pattern=".*_output")
        mod.install_monitor(mon)
        mod.init_params(initializer=mx.initializer.Uniform(0.1))
        mod.set_params({k: mx.nd.array(v.astype(np.float32), ctx=mx.cpu())
                        for k, v in lm_params().items()}, {})
        mod.init_optimizer(optimizer="sgd", optimizer_params=params)
        stats = []
        for i, key in enumerate(ALTERNATING):
            mon.tic()
            mod.forward_backward(batch_for(mx, key, 100 + i))
            mod.update()
            stats.append(mon.toc())
        mods[mx] = (mod, stats)
    got_mod, got_stats = mods[mt]
    assert all(m._fused_step is None for m in got_mod._buckets.values())
    assert [bool(r) for r in got_stats] == \
        [key == max(BUCKETS) for key in ALTERNATING]
    assert [[n for _, n, _ in r] for r in got_stats] == \
        [[n for _, n, _ in r] for r in mods[mj][1]]
    assert_params_close(host_params(got_mod), host_params(mods[mj][0]))


def test_jax_default_bucketing_keeps_two_optimizer_states(monkeypatch):
    """ROADMAP R6, on the reference: with momentum its default path (the
    anchor fused, the other bucket on the Updater) ends far from its
    fused-off path, which the port matches; the gap is the second state."""
    params = {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-5}
    default = bucketing_module(mj, "sgd", params)
    train(default, mj, ALTERNATING)
    monkeypatch.setattr(fused_j.FusedTrainStep, "supports",
                        staticmethod(lambda module: False))
    general = bucketing_module(mj, "sgd", params)
    train(general, mj, ALTERNATING)
    a, b = host_params(default), host_params(general)
    gap = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    assert gap > 0.1, gap


def test_force_rebind_keeps_the_trained_parameters():
    """``bind(force_rebind=True)`` after training copies the trained
    values into the new bind.  The JAX package's copies its new anchor's
    freshly zeroed host masters instead (ROADMAP R7)."""
    for mx in (mt, mj):
        mod = bucketing_module(mx, "sgd", {"learning_rate": 0.5})
        train(mod, mx, ALTERNATING[:2])
        before = host_params(mod)
        first = batch_for(mx, 10, 0)
        mod.bind(first.provide_data, first.provide_label, force_rebind=True)
        after = host_params(mod)
        for k in before:
            if mx is mt:
                np.testing.assert_array_equal(after[k], before[k])
            else:
                np.testing.assert_array_equal(after[k], 0.0)
