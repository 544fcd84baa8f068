"""Checkpoints and optimizer states between the port and the JAX package.

``model.save_checkpoint``/``load_checkpoint`` and ``Module.save_params``/
``load_params`` write the same symbol JSON and ``.params`` bytes in both
packages (bf16 included) and read each other's; ``Module.load`` with
``load_optimizer_states`` resumes; the fused step's ``fused_v2`` states
load both ways with masters and momentum bit for bit, and equal states
give byte-identical files; the port reads the JAX package's
``Updater``-format states (pickled JAX NDArrays) and a Gluon
``Trainer.save_states`` file of a small LSTM language model's SGD.
Everything here is exact: files are compared byte for byte and arrays
bit for bit.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
from mxnet_tpu.models import resnet as resnet_j
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import resnet as resnet_t
from mxnet_tpu_torch.symbol import NameManager
from test_torch_fused_step import _bf16_mlp, _fc_data, _fc_module, _train
from test_torch_module import _init


def _resnet_params(mx, rn, dtype):
    """A CIFAR ResNet-20 v2 and numpy-seeded parameters as ``mx`` arrays
    in the dtypes type inference gives.  The symbol is built under a
    fresh NameManager, so that its unnamed nodes take the same names in
    both packages."""
    with (NameManager() if mx is mt else JNameManager()):
        sym = rn.get_symbol(10, 20, "3,24,24", dtype=dtype)
    args, auxs = _init(resnet_j.get_symbol(10, 20, "3,24,24"),
                       {"data": (2, 3, 24, 24), "softmax_label": (2,)}, 3)
    types = dict(zip(sym.list_arguments(),
                     sym.infer_type(data="float32")[0]))
    arg = {k: mx.nd.array(v, ctx=mx.cpu()).astype(
        mt.base.dtype_name(types[k])) for k, v in args.items()}
    aux = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in auxs.items()}
    return sym, arg, aux


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_checkpoint_is_byte_identical_and_loads_both_ways(tmp_path,
                                                               dtype):
    files = {}
    for mx, rn in ((mt, resnet_t), (mj, resnet_j)):
        sym, arg, aux = _resnet_params(mx, rn, dtype)
        prefix = str(tmp_path / mx.__name__)
        mx.model.save_checkpoint(prefix, 3, sym, arg, aux)
        files[mx] = (prefix, _read(prefix + "-symbol.json"),
                     _read(prefix + "-0003.params"))
    assert files[mt][1] == files[mj][1]
    assert files[mt][2] == files[mj][2]
    for reader, writer in ((mt, mj), (mj, mt)):
        sym, arg, aux = reader.model.load_checkpoint(files[writer][0], 3)
        _, arg0, aux0 = _resnet_params(reader, resnet_t if reader is mt
                                       else resnet_j, dtype)
        assert sym.tojson() == files[mt][1].decode()
        assert sorted(arg) == sorted(arg0) and sorted(aux) == sorted(aux0)
        for got, want in ((arg, arg0), (aux, aux0)):
            for k in want:
                assert mt.base.dtype_name(got[k].dtype) == \
                    mt.base.dtype_name(want[k].dtype), k
                np.testing.assert_array_equal(
                    np.asarray(got[k].asnumpy(), np.float32),
                    np.asarray(want[k].asnumpy(), np.float32), err_msg=k)


def test_module_save_and_load_params_both_ways(tmp_path):
    """A bf16 module's parameters after one fused epoch: the two packages
    write byte-identical files for equal values, and each package's
    ``load_params`` of the other's file sets bit-identical values."""
    mods = {mx: _bf16_mlp(mx)[0] for mx in (mt, mj)}
    path = {mx: str(tmp_path / ("%s.params" % mx.__name__)) for mx in mods}
    mods[mt].save_params(path[mt])
    mods[mj].load_params(path[mt])
    mods[mj].save_params(path[mj])
    assert _read(path[mt]) == _read(path[mj])
    mods[mt].load_params(path[mj])
    for k, v in mods[mt].get_params()[0].items():
        assert mt.base.dtype_name(v.dtype) == "bfloat16"
        np.testing.assert_array_equal(
            v.asnumpy(), np.asarray(mods[mj].get_params()[0][k].asnumpy(),
                                    np.float32), err_msg=k)


def _states(mod):
    """{name: (master or None, momentum)} of a module's fused step."""
    fs = mod._fused_step
    out = {}
    for j, n in enumerate(fs.param_names):
        m = fs._masters[j] if fs.mixed[j] else None
        out[n] = tuple(None if t is None else np.array(
            t.numpy() if hasattr(t, "numpy") else t)
            for t in (m, fs.states[j]))
    return out


def test_fused_v2_states_load_both_ways_and_equal_states_give_equal_files(
        tmp_path):
    """bf16 with f32 masters: the port's fused_v2 file restores the JAX
    package's masters and momentum bit for bit, and the reverse; after
    the load both packages hold equal states and write byte-identical
    files."""
    src_t, it_t = _bf16_mlp(mt)
    src_j, it_j = _bf16_mlp(mj)
    _train(src_t, it_t, 1)
    _train(src_j, it_j, 1)
    for src, dst_pkg in ((src_t, mj), (src_j, mt)):
        fname = str(tmp_path / ("from_%s.states" % (
            "port" if src is src_t else "jax")))
        src.save_optimizer_states(fname)
        dst, _ = _bf16_mlp(dst_pkg, seed=5)
        dst.load_optimizer_states(fname)
        want, got = _states(src), _states(dst)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
            np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=k)
        # the states now equal: the destination writes the same bytes
        dst._fused_step.ran = True
        again = fname + ".again"
        dst.save_optimizer_states(again)
        assert _read(again) == _read(fname)


def test_port_reads_jax_updater_states(tmp_path):
    """The JAX package's general path pickles its Updater's states (JAX
    NDArrays); the port's Module loads them as its own NDArrays, bit for
    bit, and trains on from them as the JAX package does."""
    x, y, init = _fc_data()
    params = {"learning_rate": 0.1, "momentum": 0.9}
    mod_j, it_j = _fc_module(mj, "sgd", params, x, y, init, fused=False)
    _train(mod_j, it_j, 1)
    fname = str(tmp_path / "updater.states")
    mod_j.save_optimizer_states(fname)
    mod_t, it_t = _fc_module(mt, "sgd", params, x, y, init)
    mod_t.set_params(*[{k: mt.nd.array(v.asnumpy(), ctx=mt.cpu())
                        for k, v in d.items()} for d in mod_j.get_params()])
    mod_t.load_optimizer_states(fname)
    assert mod_t._fused_step is None  # restored on the general path
    for idx, st in mod_j._updater.states.items():
        got = mod_t._updater.states[idx]
        assert isinstance(got, mt.nd.NDArray)
        np.testing.assert_array_equal(got.asnumpy(), st.asnumpy())
    _train(mod_j, it_j, 1)
    _train(mod_t, it_t, 1)
    for k, v in mod_j.get_params()[0].items():
        np.testing.assert_allclose(mod_t.get_params()[0][k].asnumpy(),
                                   v.asnumpy(), rtol=1e-6, atol=1e-7)


VOCAB, EMBED, BPTT, BATCH = 17, 8, 6, 4


def _lm_trainer(pkg, seed=0):
    """A small LSTM LM (embedding, 2-layer LSTM, decoder) after one
    SGD-momentum Trainer step: (trainer, params)."""
    gluon = pkg.gluon
    r = np.random.RandomState(seed)
    with (NameManager() if pkg is mt else JNameManager()):
        emb = gluon.nn.Embedding(VOCAB, EMBED)
        rnn = gluon.rnn.LSTM(EMBED, num_layers=2, input_size=EMBED)
        head = gluon.nn.Dense(VOCAB, flatten=False, in_units=EMBED)
    params = {}
    for b in (emb, rnn, head):
        b.initialize(ctx=pkg.cpu())
        params.update(b.collect_params().items())
    for k, p in sorted(params.items()):
        value = r.uniform(-0.1, 0.1, p.shape).astype(np.float32)
        if pkg is mt:
            p.set_data(mt.nd.array(value, ctx=mt.cpu()))
        else:
            p._load_init(mj.nd.array(value, ctx=mj.cpu()), mj.cpu())
    x = pkg.nd.array(r.randint(0, VOCAB, (BPTT, BATCH)).astype(np.float32),
                     ctx=pkg.cpu())
    y = pkg.nd.array(r.randint(0, VOCAB, (BPTT, BATCH)).astype(np.float32),
                     ctx=pkg.cpu())
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 1.0,
                                            "momentum": 0.9})
    with pkg.autograd.record():
        out = rnn(emb(x))
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            head(out).reshape((-3, -1)), y.reshape((-1,)))
    loss.backward()
    trainer.step(BATCH)
    return trainer, params


def test_port_reads_a_jax_trainer_save_states_file(tmp_path):
    """``Trainer.save_states`` of the JAX package (its Updater's states
    and the pickled SGD) loads into the port's Trainer: every momentum
    bit for bit, the optimizer's settings and counts kept, its Parameters
    reattached."""
    trainer_j, params_j = _lm_trainer(mj)
    fname = str(tmp_path / "lm.states")
    trainer_j.save_states(fname)
    trainer_t, params_t = _lm_trainer(mt, seed=1)
    trainer_t.load_states(fname)
    opt_t, opt_j = trainer_t._optimizer, trainer_j._optimizer
    assert type(opt_t) is mt.optimizer.SGD
    assert (opt_t.lr, opt_t.momentum, opt_t.num_update) == \
        (opt_j.lr, opt_j.momentum, opt_j.num_update)
    assert opt_t._index_update_count == opt_j._index_update_count
    assert sorted(opt_t.param_dict) == sorted(opt_j.param_dict)
    assert all(isinstance(p, mt.gluon.Parameter)
               for p in opt_t.param_dict.values())
    states_j = trainer_j._updaters[0].states
    states_t = trainer_t._updaters[0].states
    assert sorted(states_t) == sorted(states_j) and len(states_t) == 11
    for idx, st in states_j.items():
        np.testing.assert_array_equal(states_t[idx].asnumpy(), st.asnumpy())


def test_module_load_resumes_with_optimizer_states(tmp_path):
    """``module_checkpoint(..., save_optimizer_states=True)`` at the end of
    epoch 1, then ``Module.load(prefix, 1, load_optimizer_states=True)``
    and ``fit(begin_epoch=1, num_epoch=2)``: the resumed module starts
    from the saved masters and momentum bit for bit and ends where the
    uninterrupted 2-epoch run ends, bit for bit (the same arithmetic on
    the host)."""
    prefix = str(tmp_path / "mlp")
    full, it = _bf16_mlp(mt)
    sym = full.symbol
    arg0 = {k: v.copyto(mt.cpu()) for k, v in full.get_params()[0].items()}
    opt = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}
    saved = {}
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.fit(it, num_epoch=2, arg_params=arg0, optimizer_params=opt,
            epoch_end_callback=[
                mt.callback.module_checkpoint(mod, prefix,
                                              save_optimizer_states=True),
                lambda epoch, *_: saved.update(_states(mod))
                if epoch == 0 else None])
    end = _states(mod)
    resumed = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=mt.cpu())
    it.reset()
    resumed.bind(it.provide_data, it.provide_label)
    resumed.init_optimizer(optimizer_params=opt)
    loaded = _states(resumed)
    for k in saved:
        np.testing.assert_array_equal(loaded[k][0], saved[k][0])
        np.testing.assert_array_equal(loaded[k][1], saved[k][1])
    resumed.fit(it, begin_epoch=1, num_epoch=2, optimizer_params=opt)
    for k, (master, mom) in _states(resumed).items():
        np.testing.assert_array_equal(master, end[k][0], err_msg=k)
        np.testing.assert_array_equal(mom, end[k][1], err_msg=k)
