"""The port's PipelineModule against the JAX package's.

The JAX side builds its meshes from the harness's 8 virtual CPU devices
(``jax.devices("cpu")``), the port from ``[mx.cpu()] * n`` positions.
Both get the same numpy inputs from seeds, and the port starts from the
JAX module's initial parameters.  Tolerances: each step's loss,
outputs and parameters within 1e-5 (absolute, f32 on both sides, sums
in other orders) of the JAX module's.  Against the flattened sequential
Module (the oracle of ``tests/test_pipeline_module.py``) the JAX test's
own rtol=2e-4, atol=2e-5.
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.parallel import MeshSpec as JMeshSpec
from mxnet_tpu.parallel import create_mesh as jcreate_mesh
from mxnet_tpu_torch import convert

D, CLASSES, BATCH, STAGES = 8, 4, 16, 2
LR, MOM = 0.2, 0.9
TOL = 1e-5


def jmesh(**sizes):
    spec = JMeshSpec(**sizes)
    return jcreate_mesh(spec, devices=jax.devices("cpu")[:spec.n_devices])


def tmesh(**sizes):
    spec = mx.parallel.MeshSpec(**sizes)
    return mx.parallel.create_mesh(spec, devices=[mx.cpu()] * spec.n_devices)


def _apply_body(m, x, prefix):
    h = m.sym.FullyConnected(x, num_hidden=D, name=prefix + "ffn1")
    h = m.sym.Activation(h, act_type="relu")
    h = m.sym.FullyConnected(h, num_hidden=D, name=prefix + "ffn2")
    return x + h


def _head(m, x):
    out = m.sym.FullyConnected(x, num_hidden=CLASSES, name="out")
    return m.sym.SoftmaxOutput(out, name="softmax")


def _problem(rng, n=BATCH):
    X = rng.standard_normal((n, D)).astype(np.float32)
    W = rng.standard_normal((D, CLASSES)).astype(np.float32)
    y = (X @ W).argmax(1).astype(np.float32)
    return X, y


def _pipeline_module(m, mesh, n_micro=None, n_stages=STAGES):
    body = _apply_body(m, m.sym.var("x"), "")
    head = _head(m, m.sym.var("x"))
    return m.mod.PipelineModule(body, n_stages=n_stages, head=head,
                                mesh=mesh, n_micro=n_micro)


def _tbatch(x, y=None):
    return mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                           None if y is None
                           else [mx.nd.array(y, ctx=mx.cpu())])


def _jbatch(x, y=None):
    return jmx.io.DataBatch([jmx.nd.array(x)],
                            None if y is None else [jmx.nd.array(y)])


def _pair(factory, data_shape, label_shape, opt, seed=0, sizes=None):
    """A JAX and a port PipelineModule from ``factory(pkg, mesh)``, bound
    alike, the port's parameters the JAX module's Xavier draw."""
    sizes = sizes or dict(dp=2, pp=2)
    jm = factory(jmx, jmesh(**sizes))
    tm = factory(mx, tmesh(**sizes))
    for m in (jm, tm):
        m.bind(data_shapes=[("data", data_shape)],
               label_shapes=[("softmax_label", label_shape)])
    np.random.seed(seed)
    jm.init_params(jmx.initializer.Xavier())
    tm.init_params(initializer=None, arg_params={
        k: mx.nd.array(v.asnumpy(), ctx=mx.cpu())
        for k, v in jm.get_params()[0].items()})
    for m in (jm, tm):
        m.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
    return jm, tm


def _assert_params_close(jm, tm, what):
    j, t = jm.get_params()[0], tm.get_params()[0]
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(t[k].asnumpy(), j[k].asnumpy(), rtol=0,
                                   atol=TOL, err_msg="%s %s" % (what, k))


def _lockstep(jm, tm, batches):
    for i, (x, y) in enumerate(batches):
        jm.forward_backward(_jbatch(x, y))
        tm.forward_backward(_tbatch(x, y))
        assert abs(tm.loss - jm.loss) < TOL, (i, tm.loss, jm.loss)
        np.testing.assert_allclose(tm.get_outputs()[0].asnumpy(),
                                   jm.get_outputs()[0].asnumpy(), rtol=0,
                                   atol=TOL, err_msg="outputs, step %d" % i)
        _assert_params_close(jm, tm, "step %d" % i)


# -- ports of tests/test_pipeline_module.py ---------------------------------

def test_pp_training_matches_sequential_module():
    rng = np.random.RandomState(0)
    X, y = _problem(rng)
    jm, pm = _pair(_pipeline_module, (BATCH, D), (BATCH,),
                   {"learning_rate": LR, "momentum": MOM})
    start_params, _ = pm.get_params()

    # sequential oracle: the SAME graph flattened, seeded with the SAME
    # per-stage parameters, trained by the ordinary single-device Module
    net = mx.sym.var("data")
    for s in range(STAGES):
        net = _apply_body(mx, net, "stage%d_" % s)
    net = _head(mx, net)
    ref = mx.mod.Module(net, context=mx.cpu())
    ref.bind(data_shapes=[("data", (BATCH, D))],
             label_shapes=[("softmax_label", (BATCH,))])
    ref.init_params(initializer=None, arg_params=start_params,
                    aux_params={}, allow_missing=False)
    ref.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": LR,
                                         "momentum": MOM,
                                         "rescale_grad": 1.0 / BATCH})
    losses = []
    for step in range(6):
        jm.forward_backward(_jbatch(X, y))
        pm.forward_backward(_tbatch(X, y))
        pm.update()
        losses.append(pm.loss)
        assert abs(pm.loss - jm.loss) < TOL, (step, pm.loss, jm.loss)
        _assert_params_close(jm, pm, "step %d" % step)
        ref.forward_backward(_tbatch(X, y))
        ref.update()

    pp_params, _ = pm.get_params()
    ref_params, _ = ref.get_params()
    assert set(pp_params) == set(ref_params)
    for n in sorted(ref_params):
        np.testing.assert_allclose(
            pp_params[n].asnumpy(), ref_params[n].asnumpy(),
            rtol=2e-4, atol=2e-5, err_msg=n)
    assert losses[-1] < losses[0], losses
    # a step's collectives: 3 ticks of stage-to-stage permutes, the
    # last stage's outputs broadcast over pp
    assert pm.collectives["collective-permute"] == 3
    assert pm.collectives["all-reduce"] == 1


def test_pp_forward_matches_and_scores():
    rng = np.random.RandomState(1)
    X, y = _problem(rng)
    jm, pm = _pair(_pipeline_module, (BATCH, D), (BATCH,),
                   {"learning_rate": 0.2, "momentum": 0.9}, seed=1)
    _lockstep(jm, pm, [(X, y)] * 3)
    for _ in range(117):
        pm.forward_backward(_tbatch(X, y))
    pm.forward(_tbatch(X, y))
    metric = mx.metric.Accuracy()
    pm.update_metric(metric, [mx.nd.array(y, ctx=mx.cpu())])
    acc = dict([metric.get()])["accuracy"]
    assert acc > 0.9, acc


def test_pp_requires_stateless_stages():
    for m, mesh in ((mx, tmesh(pp=2)), (jmx, jmesh(pp=2))):
        x = m.sym.var("x")
        bn = m.sym.BatchNorm(m.sym.FullyConnected(x, num_hidden=D,
                                                  name="f"), name="bn")
        with pytest.raises(m.base.MXNetError, match="stateless"):
            m.mod.PipelineModule(bn + x, n_stages=2,
                                 head=_head(m, m.sym.var("x")), mesh=mesh)


def test_virtual_stages_more_stages_than_pp():
    """n_stages=4 on pp=2: two virtual stages per position."""
    rng = np.random.RandomState(2)
    X, y = _problem(rng)
    jm, pm = _pair(lambda m, mesh: _pipeline_module(m, mesh, n_stages=4),
                   (BATCH, D), (BATCH,), {"learning_rate": 0.2}, seed=2)
    _lockstep(jm, pm, [(X, y)] * 2)
    first = pm.loss
    for _ in range(3):
        pm.forward_backward(_tbatch(X, y))
    assert np.isfinite(pm.loss) and pm.loss < first
    args, _ = pm.get_params()
    assert "stage3_ffn1_weight" in args


def test_force_rebind_preserves_params_resets_compiled():
    """Rebind at a new batch size: the step (with its rescale_grad and
    microbatch split) is dropped, trained params carried across, eval
    possible without a new optimizer."""
    rng = np.random.RandomState(4)
    X, y = _problem(rng)
    jm, pm = _pair(_pipeline_module, (BATCH, D), (BATCH,),
                   {"learning_rate": 0.2, "momentum": 0.9}, seed=4)
    _lockstep(jm, pm, [(X, y)] * 2)
    for _ in range(78):
        pm.forward_backward(_tbatch(X, y))
    tr_acc = (pm.get_outputs()[0].asnumpy().argmax(1) == y).mean()
    assert tr_acc > 0.9, tr_acc
    w_before = pm.get_params()[0]["stage0_ffn1_weight"].asnumpy()

    half = BATCH // 2
    pm.bind(data_shapes=[("data", (half, D))],
            label_shapes=[("softmax_label", (half,))], force_rebind=True)
    assert pm._step is None and pm._fwd is None
    assert not pm.optimizer_initialized and pm.params_initialized
    np.testing.assert_allclose(
        pm.get_params()[0]["stage0_ffn1_weight"].asnumpy(), w_before)
    pm.forward(_tbatch(X[:half], y[:half]))
    metric = mx.metric.Accuracy()
    pm.update_metric(metric, [mx.nd.array(y[:half], ctx=mx.cpu())])
    assert metric.get()[1] > 0.9, metric.get()


def test_init_params_missing_name_raises():
    for m in (mx, jmx):
        pm = _pipeline_module(m, tmesh(dp=2, pp=2) if m is mx
                              else jmesh(dp=2, pp=2))
        pm.bind(data_shapes=[("data", (BATCH, D))],
                label_shapes=[("softmax_label", (BATCH,))])
        with pytest.raises(m.base.MXNetError, match="is not presented"):
            pm.init_params(initializer=None,
                           arg_params={"stage0_ffn1_weight": m.nd.array(
                               np.zeros((D, D), np.float32), ctx=m.cpu())})


def test_labelless_forward_and_odd_batch_divisor():
    """predict-style forward with no labels; and a batch (6) that
    divides dp but not the naive 2*dp microbatch count."""
    rng = np.random.RandomState(6)
    jm, pm = _pair(_pipeline_module, (6, D), (6,), {"learning_rate": 0.2},
                   seed=6)
    assert pm._n_micro == jm._n_micro and 6 % pm._n_micro == 0
    X = rng.standard_normal((6, D)).astype(np.float32)
    pm.forward(_tbatch(X))
    jm.forward(_jbatch(X))
    out = pm.get_outputs()[0].asnumpy()
    assert out.shape == (6, CLASSES)
    assert np.allclose(out.sum(1), 1.0, atol=1e-4)
    np.testing.assert_allclose(out, jm.get_outputs()[0].asnumpy(), rtol=0,
                               atol=TOL)


def test_labelless_bind_predict_flow():
    """bind WITHOUT label_shapes (the predict workflow): the head's
    label shape is inferred from the graph and zero-filled at feed."""
    rng = np.random.RandomState(8)
    pm = _pipeline_module(mx, tmesh(dp=2, pp=2))
    pm.bind(data_shapes=[("data", (8, D))], for_training=False)
    assert [tuple(d.shape) for d in pm.label_shapes] == [(8,)]
    pm.init_params(mx.initializer.Xavier())
    X = rng.standard_normal((8, D)).astype(np.float32)
    pm.forward(_tbatch(X))
    out = pm.get_outputs()[0].asnumpy()
    assert out.shape == (8, CLASSES)
    assert np.allclose(out.sum(1), 1.0, atol=1e-4)


# -- the module's contracts and a transformer body --------------------------

def test_contract_errors():
    body = _apply_body(mx, mx.sym.var("x"), "")
    head = _head(mx, mx.sym.var("x"))
    with pytest.raises(mx.MXNetError, match="must divide over pp=2"):
        mx.mod.PipelineModule(body, 3, head, mesh=tmesh(pp=2))
    narrow = mx.sym.FullyConnected(mx.sym.var("x"), num_hidden=3, name="n")
    pm = mx.mod.PipelineModule(narrow, 2, head, mesh=tmesh(pp=2))
    with pytest.raises(mx.MXNetError, match="body must preserve shape"):
        pm.bind(data_shapes=[("data", (8, D))],
                label_shapes=[("softmax_label", (8,))])
    noisy = mx.sym.Dropout(body, p=0.5)
    pm = mx.mod.PipelineModule(noisy, 2, head, mesh=tmesh(pp=2))
    with pytest.raises(mx.MXNetError, match="rng ops"):
        pm.bind(data_shapes=[("data", (8, D))],
                label_shapes=[("softmax_label", (8,))])
    pm = mx.mod.PipelineModule(body, 2, head, mesh=tmesh(dp=2, pp=2))
    with pytest.raises(mx.MXNetError, match="does not divide over dp=2"):
        pm.bind(data_shapes=[("data", (7, D))],
                label_shapes=[("softmax_label", (7,))])
    with pytest.raises(mx.MXNetError, match="not divisible by n_micro"):
        mx.mod.PipelineModule(body, 2, head, mesh=tmesh(dp=2, pp=2),
                              n_micro=3).bind(
            data_shapes=[("data", (8, D))],
            label_shapes=[("softmax_label", (8,))])
    pm.bind(data_shapes=[("data", (8, D))],
            label_shapes=[("softmax_label", (8,))])
    pm.init_params(mx.initializer.Xavier())
    with pytest.raises(mx.MXNetError, match="sgd"):
        pm.init_optimizer(optimizer="adam")
    with pytest.raises(mx.MXNetError, match="fuses backward"):
        pm.backward()


SEQ, VOCAB, WIDTH, HEADS = 8, 12, 16, 2


def _gpt_parts(m):
    """A GPT-2 shaped model at test widths: token embedding plus learned
    positions; one pre-LN block as ``transformer_lm_symbol`` writes it;
    final LN, a vocab projection and a per-token SoftmaxOutput."""
    S = m.sym
    data = S.var("data")
    stem = S.broadcast_add(
        S.Embedding(data, input_dim=VOCAB, output_dim=WIDTH, name="embed"),
        S.expand_dims(S.var("pos_weight", shape=(SEQ, WIDTH)), axis=0))
    x = S.var("x")
    h = S.LayerNorm(x, axis=-1, eps=1e-5, name="ln1")
    h = x + S.multi_head_attention(h, h, h, num_heads=HEADS, causal=True,
                                   name="attn")
    f = S.LayerNorm(h, axis=-1, eps=1e-5, name="ln2")
    f = S.FullyConnected(f, num_hidden=4 * WIDTH, flatten=False, name="ffn1")
    f = S.LeakyReLU(f, act_type="gelu")
    body = h + S.FullyConnected(f, num_hidden=WIDTH, flatten=False,
                                name="ffn2")
    y = S.LayerNorm(S.var("x"), axis=-1, eps=1e-5, name="lnf")
    y = S.FullyConnected(y, num_hidden=VOCAB, flatten=False, name="vocab")
    head = S.SoftmaxOutput(y, preserve_shape=True, name="softmax")
    return stem, body, head


def test_transformer_blocks_through_the_pipeline():
    """4 GPT-2 shaped blocks on a dp=2, pp=2 mesh with a stem and a
    per-token head: 3 steps within TOL of the JAX PipelineModule."""
    rng = np.random.RandomState(9)
    X = rng.randint(0, VOCAB, (4, SEQ)).astype(np.float32)
    Y = rng.randint(0, VOCAB, (4, SEQ)).astype(np.float32)

    def factory(m, mesh):
        stem, body, head = _gpt_parts(m)
        return m.mod.PipelineModule(body, 4, head, stem=stem, mesh=mesh)
    jm, pm = _pair(factory, (4, SEQ), (4, SEQ),
                   {"learning_rate": 0.05, "momentum": 0.9}, seed=9)
    with jax.default_matmul_precision("highest"):
        _lockstep(jm, pm, [(X, Y)] * 3)
    assert pm.get_outputs()[0].shape == (4, SEQ, VOCAB)


def test_set_mesh_module_state_from_a_jax_pipeline_module():
    """convert.set_mesh_module_state carries a trained JAX
    PipelineModule's stacked stage parameters and momentum: the next
    steps agree within TOL."""
    rng = np.random.RandomState(10)
    X, y = _problem(rng)
    jm, pm = _pair(_pipeline_module, (BATCH, D), (BATCH,),
                   {"learning_rate": LR, "momentum": MOM}, seed=10)
    for _ in range(3):
        jm.forward_backward(_jbatch(X, y))
    convert.set_mesh_module_state(
        pm, {k: np.asarray(v) for k, v in jm._params.items()},
        momentum={k: np.asarray(v) for k, v in jm._mom.items()})
    _assert_params_close(jm, pm, "carried")
    _lockstep(jm, pm, [(X, y)] * 2)


def test_preserve_shape_softmax_output_binds_per_token_labels():
    """``SoftmaxOutput(preserve_shape=True)`` over (batch, seq, vocab)
    takes (batch, seq) labels, one a position, as MXNet 1.0 infers them
    (data.shape[:-1]) and as its backward reads them, so a plain Module
    binds the flattened per-token head the pipeline's oracle needs.  The
    JAX package infers (batch,) and cannot bind it.  The logits' gradient
    is p - onehot, exactly."""
    rng = np.random.RandomState(12)
    x = rng.standard_normal((4, SEQ, VOCAB)).astype(np.float32)
    y = rng.randint(0, VOCAB, (4, SEQ)).astype(np.float32)
    sym = mx.sym.SoftmaxOutput(mx.sym.var("data"), preserve_shape=True,
                               name="softmax")
    arg_shapes, _, _ = sym.infer_shape(data=x.shape)
    assert arg_shapes == [x.shape, (4, SEQ)]
    jargs, _, _ = jmx.sym.SoftmaxOutput(
        jmx.sym.var("data"), preserve_shape=True).infer_shape(data=x.shape)
    assert tuple(jargs[1]) == (4,)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)],
             inputs_need_grad=True)
    mod.init_params()
    mod.forward_backward(_tbatch(x, y))
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    onehot = np.eye(VOCAB, dtype=np.float32)[y.astype(np.int64)]
    np.testing.assert_allclose(mod.get_input_grads()[0].asnumpy(),
                               mod.get_outputs()[0].asnumpy() - onehot,
                               rtol=0, atol=0)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), p,
                               rtol=1e-5, atol=1e-6)
