"""The port's random sampling against the JAX package's, on the host.

The two packages draw different bits (the port from its own per-device
``torch.Generator``, the JAX package from its PRNG keys), so the draws
are held to each other and to the distributions by their statistics:

- every one of the 37 op names (17 canonical ops and their aliases) is
  registered, and gives the JAX package's shape, dtype and support;
- sample mean and variance within 6 standard errors of the analytic
  values at 10^5 draws, in both packages (the variance's standard error
  from the sample's fourth central moment);
- a two-sample Kolmogorov-Smirnov test of the port's draws against the
  JAX package's at p 1e-4, for the continuous samplers;
- multinomial frequencies by a chi-square test at p 1e-4, and
  ``get_prob`` equal to ``log p[idx]`` exactly;
- the same ``mx.random.seed`` gives the same bits, another seed others,
  and ``torch.manual_seed`` changes nothing;
- the reparameterized gradients are the JAX package's functions of each
  package's own draw (within 1e-4 relative).

These gates are statistical: with fixed seeds they are deterministic,
and a distribution whose mean or variance is off by less than ~6
standard errors (about 2% of sigma for the mean at 10^5 draws) passes
(PERF.md section 2).  Also here: ROADMAP C8 (``mx.random.seed`` seeds
numpy's global generator, so ``NDArrayIter``, ``gluon.data.
RandomSampler`` and ``BucketSentenceIter`` shuffle exactly as in the JAX
package, whatever numpy's state was before), random nodes inside bound
graphs and the fused train step, and the reference's own random cases
(``tests/test_operator.py``, ``tests/test_namespaces.py``) on the port.
"""
import random

import numpy as np
import pytest
import torch
from scipy import stats

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import get_op as jax_op, op_registry as jax_ops

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.module.fused_step import FusedTrainStep
from mxnet_tpu_torch.ops.registry import get_op as port_op, op_registry

from random_cases import P_MIN, PROBS, SPECS, call, moments, rows_of, \
    support_ok

PKGS = (jmx, mx)
N_DRAWS = 100000
GRAD_REL = 1e-4
RANDOM_NAMES = sorted(n for n, op in jax_ops().items()
                      if op.impl.__module__ == "mxnet_tpu.ops.random_ops")


def _call(pkg, name, shape, dtype=None):
    return call(pkg, name, shape, pkg.cpu(), dtype=dtype)


def test_the_37_names_are_the_references():
    assert len(RANDOM_NAMES) == 37
    assert len({port_op(n).name for n in RANDOM_NAMES}) == 17
    for name in RANDOM_NAMES:
        assert port_op(name).name == jax_op(name).name
        assert set(port_op(name).params) == set(jax_op(name).params), name
        assert port_op(name).needs_rng


def test_needs_rng_flags_match_the_reference():
    """Every op that draws says so (the fused step reads the flag)."""
    both = set(op_registry()) & set(jax_ops())
    diff = sorted(n for n in both
                  if port_op(n).needs_rng != jax_op(n).needs_rng)
    assert diff == []
    assert port_op("Dropout").needs_rng and port_op("RNN").needs_rng


@pytest.mark.parametrize("name", RANDOM_NAMES)
def test_name_gives_the_references_shape_dtype_support(name):
    canonical = port_op(name).name
    jmx.random.seed(1)
    mx.random.seed(1)
    shape = (3, 4) if canonical.startswith("_random") else (5,)
    want = _call(jmx, name, shape)
    got = _call(mx, name, shape)
    assert got.context == mx.cpu()
    assert got.shape == want.shape
    assert np.dtype(got.dtype) == np.dtype(want.dtype)
    assert support_ok(canonical, got.asnumpy())
    assert support_ok(canonical, want.asnumpy())


DTYPE_CASES = [(c, d) for c in sorted(SPECS) for d in
               ("float16", "float64")]


@pytest.mark.parametrize("canonical,dtype", DTYPE_CASES,
                         ids=["%s-%s" % c for c in DTYPE_CASES])
def test_dtype_follows_the_reference(canonical, dtype):
    if canonical == "_random_randint":
        dtype = {"float16": "int64", "float64": "int32"}[dtype]
    want = _call(jmx, canonical, (4,), dtype=dtype)
    got = _call(mx, canonical, (4,), dtype=dtype)
    assert got.shape == want.shape
    assert np.dtype(got.dtype) == np.dtype(want.dtype)
    assert support_ok(canonical, got.asnumpy().astype(np.float64))


def _rows(pkg, canonical, seed):
    pkg.random.seed(seed)
    spec = SPECS[canonical][0]
    per_row = N_DRAWS // (1 if "attrs" in spec else len(spec["mean"]))
    rows = rows_of(_call(pkg, canonical, (per_row,)).asnumpy(), spec)
    means = [spec["mean"]] if "attrs" in spec else spec["mean"]
    variances = [spec["var"]] if "attrs" in spec else spec["var"]
    return rows, means, variances


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
@pytest.mark.parametrize("canonical", sorted(SPECS))
def test_moments(canonical, pkg):
    rows, means, variances = _rows(pkg, canonical, 3)
    for x, mu, var in zip(rows, means, variances):
        ok, z_mean, z_var = moments(x, mu, var)
        assert ok, (z_mean, z_var)


@pytest.mark.parametrize("canonical", sorted(
    c for c, s in SPECS.items() if s[0].get("continuous")))
def test_ks_against_the_reference(canonical):
    rows_j, _, _ = _rows(jmx, canonical, 4)
    rows_t, _, _ = _rows(mx, canonical, 4)
    for a, b in zip(rows_j, rows_t):
        assert stats.ks_2samp(a, b).pvalue > P_MIN


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_multinomial_frequencies_and_get_prob(pkg):
    pkg.random.seed(5)
    data = pkg.nd.array(PROBS, ctx=pkg.cpu())
    idx, prob = pkg.nd.random.multinomial(data, shape=N_DRAWS // 2,
                                          get_prob=True)
    idx = idx.asnumpy()
    assert idx.shape == (2, N_DRAWS // 2) and np.dtype(idx.dtype) == np.int32
    for row, p in zip(idx, PROBS):
        counts = np.bincount(row, minlength=len(p))
        expected = p.astype(np.float64) / p.astype(np.float64).sum()
        assert stats.chisquare(counts, expected * row.size).pvalue > P_MIN
    logp = pkg.nd.log(data)  # no probability is below the 1e-37 clamp
    picked = np.take_along_axis(logp.asnumpy(), idx, axis=1)
    np.testing.assert_array_equal(prob.asnumpy(), picked)
    assert np.dtype(prob.dtype) == np.float32
    one = pkg.nd.random.multinomial(data).asnumpy()
    assert one.shape == (2,)


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_shuffle_is_a_row_permutation_with_a_gradient(pkg):
    pkg.random.seed(6)
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    data = pkg.nd.array(x, ctx=pkg.cpu())
    data.attach_grad()
    with pkg.autograd.record():
        out = pkg.nd.random.shuffle(data)
        loss = (out * pkg.nd.array(np.arange(40, dtype=np.float32).reshape(
            20, 2), ctx=pkg.cpu())).sum()
    loss.backward()
    got = out.asnumpy()
    assert sorted(map(tuple, got)) == sorted(map(tuple, x))
    assert not np.array_equal(got, x)
    # each source row receives the weight of the position it moved to
    perm = (got[:, 0] // 2).astype(int)
    want = np.zeros_like(x)
    want[perm] = np.arange(40, dtype=np.float32).reshape(20, 2)
    np.testing.assert_array_equal(data.grad.asnumpy(), want)


@pytest.mark.parametrize("canonical", sorted(SPECS) + [
    "_sample_multinomial", "_shuffle"])
def test_seed_reproduces_and_torch_seed_changes_nothing(canonical):
    def draw(seed, torch_seed=None):
        mx.random.seed(seed)
        if torch_seed is not None:
            torch.manual_seed(torch_seed)
        return _call(mx, canonical, (64,)).asnumpy()

    a = draw(5)
    np.testing.assert_array_equal(draw(5), a)
    np.testing.assert_array_equal(draw(5, torch_seed=1234), a)
    assert not np.array_equal(draw(6), a)


def _grad_case(pkg, sampler, params):
    arrays = [pkg.nd.array(np.asarray(p, np.float32), ctx=pkg.cpu())
              for p in params]
    for a in arrays:
        a.attach_grad()
    pkg.random.seed(8)
    with pkg.autograd.record():
        out = sampler(pkg)(*arrays, shape=(1000,))
    out.backward()
    return out.asnumpy().astype(np.float64), [
        a.grad.asnumpy().astype(np.float64) for a in arrays]


GRAD_CASES = {
    "normal": (lambda pkg: pkg.nd.random.normal, [[0.0, 3.0], [1.0, 0.5]],
               lambda out, p: [np.ones_like(out),
                               (out - p[0][:, None]) / p[1][:, None]]),
    "uniform": (lambda pkg: pkg.nd.random.uniform, [[0.0, -2.0], [1.0, 2.0]],
                lambda out, p: [1 - (out - p[0][:, None])
                                / (p[1] - p[0])[:, None],
                                (out - p[0][:, None])
                                / (p[1] - p[0])[:, None]]),
    "exponential": (lambda pkg: pkg.nd.sample_exponential, [[1.0, 4.0]],
                    lambda out, p: [-out / p[0][:, None]]),
    "gamma-beta": (lambda pkg: pkg.nd.sample_gamma, [[1.0, 8.0], [1.0, 2.0]],
                   lambda out, p: [None, out / p[1][:, None]]),
    "poisson": (lambda pkg: pkg.nd.sample_poisson, [[2.0, 10.0]],
                lambda out, p: [np.zeros_like(out)]),
}


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_reparameterized_gradients(case, pkg):
    """Under ``autograd.record()``, each package's gradient is the same
    function of its own draw: d out/d mu = 1, d out/d sigma = (out -
    mu)/sigma, and so on; none for a count."""
    sampler, params, rule = GRAD_CASES[case]
    out, grads = _grad_case(pkg, sampler, params)
    p = [np.asarray(v, np.float64) for v in params]
    for got, per_draw in zip(grads, rule(out, p)):
        if per_draw is None:
            assert np.isfinite(got).all() and (got != 0).all()
            continue
        np.testing.assert_allclose(got, per_draw.sum(axis=1),
                                   rtol=GRAD_REL, atol=GRAD_REL)


# -- random nodes in graphs -----------------------------------------------

def test_zero_input_node_draws_on_the_executors_device():
    """A ``_random_*`` node's ``ctx`` attr is ignored in a bound graph, as
    in the JAX package: the node draws on the executor's device (a
    ``gpu(0)`` attr would raise on a host without a card)."""
    for pkg in PKGS:
        noise = pkg.sym.random.uniform(low=2.0, high=3.0, shape=(3, 4),
                                       ctx="gpu(0)")
        ex = (noise + pkg.sym.var("x")).bind(
            pkg.cpu(), args={"x": pkg.nd.zeros((3, 4), ctx=pkg.cpu())})
        out = ex.forward()[0]
        assert out.context == pkg.cpu()
        v = out.asnumpy()
        assert v.shape == (3, 4) and v.min() >= 2.0 and v.max() < 3.0
    lone = mx.sym.random.normal(shape=(2, 2)).bind(mx.cpu(), args={})
    assert lone.forward()[0].shape == (2, 2)


def test_random_symbols_round_trip_json_with_the_reference():
    syms = {}
    for pkg in PKGS:
        with pkg.sym.NameManager():
            mu = pkg.sym.var("mu")
            s = pkg.sym.random.normal(mu, pkg.sym.var("sigma"), shape=(3,)) \
                + pkg.sym.random.uniform(shape=(2, 3)) \
                + pkg.sym.random.shuffle(pkg.sym.var("x"))
            syms[pkg] = s
    assert mx.sym.load_json(syms[jmx].tojson()).tojson() == \
        syms[mx].tojson()
    args, outs, _ = syms[mx].infer_shape(mu=(2,), sigma=(2,), x=(2, 3))
    assert outs == [(2, 3)]


def _noisy_module(pkg, fused, seed=0, batch=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(64, 12).astype(np.float32)
    y = (x @ rng.randn(12, 4)).argmax(1).astype(np.float32)
    data = pkg.sym.Variable("data")
    noisy = data + pkg.sym.random.normal(0.0, 0.5, shape=(batch, 12))
    net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        noisy, num_hidden=4, name="fc"), name="softmax")
    it = pkg.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={
        "fc_weight": pkg.nd.array(rng.uniform(-0.1, 0.1, (4, 12)).astype(
            np.float32), ctx=pkg.cpu()),
        "fc_bias": pkg.nd.zeros((4,), ctx=pkg.cpu())})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    if not fused:
        mod._fused_step = None
    return mod, it


def test_fused_step_with_a_random_node_draws_fresh_and_equals_eager():
    """A graph that adds ``mx.sym.random.normal`` noise to its input
    trains on the fused step; each step draws anew; from the same
    generator state the fused steps equal the eager general path within
    1e-6 (two epochs of 4 batches)."""
    runs = {}
    for fused in (True, False):
        mod, it = _noisy_module(mx, fused)
        assert (mod._fused_step is not None) == fused
        mx.random.seed(21)
        outs = []
        for _ in range(2):
            it.reset()
            for batch in it:
                mod.forward_backward(batch)
                mod.update()
                outs.append(mod.get_outputs()[0].asnumpy())
        if fused:
            assert mod._fused_step is not None and mod._fused_step.ran
        runs[fused] = outs, {k: v.asnumpy()
                             for k, v in mod.get_params()[0].items()}
    (fo, fp), (eo, ep) = runs[True], runs[False]
    for a, b in zip(fo, eo):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for k in fp:
        np.testing.assert_allclose(fp[k], ep[k], rtol=1e-6, atol=1e-6)
    # the same batch (epoch 1 and 2 of batch 0) saw different noise
    assert not np.allclose(fo[0], fo[4])


@pytest.mark.parametrize("sampler", ["uniform", "normal", "gamma",
                                     "poisson", "shuffle"])
def test_fused_refusal_sees_every_op_that_draws(sampler, monkeypatch):
    """On a card whose torch cannot register a generator with a CUDA
    graph, the fused step turns down a graph with any drawing op, not
    only Dropout and RNN."""
    mod, _ = _noisy_module(mx, True)
    data = mx.sym.Variable("data")
    noise = {"uniform": lambda: mx.sym.random.uniform(shape=(16, 12)),
             "normal": lambda: mx.sym.random.normal(
                 mx.sym.zeros((16, 12)), mx.sym.ones((16, 12))),
             "gamma": lambda: mx.sym.random.gamma(shape=(16, 12)),
             "poisson": lambda: mx.sym.random.poisson(shape=(16, 12)),
             "shuffle": lambda: mx.sym.random.shuffle(data)}[sampler]()
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data + noise, num_hidden=4, name="fc"), name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=[("data", (16, 12))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params()
    mod.init_optimizer(optimizer="sgd")
    assert FusedTrainStep.refusal(mod) is None
    monkeypatch.setattr(mod._exec_group.execs[0], "_device",
                        torch.device("cuda", 0))
    monkeypatch.delattr(torch.cuda.CUDAGraph, "register_generator_state",
                        raising=False)
    assert "draws random numbers" in FusedTrainStep.refusal(mod)


# -- C8: mx.random.seed seeds numpy's global generator ---------------------

@pytest.mark.parametrize("pre", [0, 123])
def test_c8_ndarray_iter_shuffles_as_the_reference(pre):
    orders = []
    for pkg in PKGS:
        np.random.seed(pre)
        pkg.random.seed(7)
        with pkg.cpu():
            it = pkg.io.NDArrayIter(np.arange(10, dtype=np.float32),
                                    batch_size=10, shuffle=True)
            orders.append(it.next().data[0].asnumpy().tolist())
    assert orders[1] == orders[0] == [8, 5, 0, 2, 1, 9, 7, 3, 6, 4]


@pytest.mark.parametrize("pre", [0, 123])
def test_c8_random_sampler_shuffles_as_the_reference(pre):
    orders = []
    for pkg in PKGS:
        np.random.seed(pre)
        pkg.random.seed(7)
        orders.append([int(i) for i in pkg.gluon.data.RandomSampler(12)])
    assert orders[1] == orders[0]


@pytest.mark.parametrize("pre", [0, 123])
def test_c8_bucket_sentence_iter_shuffles_as_the_reference(pre):
    rng = np.random.RandomState(9)
    sentences = [list(rng.randint(1, 50, rng.randint(2, 12)))
                 for _ in range(60)]
    batches = []
    for pkg in PKGS:
        random.seed(3)  # the iterator also shuffles with python's random
        np.random.seed(pre)
        pkg.random.seed(7)
        with pkg.cpu():
            it = pkg.rnn.BucketSentenceIter(sentences, 4, buckets=[6, 12],
                                            invalid_label=0)
            batches.append([(b.bucket_key, b.data[0].asnumpy().tolist())
                            for b in it])
    assert batches[1] == batches[0]


def test_mx_random_names_are_nd_randoms():
    for name in mx.nd.random.__all__:
        assert getattr(mx.random, name) is getattr(mx.nd.random, name)
        assert hasattr(mx.sym.random, name)
    with pytest.raises(AttributeError):
        mx.random.no_such_sampler


# -- the reference's own random cases, on the port --------------------------

def test_reference_random_ops():
    """``tests/test_operator.py::test_random_ops``."""
    with mx.cpu():
        mx.random.seed(42)
        a = mx.nd.random_uniform(low=0, high=1, shape=(1000,))
        assert 0.4 < a.asnumpy().mean() < 0.6
        mx.random.seed(42)
        b = mx.nd.random_uniform(low=0, high=1, shape=(1000,))
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy())
        n = mx.nd.random_normal(loc=2.0, scale=0.5, shape=(2000,))
        assert 1.8 < n.asnumpy().mean() < 2.2
        assert 0.3 < n.asnumpy().std() < 0.7


def test_reference_tensor_parameter_samplers():
    """``tests/test_operator.py::test_tensor_parameter_samplers``."""
    with mx.cpu():
        alpha = mx.nd.array([1.0, 8.0])
        beta = mx.nd.array([1.0, 2.0])
        g = mx.nd.random.gamma(alpha, beta, shape=(4000,))
        assert g.shape == (2, 4000)
        m = g.asnumpy().mean(axis=1)
        assert abs(m[0] - 1.0) < 0.2 and abs(m[1] - 16.0) < 2.0
        lam = mx.nd.array([2.0, 10.0])
        p = mx.nd.random.poisson(lam, shape=(4000,))
        mp = p.asnumpy().mean(axis=1)
        assert abs(mp[0] - 2.0) < 0.3 and abs(mp[1] - 10.0) < 0.7
        e = mx.nd.random.exponential(mx.nd.array([1.0, 4.0]), shape=(4000,))
        me = e.asnumpy().mean(axis=1)
        assert abs(me[0] - 1.0) < 0.2 and abs(me[1] - 4.0) < 0.6
        nb = mx.nd.random.negative_binomial(
            mx.nd.array([3.0]), mx.nd.array([0.4]), shape=(6000,))
        assert abs(nb.asnumpy().mean() - 4.5) < 0.6
        gnb = mx.nd.random.generalized_negative_binomial(
            mx.nd.array([5.0]), mx.nd.array([0.3]), shape=(6000,))
        assert abs(gnb.asnumpy().mean() - 5.0) < 0.7
        s = mx.nd.sample_gamma(alpha, beta)
        assert s.shape == (2,)
        sym = mx.sym.random.normal(mx.sym.Variable("mu"),
                                   mx.sym.Variable("sg"), shape=(8,))
        exe = sym.simple_bind(mx.cpu(), mu=(3,), sg=(3,))
        exe.arg_dict["mu"][:] = [0.0, 5.0, -5.0]
        exe.arg_dict["sg"][:] = [1.0, 1.0, 1.0]
        out = exe.forward()[0].asnumpy()
        assert out.shape == (3, 8)
        assert abs(out[1].mean() - 5.0) < 1.5 \
            and abs(out[2].mean() + 5.0) < 1.5


def test_reference_nd_random_namespace():
    """``tests/test_namespaces.py::test_nd_random_namespace``,
    ``test_mx_random_reexport`` and ``test_random_mixed_params_rejected``."""
    with mx.cpu():
        mx.random.seed(7)
        un = mx.nd.random.uniform(1.0, 2.0, shape=(50,)).asnumpy()
        assert un.min() >= 1.0 and un.max() < 2.0
        assert mx.nd.random.normal(0.0, 1.0, shape=(10, 10)).shape == (10, 10)
        nt = mx.nd.random.normal(mx.nd.zeros((3,)), mx.nd.ones((3,)),
                                 shape=(4,))
        assert nt.shape == (3, 4)
        rn = mx.nd.random.randint(0, 5, shape=(100,)).asnumpy()
        assert rn.min() >= 0 and rn.max() < 5
        assert mx.nd.random.poisson(3.0, shape=(8,)).shape == (8,)
        assert (mx.nd.random.exponential(2.0, shape=(8,)).asnumpy()
                >= 0).all()
        m = mx.nd.random.multinomial(mx.nd.array([[0.0, 1.0], [1.0, 0.0]]))
        assert list(m.asnumpy()) == [1, 0]
        s = mx.nd.random.shuffle(mx.nd.arange(10))
        assert sorted(s.asnumpy().tolist()) == list(range(10))
        mx.random.seed(3)
        a = mx.random.uniform(shape=(4,)).asnumpy()
        mx.random.seed(3)
        b = mx.random.uniform(shape=(4,)).asnumpy()
        np.testing.assert_allclose(a, b)
        with pytest.raises(ValueError):
            mx.nd.random.normal(mx.nd.zeros((3,)), 1.0)
        with pytest.raises(ValueError):
            mx.sym.random.uniform(mx.sym.var("lo"), 1.0)


def test_reference_sym_random_namespace():
    """The random part of ``tests/test_namespaces.py::
    test_sym_namespaces``, and ``mx.sym.arange``."""
    r = mx.sym.random.uniform(shape=(3, 3))
    exe = r.bind(mx.cpu(), {})
    assert exe.forward()[0].shape == (3, 3)
    a = mx.sym.arange(2, 11, step=3, repeat=2, name="ar")
    ja = jmx.sym.arange(2, 11, step=3, repeat=2, name="ar")
    assert a.tojson() == ja.tojson()
    out = a.bind(mx.cpu(), {}).forward()[0].asnumpy()
    np.testing.assert_array_equal(out, [2, 2, 5, 5, 8, 8])
