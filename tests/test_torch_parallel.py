"""The port's mesh layer (``mx.parallel``) against the JAX package's.

The JAX side builds its meshes from the harness's 8 virtual CPU devices
(``jax.devices("cpu")``), the port from ``[mx.cpu()] * n`` positions.
Both get the same numpy inputs from seeds.  Tolerances (f32 on both
sides, sums in other orders): ring attention rtol=atol=2e-5 (the JAX
package's own limit against its numpy oracle); ``moe_ffn`` 1e-5 and the
dropped tokens identical; ``pipeline_stages`` 2e-5; ``ShardedTrainStep``
losses and parameters 1e-5 relative per step (2-bit: the first step's
codes byte for byte, 10 steps' losses 1e-4).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import mxnet_tpu_torch as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import comm as jcomm
from mxnet_tpu.kvstore import gradient_compression as jgc
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel import comm as tcomm
from mxnet_tpu_torch.parallel import mesh as tmesh_mod

TP = tpar.P

_KNOBS = ("MXNET_TPU_COMM_BUCKET_MB", "MXNET_TPU_GRAD_COMPRESS",
          "MXNET_TPU_GRAD_COMPRESS_THRESHOLD")


@pytest.fixture(autouse=True)
def _clean_comm(monkeypatch):
    """Overlap off unless the test opts in; JAX products in full f32."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    with jax.default_matmul_precision("highest"):
        yield


def jmesh(**sizes):
    spec = jpar.MeshSpec(**sizes)
    return jpar.create_mesh(spec, devices=jax.devices("cpu")[:spec.n_devices])


def tmesh(**sizes):
    spec = tpar.MeshSpec(**sizes)
    return tpar.create_mesh(spec, devices=[mx.cpu()] * spec.n_devices)


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# -- mesh and spec rules ------------------------------------------------------

def test_create_mesh_shape_order_and_errors(monkeypatch):
    m = mx.parallel.create_mesh(dp=2, tp=2, devices=[mx.cpu()] * 4)
    j = jmesh(dp=2, tp=2)
    assert list(m.shape.items()) == list(j.shape.items())
    assert dict(m.shape) == dict(j.shape) and m.axis_names == j.axis_names
    assert m.devices.shape == j.devices.shape and m.size == 4
    assert tpar.AXIS_ORDER == jpar.mesh.AXIS_ORDER
    # no axis given: every position on dp
    assert dict(tpar.create_mesh(devices=[mx.cpu()] * 3).shape)["dp"] == 3
    with pytest.raises(ValueError, match="needs 4 devices, got 3"):
        tpar.create_mesh(dp=2, tp=2, devices=[mx.cpu()] * 3)
    with pytest.raises(ValueError, match="needs 4 devices, got 3"):
        jpar.create_mesh(jpar.MeshSpec(dp=2, tp=2),
                         devices=jax.devices("cpu")[:3])
    # no card and no host positions: the default devices raise
    monkeypatch.setattr(tmesh_mod, "num_gpus", lambda: 0)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        tpar.create_mesh(dp=1)


def test_current_mesh_is_settable():
    m = tmesh(dp=2)
    old = tmesh_mod._CURRENT_MESH
    try:
        assert tpar.set_current_mesh(m) is m
        assert tpar.current_mesh() is m
    finally:
        tmesh_mod._CURRENT_MESH = old


@pytest.mark.parametrize("spec", [(), ("tp", None), ("tp",), (None, "tp"),
                                  (("dp",), "sp"), (("dp", "tp"), None),
                                  ("pp", None, None)])
def test_partition_spec_str_is_jaxs(spec):
    assert str(TP(*spec)) == str(JP(*spec))
    assert tuple(TP(*spec)) == tuple(JP(*spec))


@pytest.mark.parametrize("shape", [(8, 4), (6, 5), (5, 6), (7, 3),
                                   (8, 3, 3, 3), (5, 3, 3, 3), (8,)])
def test_shard_params_rule_matches_jax(shape):
    m, j = tmesh(dp=2, tp=2), jmesh(dp=2, tp=2)
    assert tuple(tpar.shard_params_rule(m, "w", shape).spec) == \
        tuple(jpar.shard_params_rule(j, "w", shape).spec)
    assert tuple(tpar.shard_params_rule(tmesh(dp=4), "w", shape).spec) == ()


def test_batch_and_replicated_shardings():
    m, j = tmesh(dp=2, sp=2), jmesh(dp=2, sp=2)
    for extra in ((), ("sp",), (None,)):
        assert str(tpar.batch_sharding(m, extra).spec) == \
            str(jpar.batch_sharding(j, extra).spec)
    assert tuple(tpar.replicated_sharding(m).spec) == ()


@pytest.mark.parametrize("sizes,spec", [
    (dict(dp=2, tp=2), ("tp", None)),
    (dict(dp=2, tp=2), (None, "tp")),
    (dict(dp=2, pp=2, tp=2), (("dp", "tp"), None)),
    (dict(dp=2, sp=2, tp=2), ("dp", "sp")),
    (dict(pp=2, ep=2), ()),
])
def test_sharded_array_blocks_are_jaxs_shards(sizes, spec):
    """Each position's block is the JAX shard of the device at the same
    mesh position, and np.asarray gives the global value back."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 12).astype(np.float32)
    m, j = tmesh(**sizes), jmesh(**sizes)
    ts = tpar.shard(x, tpar.NamedSharding(m, TP(*spec)))
    js = jax.device_put(x, JNamedSharding(j, JP(*spec)))
    by_device = {s.device: np.asarray(s.data) for s in js.addressable_shards}
    for p, dev in enumerate(j.devices.flat):
        np.testing.assert_array_equal(ts.shards[p].numpy(), by_device[dev])
    np.testing.assert_array_equal(np.asarray(ts), x)
    assert ts.shape == (8, 12) and ts.dtype == torch.float32
    assert str(ts.sharding.spec) == str(js.sharding.spec)


def test_collectives_count_by_kind_and_sum_in_position_order():
    m = tmesh(dp=2, tp=2)
    blocks = [torch.full((3,), float(p)) for p in range(4)]
    with tpar.collectives.watch() as w:
        s = tpar.collectives.psum(blocks, m, "tp")
        g = tpar.collectives.all_gather(blocks, m, "dp")
        r = tpar.collectives.ppermute(blocks, m, "tp", [(0, 1)])
        a = tpar.collectives.all_to_all(
            [torch.arange(4.0) + 10 * p for p in range(4)], m, "dp", 0, 0)
    assert w.counts == {"all-reduce": 1, "all-gather": 1,
                        "reduce-scatter": 0, "collective-permute": 1,
                        "all-to-all": 1}
    assert set(w.counts) == set(jcomm._COLLECTIVES)
    # positions (dp, tp): 0=(0,0) 1=(0,1) 2=(1,0) 3=(1,1)
    assert [float(t[0]) for t in s] == [1.0, 1.0, 5.0, 5.0]
    assert g[1][:, 0].tolist() == [1.0, 3.0]
    assert [float(t[0]) for t in r] == [0.0, 0.0, 0.0, 2.0]
    # dp group (0, 2): position 0 gets chunk 0 of each, position 2 chunk 1
    assert a[0].tolist() == [0.0, 1.0, 20.0, 21.0]
    assert a[2].tolist() == [2.0, 3.0, 22.0, 23.0]


# -- ring attention -----------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sizes,batch_axis", [(dict(sp=4), None),
                                              (dict(dp=2, sp=4), "dp")])
def test_ring_attention_matches_jax(causal, sizes, batch_axis):
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(4, 16, 2, 8).astype(np.float32) for _ in range(3))
    want = jpar.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               mesh=jmesh(**sizes), causal=causal,
                               batch_axis=batch_axis)
    m = tmesh(**sizes)
    with tpar.collectives.watch() as w:
        got = tpar.ring_attention(t32(q), t32(k), t32(v), mesh=m,
                                  causal=causal, batch_axis=batch_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # two rotations (K and V) a round, sp rounds
    assert w.counts["collective-permute"] == 2 * sizes["sp"]


def test_ring_self_attention_gradients_match_jax():
    """d(loss)/d(x, wq..wo) through the ring, causal, dp x sp."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8).astype(np.float32)
    ws = [rng.randn(8, 8).astype(np.float32) * 0.3 for _ in range(4)]
    jm = jmesh(dp=2, sp=2)

    def jloss(x, *w):
        return jnp.sum(jpar.ring_self_attention(
            x, *w, num_heads=2, mesh=jm, batch_axis="dp") ** 2)
    jg = jax.grad(jloss, argnums=tuple(range(5)))(jnp.asarray(x),
                                                  *map(jnp.asarray, ws))
    tx = [t32(a).requires_grad_(True) for a in [x] + ws]
    out = tpar.ring_self_attention(*tx, num_heads=2, mesh=tmesh(dp=2, sp=2),
                                   batch_axis="dp")
    (out ** 2).sum().backward()
    for t, g in zip(tx, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=2e-5, atol=2e-5)


# -- mixture of experts -------------------------------------------------------

def _moe_inputs(seed, tokens=32, n_exp=4, d=8, h=16, gate_scale=1.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(tokens, d).astype(np.float32)
    gate_w = (rng.randn(d, n_exp) * gate_scale).astype(np.float32)
    w1 = rng.randn(n_exp, d, h).astype(np.float32) * 0.1
    w2 = rng.randn(n_exp, h, d).astype(np.float32) * 0.1
    return x, gate_w, w1, w2


@pytest.mark.parametrize("capacity", [4.0, 1.25])
@pytest.mark.parametrize("sizes,batch_axis", [(dict(ep=2), None),
                                              (dict(dp=2, ep=2), "dp"),
                                              (dict(dp=2, ep=4), "dp")])
def test_moe_ffn_matches_jax_with_the_same_dropped_tokens(capacity, sizes,
                                                          batch_axis):
    x, gate_w, w1, w2 = _moe_inputs(2, tokens=64, n_exp=8)
    want = np.asarray(jpar.moe_ffn(
        *map(jnp.asarray, (x, gate_w, w1, w2)), mesh=jmesh(**sizes),
        capacity_factor=capacity, batch_axis=batch_axis))
    with tpar.collectives.watch() as w:
        got = tpar.moe_ffn(*map(t32, (x, gate_w, w1, w2)),
                           mesh=tmesh(**sizes), capacity_factor=capacity,
                           batch_axis=batch_axis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    dropped_j, dropped_t = (want == 0).all(-1), (got == 0).all(-1)
    np.testing.assert_array_equal(dropped_t, dropped_j)
    if capacity == 4.0:
        assert not dropped_t.any()
    else:
        assert dropped_t.any(), "the 1.25 case must drop tokens"
    assert w.counts["all-to-all"] == 2


def test_moe_capacity_is_per_position_not_global():
    """Routing the global token set once (capacity from all 64 tokens)
    drops another set than the JAX package's per-dp-shard capacity."""
    x, gate_w, w1, w2 = _moe_inputs(2, tokens=64, n_exp=8)
    split = tpar.moe_ffn(*map(t32, (x, gate_w, w1, w2)),
                         mesh=tmesh(dp=2, ep=2), capacity_factor=1.25,
                         batch_axis="dp").numpy()
    whole = tpar.moe_ffn(*map(t32, (x, gate_w, w1, w2)),
                         mesh=tmesh(ep=2), capacity_factor=1.25).numpy()
    assert ((split == 0).all(-1) != (whole == 0).all(-1)).any()


def test_moe_gradients_match_jax():
    x, gate_w, w1, w2 = _moe_inputs(3, tokens=32, n_exp=4)
    jm = jmesh(dp=2, ep=2)

    def jloss(*a):
        return jnp.sum(jpar.moe_ffn(*a, mesh=jm, capacity_factor=1.25,
                                    batch_axis="dp") ** 2)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, gate_w, w1, w2)))
    tx = [t32(a).requires_grad_(True) for a in (x, gate_w, w1, w2)]
    (tpar.moe_ffn(*tx, mesh=tmesh(dp=2, ep=2), capacity_factor=1.25,
                  batch_axis="dp") ** 2).sum().backward()
    for t, g in zip(tx, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)


def test_moe_layer_takes_a_seed_or_a_generator():
    a = tpar.MoELayer(4, 8, 16, 3, ctx=mx.cpu())
    b = tpar.MoELayer(4, 8, 16, torch.Generator().manual_seed(3),
                      ctx=mx.cpu())
    assert a.w1.shape == (4, 8, 16) and a.w2.shape == (4, 16, 8)
    assert a.gate_w.shape == (8, 4)
    torch.testing.assert_close(a.w2, b.w2, rtol=0, atol=0)
    x = torch.randn(16, 8)
    assert a(x, mesh=tmesh(ep=2)).shape == (16, 8)


# -- pipeline -----------------------------------------------------------------

@pytest.mark.parametrize("sizes,n_micro,batch_axis", [
    (dict(pp=4), 4, None),
    (dict(dp=2, pp=2), 4, "dp"),    # aligned: each replica pipelines 2
    (dict(dp=2, pp=2), 2, "dp"),    # the other layout: dp on the mb dim
])
def test_pipeline_stages_matches_jax(sizes, n_micro, batch_axis):
    rng = np.random.RandomState(3)
    n_stages, d = sizes["pp"], 8
    w = rng.randn(n_stages, d, d).astype(np.float32) * 0.2
    x = rng.randn(8, d).astype(np.float32)
    want = jpar.pipeline_stages(
        jnp.asarray(w), jnp.asarray(x), lambda p, xm: jnp.tanh(xm @ p),
        n_micro=n_micro, mesh=jmesh(**sizes), params_spec=JP("pp"),
        batch_axis=batch_axis)
    got = tpar.pipeline_stages(
        t32(w), t32(x), lambda p, xm: torch.tanh(xm @ p), n_micro=n_micro,
        mesh=tmesh(**sizes), params_spec=TP("pp"), batch_axis=batch_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    ref = x.astype(np.float64)
    for i in range(n_stages):
        ref = np.tanh(ref @ w[i])
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_pipeline_stages_with_a_tuple_of_stage_params_and_tail_spec():
    rng = np.random.RandomState(4)
    w1 = rng.randn(2, 4, 8).astype(np.float32) * 0.3
    w2 = rng.randn(2, 8, 4).astype(np.float32) * 0.3
    x = rng.randn(4, 6, 4).astype(np.float32)

    def jstage(p, xm):
        return xm + jnp.maximum(xm @ p[0], 0.0) @ p[1]

    def tstage(p, xm):
        return xm + torch.relu(xm @ p[0]) @ p[1]
    want = jpar.pipeline_stages(
        (jnp.asarray(w1), jnp.asarray(w2)), jnp.asarray(x), jstage,
        n_micro=4, mesh=jmesh(dp=2, pp=2, sp=2),
        params_spec=(JP("pp"), JP("pp")), batch_axis="dp",
        tail_spec=("sp", None))
    got = tpar.pipeline_stages(
        (t32(w1), t32(w2)), t32(x), tstage, n_micro=4,
        mesh=tmesh(dp=2, pp=2, sp=2), params_spec=(TP("pp"), TP("pp")),
        batch_axis="dp", tail_spec=("sp", None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="not divisible by n_micro"):
        tpar.pipeline_stages((t32(w1), t32(w2)), t32(x), tstage, n_micro=3,
                             mesh=tmesh(pp=2))


# -- ShardedTrainStep ---------------------------------------------------------

def _run_both(jloss, tloss, params, batch, sizes, steps, param_spec=None,
              batch_spec=None, **kw):
    """(JAX step, port step, JAX losses, port losses) after ``steps``."""
    jm, tm = jmesh(**sizes), tmesh(**sizes)
    jkw, tkw = dict(kw), dict(kw)
    if param_spec is not None:
        jkw["param_sharding"] = {k: JNamedSharding(jm, JP(*s))
                                 for k, s in param_spec.items()}
        tkw["param_sharding"] = {k: tpar.NamedSharding(tm, TP(*s))
                                 for k, s in param_spec.items()}
    if batch_spec is not None:
        jkw["batch_spec"] = {k: JNamedSharding(jm, JP(*s))
                             for k, s in batch_spec.items()}
        tkw["batch_spec"] = {k: tpar.NamedSharding(tm, TP(*s))
                             for k, s in batch_spec.items()}
    js = jpar.ShardedTrainStep(
        jloss(jm), {k: jnp.asarray(v) for k, v in params.items()}, jm, **jkw)
    ts = tpar.ShardedTrainStep(tloss(tm), dict(params), tm, **tkw)
    jl = [float(js({k: jnp.asarray(v) for k, v in batch.items()}))
          for _ in range(steps)]
    tl = [float(ts(batch)) for _ in range(steps)]
    return js, ts, jl, tl


def _assert_same(js, ts, jl, tl, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    for k in js.params:
        np.testing.assert_allclose(np.asarray(ts.params[k]),
                                   np.asarray(js.params[k]), rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(np.asarray(ts.momentum_buf[k]),
                                   np.asarray(js.momentum_buf[k]),
                                   rtol=rtol, atol=atol)


def test_sharded_train_step_dp_tp_matches_jax():
    rng = np.random.RandomState(4)
    w_true = rng.randn(8, 4).astype(np.float32)
    X = rng.randn(64, 8).astype(np.float32)
    batch = {"x": X, "y": X @ w_true}

    def jloss(_):
        return lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    def tloss(_):
        return lambda p, b: torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    js, ts, jl, tl = _run_both(
        jloss, tloss, {"w": np.zeros((8, 4), np.float32)}, batch,
        dict(dp=4, tp=2), 5, batch_spec={"x": ("dp",), "y": ("dp",)},
        lr=0.1, momentum=0.5, wd=0.01)
    _assert_same(js, ts, jl, tl)
    assert str(ts.params["w"].sharding.spec) == \
        str(js.params["w"].sharding.spec) == "PartitionSpec('tp', None)"
    assert tl[-1] < tl[0]
    assert ts.collectives == dict.fromkeys(tpar.collectives.KINDS, 0)


def test_gpipe_training_matches_jax_and_the_sequential_step():
    """tests/test_parallel.py's GPipe training problem: fwd+bwd+update
    through the schedule at dp=2, pp=2, against the JAX package's step
    (1e-5) and the sequential oracle (its own limits)."""
    rng = np.random.RandomState(7)
    n_stages, d = 2, 8
    w0 = rng.randn(n_stages, d, d).astype(np.float32) * 0.3
    X = rng.randn(16, d).astype(np.float32)
    Yt = np.tanh(np.tanh(X @ (rng.randn(d, d) * 0.5))
                 @ (rng.randn(d, d) * 0.5)).astype(np.float32)

    def jloss(m):
        def f(params, b):
            y = jpar.pipeline_stages(params["w"], b["x"],
                                     lambda p, xm: jnp.tanh(xm @ p),
                                     n_micro=4, mesh=m, params_spec=JP("pp"),
                                     batch_axis="dp")
            return jnp.mean((y - b["y"]) ** 2)
        return f

    def tloss(m):
        def f(params, b):
            y = tpar.pipeline_stages(params["w"], b["x"],
                                     lambda p, xm: torch.tanh(xm @ p),
                                     n_micro=4, mesh=m, params_spec=TP("pp"),
                                     batch_axis="dp")
            return torch.mean((y - b["y"]) ** 2)
        return f
    js, ts, jl, tl = _run_both(
        jloss, tloss, {"w": w0}, {"x": X, "y": Yt}, dict(dp=2, pp=2), 6,
        param_spec={"w": ("pp",)}, batch_spec={"x": ("dp",), "y": ("dp",)},
        lr=0.2, momentum=0.9)
    _assert_same(js, ts, jl, tl)
    assert tl[-1] < tl[0] * 0.9, "pipeline training not learning"
    # the sequential oracle on one position
    w, mom = torch.tensor(w0, dtype=torch.float64), None
    seq = []
    for _ in range(6):
        w.requires_grad_(True)
        h = torch.tensor(X, dtype=torch.float64)
        for i in range(n_stages):
            h = torch.tanh(h @ w[i])
        loss = torch.mean((h - torch.tensor(Yt, dtype=torch.float64)) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        seq.append(loss.item())
        with torch.no_grad():
            mom = g if mom is None else 0.9 * mom + g
            w = w - 0.2 * mom
    np.testing.assert_allclose(tl, seq, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ts.params["w"]), w.numpy(),
                               rtol=2e-3, atol=2e-4)
    # each replica pipelines 2 of the 4 microbatches: 2 + 2 - 1 ticks of
    # one state rotation, then one broadcast psum
    assert ts.collectives["collective-permute"] == 3
    assert ts.collectives["all-reduce"] == 1


def _overlap_problem():
    rng = np.random.RandomState(0)
    P0 = {"w%d" % i: rng.randn(16, 16).astype(np.float32) * 0.1
          for i in range(4)}
    batch = {"x": rng.randn(32, 16).astype(np.float32),
             "y": rng.randn(32, 16).astype(np.float32)}

    def jloss(_):
        def f(p, b):
            h = b["x"]
            for i in range(4):
                h = jnp.tanh(h @ p["w%d" % i])
            return jnp.mean((h - b["y"]) ** 2)
        return f

    def tloss(_):
        def f(p, b):
            h = b["x"]
            for i in range(4):
                h = torch.tanh(h @ p["w%d" % i])
            return torch.mean((h - b["y"]) ** 2)
        return f
    return P0, batch, jloss, tloss


def test_overlap_path_matches_monolithic_and_jax_one_reduction_a_bucket(
        monkeypatch):
    P0, batch, jloss, tloss = _overlap_problem()
    spec = {"x": ("dp",), "y": ("dp",)}
    js0, ts0, jl0, tl0 = _run_both(jloss, tloss, P0, batch, dict(dp=8), 4,
                                   batch_spec=spec, lr=0.05)
    assert ts0.comm_plan is None and ts0.overlap_off_reason is None
    _assert_same(js0, ts0, jl0, tl0)
    monkeypatch.setenv("MXNET_TPU_COMM_BUCKET_MB", "0.0005")
    js1, ts1, jl1, tl1 = _run_both(jloss, tloss, P0, batch, dict(dp=8), 4,
                                   batch_spec=spec, lr=0.05)
    plan = ts1.comm_plan
    assert plan is not None and len(plan.buckets) >= 2
    assert plan.buckets == js1.comm_plan.buckets
    _assert_same(js1, ts1, jl1, tl1)
    np.testing.assert_allclose(tl1, tl0, rtol=1e-5)
    for k in P0:
        np.testing.assert_allclose(np.asarray(ts1.params[k]),
                                   np.asarray(ts0.params[k]), rtol=1e-5,
                                   atol=1e-7)
    # one all-reduce a bucket, plus the loss's pmean
    assert ts1.collectives["all-reduce"] == len(plan.buckets) + 1
    assert ts1.collectives["all-gather"] == 0
    with pytest.raises(mx.MXNetError, match="compiles no XLA program"):
        ts1.lower()


def test_two_bit_overlap_codes_byte_for_byte_then_losses(monkeypatch):
    """The first step's codes are the JAX quantizer's of the JAX package's
    per-shard gradients, byte for byte; 10 steps' losses within 1e-4."""
    monkeypatch.setenv("MXNET_TPU_GRAD_COMPRESS", "2bit")
    monkeypatch.setenv("MXNET_TPU_GRAD_COMPRESS_THRESHOLD", "0.001")
    P0, batch, jloss, tloss = _overlap_problem()
    dp, spec = 8, {"x": ("dp",), "y": ("dp",)}
    seen, real = [], tcomm.quantize_flat

    def recording(flat, residual, threshold):
        codes, res = real(flat, residual, threshold)
        seen.append(codes.clone())
        return codes, res
    monkeypatch.setattr(tcomm, "quantize_flat", recording)
    js, ts, jl, tl = _run_both(jloss, tloss, P0, batch, dict(dp=dp), 10,
                               batch_spec=spec, lr=0.05)
    plan = ts.comm_plan
    assert plan.compress == "2bit" and ts.residuals
    assert plan.buckets == js.comm_plan.buckets
    assert plan.wire_bytes == js.comm_plan.wire_bytes
    # the reference's codes: its own gradients of each shard, scaled by
    # 1/dp, quantized by its own quantizer, bucket by bucket
    order = list(P0)
    first = seen[:dp * len(plan.buckets)]
    for p in range(dp):
        shard = {k: jnp.asarray(v[p * 4:(p + 1) * 4])
                 for k, v in batch.items()}
        g = jax.grad(jloss(None))({k: jnp.asarray(v) for k, v in P0.items()},
                                  shard)
        for bi, idxs in enumerate(plan.buckets):
            flat = jnp.concatenate([jnp.ravel(g[order[i]]) for i in idxs])
            want, _ = jgc.quantize_flat(flat * jnp.float32(1.0 / dp),
                                        jnp.zeros_like(flat), 0.001)
            got = first[bi * dp + p]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    assert tl[-1] < tl[0]
    assert ts.collectives["all-gather"] == len(plan.buckets)
    assert ts.collectives["all-reduce"] == 1
    for r_t, r_j in zip(ts.residuals, js.residuals):
        assert r_t.shape == r_j.shape


def test_overlap_gate_reasons_are_jaxs(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_TPU_COMM_BUCKET_MB", "4")
    P0, _, jloss, tloss = _overlap_problem()
    cases = [(dict(dp=1), None), (dict(dp=4, tp=2), None),
             (dict(dp=8), {k: () for k in P0})]
    for sizes, param_spec in cases:
        jm, tm = jmesh(**sizes), tmesh(**sizes)
        jkw, tkw = {}, {}
        if param_spec is not None:
            # every parameter replicated but w3 split on its rows over dp
            jkw["param_sharding"] = {k: JNamedSharding(jm, JP())
                                     for k in P0}
            jkw["param_sharding"]["w3"] = JNamedSharding(jm, JP("dp"))
            tkw["param_sharding"] = {k: tpar.NamedSharding(tm, TP())
                                     for k in P0}
            tkw["param_sharding"]["w3"] = tpar.NamedSharding(tm, TP("dp"))
        js = jpar.ShardedTrainStep(jloss(jm), {k: jnp.asarray(v)
                                               for k, v in P0.items()}, jm,
                                   **jkw)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="mxnet_tpu"):
            ts = tpar.ShardedTrainStep(tloss(tm), P0, tm, **tkw)
        assert ts.comm_plan is None
        assert ts.overlap_off_reason == js.overlap_off_reason
        assert ts.overlap_off_reason is not None
        assert ("unavailable for this step (%s); using the monolithic "
                "GSPMD reduction" % ts.overlap_off_reason) in caplog.text
    assert "model-parallel" in tpar.ShardedTrainStep(
        tloss(None), P0, tmesh(dp=4, tp=2)).overlap_off_reason


def test_remat_and_donate_false():
    P0, batch, _, tloss = _overlap_problem()
    m = tmesh(dp=2)
    a = tpar.ShardedTrainStep(tloss(m), P0, m, lr=0.05)
    b = tpar.ShardedTrainStep(tloss(m), P0, m, lr=0.05, remat=True,
                              donate=False)
    kept = b.params["w0"]
    la, lb = float(a(batch)), float(b(batch))
    assert la == lb
    for k in P0:
        np.testing.assert_array_equal(np.asarray(a.params[k]),
                                      np.asarray(b.params[k]))
    np.testing.assert_array_equal(np.asarray(kept), P0["w0"])


# -- the multichip LM ---------------------------------------------------------

LM_SPEC = {
    "embed": (), "wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
    "wo": ("tp", None), "stage_w1": ("pp", None, None),
    "stage_w2": ("pp", None, None), "gate_w": (),
    "moe_w1": ("ep", None, None), "moe_w2": ("ep", None, None),
    "w_out": (None, "tp"),
}


def lm_params(sizes, vocab=64, d_model=16, seed=0):
    """The dry-run's weights (``__graft_entry__._dryrun_one``: vocab 64,
    d_model 16, 4 heads, 0.05 * randn from RandomState(0))."""
    rng = np.random.RandomState(seed)
    pp, ep = sizes.get("pp", 1), sizes.get("ep", 1)

    def mk(*shape):
        return rng.randn(*shape).astype(np.float32) * 0.05
    params = {"embed": mk(vocab, d_model), "wq": mk(d_model, d_model),
              "wk": mk(d_model, d_model), "wv": mk(d_model, d_model),
              "wo": mk(d_model, d_model),
              "stage_w1": mk(pp, d_model, 2 * d_model),
              "stage_w2": mk(pp, 2 * d_model, d_model),
              "gate_w": mk(d_model, 2 * ep),
              "moe_w1": mk(2 * ep, d_model, 2 * d_model),
              "moe_w2": mk(2 * ep, 2 * d_model, d_model),
              "w_out": mk(d_model, vocab)}
    dp, sp = sizes.get("dp", 1), sizes.get("sp", 1)
    batch, seq = max(4, 2 * dp), 8 * sp
    data = {"tokens": rng.randint(0, vocab, (batch, seq)),
            "targets": rng.randint(0, vocab, (batch, seq))}
    return params, data


def jax_lm_loss(mesh, heads=4):
    dp = mesh.shape["dp"]

    def loss_fn(params, b):
        x = params["embed"][b["tokens"]]
        x = x + jpar.ring_self_attention(
            x, params["wq"], params["wk"], params["wv"], params["wo"],
            num_heads=heads, mesh=mesh, causal=True, batch_axis="dp")
        x = jpar.pipeline_stages(
            (params["stage_w1"], params["stage_w2"]), x,
            lambda p, xm: xm + jnp.maximum(xm @ p[0], 0.0) @ p[1],
            n_micro=2 * dp, mesh=mesh, params_spec=(JP("pp"), JP("pp")),
            batch_axis="dp", tail_spec=("sp", None))
        x = x + jpar.moe_ffn(x, params["gate_w"], params["moe_w1"],
                             params["moe_w2"], mesh=mesh, batch_axis="dp")
        logits = jnp.einsum("bsd,dv->bsv", x, params["w_out"])
        logp = jax.nn.log_softmax(logits, axis=-1)
        return jnp.mean(-jnp.take_along_axis(logp, b["targets"][..., None],
                                             axis=-1))
    return loss_fn


def port_lm_loss(mesh, heads=4):
    dp = mesh.shape["dp"]

    def loss_fn(params, b):
        x = params["embed"][b["tokens"]]
        x = x + tpar.ring_self_attention(
            x, params["wq"], params["wk"], params["wv"], params["wo"],
            num_heads=heads, mesh=mesh, causal=True, batch_axis="dp")
        x = tpar.pipeline_stages(
            (params["stage_w1"], params["stage_w2"]), x,
            lambda p, xm: xm + torch.relu(xm @ p[0]) @ p[1],
            n_micro=2 * dp, mesh=mesh, params_spec=(TP("pp"), TP("pp")),
            batch_axis="dp", tail_spec=("sp", None))
        x = x + tpar.moe_ffn(x, params["gate_w"], params["moe_w1"],
                             params["moe_w2"], mesh=mesh, batch_axis="dp")
        logits = torch.einsum("bsd,dv->bsv", x, params["w_out"])
        logp = torch.log_softmax(logits, dim=-1)
        return torch.mean(-torch.gather(logp, -1, b["targets"][..., None]))
    return loss_fn


@pytest.mark.parametrize("sizes", [dict(dp=2, pp=2, ep=2),
                                   dict(dp=2, sp=2, tp=2)],
                         ids=["dp2-pp2-ep2", "dp2-sp2-tp2"])
def test_multichip_lm_step_matches_jax(sizes):
    """The dry-run's LM on an 8-position mesh, one step: loss and every
    parameter within 1e-5 of the JAX package's on its 8 CPU devices."""
    params, data = lm_params(sizes)
    js, ts, jl, tl = _run_both(
        jax_lm_loss, port_lm_loss, params, data, sizes, 1,
        param_spec=LM_SPEC,
        batch_spec={"tokens": ("dp", "sp"), "targets": ("dp", "sp")},
        lr=0.01)
    _assert_same(js, ts, jl, tl)
    assert np.isfinite(tl[0])
    counts = ts.collectives
    assert counts["all-to-all"] == 2
    assert counts["collective-permute"] == \
        2 * sizes.get("sp", 1) + 2 + sizes.get("pp", 1) - 1
    assert counts["all-reduce"] == 1
    for k, s in LM_SPEC.items():
        assert str(ts.params[k].sharding.spec) == str(JP(*s))


# -- the store's mesh and the converters --------------------------------------

def test_collective_store_has_a_mesh():
    m = tmesh(dp=2)
    kv = mx.kv.create("tpu_ici")
    old = tmesh_mod._CURRENT_MESH
    try:
        tpar.set_current_mesh(m)
        assert kv.mesh is m
        given = mx.kvstore.nccl.NcclKVStore("nccl", mesh=tmesh(dp=4))
        assert dict(given.mesh.shape)["dp"] == 4
    finally:
        tmesh_mod._CURRENT_MESH = old


def test_set_parallel_state_carries_a_jax_step_and_moe_layer():
    """A JAX step's params and momentum after 2 steps, carried into a
    fresh port step: the third step agrees (1e-5); a JAX MoELayer's
    weights give the JAX layer's output (1e-5)."""
    P0, batch, jloss, tloss = _overlap_problem()
    sizes = dict(dp=2, tp=2)
    jm, tm = jmesh(**sizes), tmesh(**sizes)
    js = jpar.ShardedTrainStep(jloss(jm), {k: jnp.asarray(v)
                                           for k, v in P0.items()}, jm,
                               lr=0.05)
    for _ in range(2):
        js({k: jnp.asarray(v) for k, v in batch.items()})
    zeros = {k: np.zeros_like(v) for k, v in P0.items()}
    ts = tpar.ShardedTrainStep(tloss(tm), zeros, tm, lr=0.05)
    mx.convert.set_parallel_state(
        ts, {k: np.asarray(v) for k, v in js.params.items()},
        momentum={k: np.asarray(v) for k, v in js.momentum_buf.items()})
    assert str(ts.params["w0"].sharding.spec) == "PartitionSpec('tp', None)"
    jl = float(js({k: jnp.asarray(v) for k, v in batch.items()}))
    tl = float(ts(batch))
    _assert_same(js, ts, [jl], [tl])
    with pytest.raises(mx.MXNetError, match="names"):
        mx.convert.set_parallel_state(ts, {"w0": P0["w0"]})

    layer = jpar.MoELayer(4, 8, 16, jax.random.PRNGKey(0))
    port = tpar.MoELayer(4, 8, 16, 1, ctx=mx.cpu())
    mx.convert.set_parallel_state(
        port, {k: np.asarray(getattr(layer, k))
               for k in ("gate_w", "w1", "w2")}, mesh=tmesh(ep=2))
    x = np.random.RandomState(5).randn(16, 8).astype(np.float32)
    np.testing.assert_allclose(port(t32(x), mesh=tmesh(ep=2)).numpy(),
                               np.asarray(layer(jnp.asarray(x),
                                                mesh=jmesh(ep=2))),
                               rtol=1e-5, atol=1e-5)
