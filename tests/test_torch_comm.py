"""The port's bucketed gradient collectives (``mx.parallel.comm``) against
the JAX package's ``mxnet_tpu.parallel.comm``.

Bucket plans, the wire accounting, the environment knobs, the cache-key
component and the elastic residual resharding must equal the JAX
package's exactly.  ``reduce_buckets`` runs over the port's host
positions and the JAX package's under ``shard_map`` on its virtual CPU
devices, from the same numpy gradients: plain sums within 1e-6 (f32 sums
in another order), 2-bit reductions and residuals bit for bit (the codes
count whole thresholds).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import mxnet_tpu_torch as mx
from mxnet_tpu.parallel import comm as jcomm
from mxnet_tpu.parallel import create_mesh as jcreate_mesh
from mxnet_tpu.parallel._smap import UNCHECKED, shard_map
from mxnet_tpu_torch.parallel import comm as tcomm
from mxnet_tpu_torch.parallel import create_mesh as tcreate_mesh

_KNOBS = ("MXNET_TPU_COMM_BUCKET_MB", "MXNET_TPU_GRAD_COMPRESS",
          "MXNET_TPU_GRAD_COMPRESS_THRESHOLD")


@pytest.fixture(autouse=True)
def _clean_comm(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    yield


SHAPES = [[(64, 32), (32,), (32, 16), (16,), (16, 4), (4,)],
          [(4,), (1000,), (4,)],
          [(8,), (8,), (8,)],
          [(3, 5), (7,), (2, 2, 2), (1,)]]


@pytest.mark.parametrize("shapes", SHAPES)
@pytest.mark.parametrize("bucket_bytes", [16, 64, 1024, 1 << 20])
def test_partition_buckets_equals_jax(shapes, bucket_bytes):
    dtypes = ["float32"] * len(shapes)
    assert tcomm.partition_buckets(shapes, dtypes, bucket_bytes) == \
        jcomm.partition_buckets(shapes, dtypes, bucket_bytes)


def test_partition_splits_on_dtype_change_as_jax():
    shapes = [(8,), (8,), (8,)]
    names = ["float32", "bfloat16", "bfloat16"]
    want = jcomm.partition_buckets(shapes, names, 1 << 20)
    assert want == [[2, 1], [0]]
    assert tcomm.partition_buckets(shapes, names, 1 << 20) == want
    torch_dtypes = [torch.float32, torch.bfloat16, torch.bfloat16]
    assert tcomm.partition_buckets(shapes, torch_dtypes, 1 << 20) == want


@pytest.mark.parametrize("compress", [None, "2bit"])
@pytest.mark.parametrize("shapes", SHAPES)
def test_comm_plan_equals_jax(shapes, compress):
    cfg_j = jcomm.CommConfig(bucket_bytes=256, compress=compress,
                             threshold=0.25 if compress else 0.0)
    cfg_t = tcomm.CommConfig(*cfg_j)
    j = jcomm.CommPlan(shapes, ["float32"] * len(shapes), cfg_j, scale=0.25)
    t = tcomm.CommPlan(shapes, [torch.float32] * len(shapes), cfg_t,
                       scale=0.25)
    for attr in ("buckets", "bucket_elems", "compress", "threshold", "scale",
                 "wire_bytes", "grad_bytes", "grad_f32_bytes", "shapes",
                 "n_buckets"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.residual_shapes() == j.residual_shapes()


ENVS = [
    {},
    {"MXNET_TPU_COMM_BUCKET_MB": "2"},
    {"MXNET_TPU_COMM_BUCKET_MB": "0.0005"},
    {"MXNET_TPU_GRAD_COMPRESS": "2bit"},
    {"MXNET_TPU_GRAD_COMPRESS": "2bit",
     "MXNET_TPU_GRAD_COMPRESS_THRESHOLD": "0.125"},
    {"MXNET_TPU_GRAD_COMPRESS": "off"},
    {"MXNET_TPU_GRAD_COMPRESS": "2bit", "MXNET_TPU_COMM_BUCKET_MB": "0"},
    {"MXNET_TPU_GRAD_COMPRESS": "2bit", "MXNET_TPU_COMM_BUCKET_MB": "off"},
    {"MXNET_TPU_COMM_BUCKET_MB": "-3"},
    {"MXNET_TPU_COMM_BUCKET_MB": "lots"},
    {"MXNET_TPU_GRAD_COMPRESS": "1bit"},
    {"MXNET_TPU_GRAD_COMPRESS": "2bit",
     "MXNET_TPU_GRAD_COMPRESS_THRESHOLD": "half"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    "%s=%s" % (k.rsplit("_", 1)[-1], v) for k, v in e.items()) or "unset")
def test_env_resolution_and_signature_equal_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tcomm.comm_config() == jcomm.comm_config()
    assert tcomm.comm_signature() == jcomm.comm_signature()
    assert tcomm.compress_mode() == jcomm.compress_mode()
    assert tcomm.compress_threshold() == jcomm.compress_threshold()
    assert (tcomm.bucket_mb() is tcomm._BUCKET_OFF) == \
        (jcomm.bucket_mb() is jcomm._BUCKET_OFF)
    assert tcomm.BUCKET_ENV == jcomm.BUCKET_ENV
    assert tcomm.DEFAULT_BUCKET_MB == jcomm.DEFAULT_BUCKET_MB


@pytest.mark.parametrize("old_dp,new_dp", [(8, 8), (8, 4), (8, 2), (8, 1),
                                           (4, 8), (6, 4), (4, 0)])
def test_reshard_residuals_equals_jax(old_dp, new_dp):
    rng = np.random.RandomState(old_dp)
    buckets = [rng.randn(old_dp, n).astype(np.float32) for n in (5, 12)]
    t_out, t_reason = tcomm.reshard_residuals(buckets, new_dp)
    j_out, j_reason = jcomm.reshard_residuals(buckets, new_dp)
    assert t_reason == j_reason
    if j_out is None:
        assert t_out is None
    else:
        for a, b in zip(t_out, j_out):
            np.testing.assert_array_equal(a, b)


def test_reshard_residuals_refuses_a_flat_bucket_as_jax():
    flat = [np.zeros(7, np.float32)]
    assert tcomm.reshard_residuals(flat, 2) == \
        jcomm.reshard_residuals(flat, 2)


def _grads(dp, shapes, seed):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(np.float32) * 0.3 for s in shapes]
            for _ in range(dp)]


def _jax_reduce(grads, plan, residuals, dp):
    """The JAX package's reduce_buckets inside shard_map over dp CPU
    devices: each device's gradients are row ``i`` of a stacked input."""
    mesh = jcreate_mesh(dp=dp, devices=jax.devices("cpu")[:dp])
    stacked = [jnp.asarray(np.stack([g[i] for g in grads]))
               for i in range(len(grads[0]))]
    res = [jnp.asarray(np.stack(r)) for r in zip(*residuals)] \
        if residuals else []

    def body(gs, rs):
        red, new = jcomm.reduce_buckets([g[0] for g in gs], "dp", plan,
                                        [r[0] for r in rs])
        return [r[None] for r in red], [r[None] for r in new]
    fn = shard_map(body, mesh=mesh,
                   in_specs=([JP("dp")] * len(stacked), [JP("dp")] * len(res)),
                   out_specs=([JP("dp")] * len(stacked),
                              [JP("dp")] * len(plan.residual_shapes())),
                   **UNCHECKED)
    red, new = fn(stacked, res)
    return ([[np.asarray(r)[p] for r in red] for p in range(dp)],
            [[np.asarray(r)[p] for r in new] for p in range(dp)])


@pytest.mark.parametrize("compress", [None, "2bit"])
def test_reduce_buckets_equals_jax_one_collective_a_bucket(compress):
    dp, shapes = 4, [(6, 5), (5,), (5, 3), (3,)]
    grads = _grads(dp, shapes, 1)
    cfg = (64, compress, 0.05 if compress else 0.0)
    jplan = jcomm.CommPlan(shapes, ["float32"] * 4, jcomm.CommConfig(*cfg),
                           scale=1.0 / dp)
    tplan = tcomm.CommPlan(shapes, [torch.float32] * 4,
                           tcomm.CommConfig(*cfg), scale=1.0 / dp)
    assert tplan.n_buckets >= 2
    rng = np.random.RandomState(2)
    residuals = [[rng.randn(*s).astype(np.float32) * 0.02
                  for s in tplan.residual_shapes()] for _ in range(dp)]
    want_red, want_res = _jax_reduce(grads, jplan, residuals, dp)
    mesh = tcreate_mesh(dp=dp, devices=[mx.cpu()] * dp)
    with mx.parallel.collectives.watch() as w:
        red, res = tcomm.reduce_buckets(
            [[torch.as_tensor(g) for g in gs] for gs in grads], "dp", tplan,
            [[torch.as_tensor(r) for r in rs] for rs in residuals],
            mesh=mesh)
    kind = "all-gather" if compress else "all-reduce"
    assert w.counts[kind] == tplan.n_buckets
    assert sum(w.counts.values()) == tplan.n_buckets
    for p in range(dp):
        for got, want in zip(red[p], want_red[p]):
            if compress:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6)
        for got, want in zip(res[p], want_res[p]):
            np.testing.assert_array_equal(got.numpy(), want)
    # every position holds the same reduction
    for p in range(1, dp):
        for a, b in zip(red[p], red[0]):
            assert torch.equal(a, b)


def test_reduce_buckets_keeps_each_gradient_dtype():
    shapes = [(4,), (3,)]
    plan = tcomm.CommPlan(shapes, [torch.float64] * 2,
                          tcomm.CommConfig(1 << 20, None, 0.0), scale=0.5)
    mesh = tcreate_mesh(dp=2, devices=[mx.cpu()] * 2)
    grads = [[torch.ones(4, dtype=torch.float64),
              torch.ones(3, dtype=torch.float64)] for _ in range(2)]
    red, res = tcomm.reduce_buckets(grads, "dp", plan, mesh=mesh)
    assert res == [[], []]
    assert red[0][0].dtype == torch.float64
    assert red[1][1].tolist() == [1.0, 1.0, 1.0]


def test_collective_kinds_are_the_hlo_counters():
    assert mx.parallel.collectives.KINDS == jcomm._COLLECTIVES
    assert functools.reduce(lambda a, k: a and k in jcomm.collective_counts(
        ""), mx.parallel.collectives.KINDS, True)
