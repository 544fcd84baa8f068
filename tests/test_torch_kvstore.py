"""The port's KVStore against the JAX package's.

``mx.kv.create``'s names, push/pull over 2-4 contexts (sums, updater,
optimizer), ``'device'``'s merge owners, the 2-bit wire format byte for
byte with error feedback, ``push_pull_list``'s batching, ``row_sparse_pull``
into dense outputs and optimizer states through the store.  The JAX side
runs on the harness's virtual CPU devices (``cpu(i)``), the port on the
host.  Inputs come from numpy seeds; each test states its tolerance.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.kvstore import gradient_compression as gc_j
from mxnet_tpu_torch.kvstore import gradient_compression as gc_t
from mxnet_tpu_torch.kvstore import nccl

TOL = dict(rtol=1e-6, atol=1e-6)


def _both(fn):
    """``fn(package)`` in each package: (JAX's, the port's)."""
    return fn(mj), fn(mt)


@pytest.mark.parametrize("name", ["local", "device", "nccl", "tpu_ici",
                                  "local_allreduce_device", "ici_ring"])
def test_create_names_map_to_the_same_kind_of_store(name):
    j, t = _both(lambda pkg: pkg.kv.create(name))
    assert t.type == j.type == name
    collective = ("tpu" in name or "ici" in name)
    assert isinstance(t, mt.kvstore.nccl.NcclKVStore) == collective
    assert (t.rank, t.num_workers) == (j.rank, j.num_workers) == (0, 1)


def test_create_refuses_unknown_names_and_non_strings():
    for pkg in (mj, mt):
        with pytest.raises(pkg.base.MXNetError):
            pkg.kv.create("no_such_store")
        with pytest.raises(TypeError):
            pkg.kv.create(3)


@pytest.mark.parametrize("store", ["local", "device", "tpu_ici"])
@pytest.mark.parametrize("n_ctx", [2, 3, 4])
def test_push_pull_sums_the_contexts_copies(store, n_ctx):
    rng = np.random.RandomState(n_ctx)
    copies = [rng.standard_normal((5, 3)).astype(np.float32)
              for _ in range(n_ctx)]

    def run(pkg):
        kv = pkg.kv.create(store)
        ctxs = [pkg.cpu(i) for i in range(n_ctx)]
        kv.init("w", pkg.nd.zeros((5, 3), ctx=ctxs[0]))
        kv.push("w", [pkg.nd.array(c, ctx=x) for c, x in zip(copies, ctxs)])
        outs = [pkg.nd.zeros((5, 3), ctx=x) for x in ctxs]
        kv.pull("w", out=outs)
        return [o.asnumpy() for o in outs]

    got_j, got_t = _both(run)
    for a, b in zip(got_j, got_t):
        np.testing.assert_allclose(b, a, **TOL)
        np.testing.assert_allclose(b, sum(copies), **TOL)


@pytest.mark.parametrize("store", ["local", "device", "tpu_ici"])
def test_updater_and_optimizer_see_the_summed_gradient(store):
    rng = np.random.RandomState(1)
    w0 = rng.standard_normal((4,)).astype(np.float32)
    grads = [[rng.standard_normal((4,)).astype(np.float32) for _ in range(2)]
             for _ in range(3)]

    def run(pkg):
        ctxs = [pkg.cpu(0), pkg.cpu(1)]
        seen = {}
        kv = pkg.kv.create(store)
        kv.init("g", pkg.nd.zeros((4,), ctx=ctxs[0]))
        kv.set_updater(lambda k, g, w: seen.setdefault(k, g.asnumpy()))
        kv.push("g", [pkg.nd.array(g, ctx=c)
                      for g, c in zip(grads[0], ctxs)])
        opt_kv = pkg.kv.create(store)
        opt_kv.set_optimizer(pkg.optimizer.SGD(
            learning_rate=0.1, momentum=0.9, rescale_grad=0.5, wd=0.01))
        opt_kv.init("w", pkg.nd.array(w0, ctx=ctxs[0]))
        out = pkg.nd.zeros((4,), ctx=ctxs[0])
        for step in grads:
            opt_kv.push("w", [pkg.nd.array(g, ctx=c)
                              for g, c in zip(step, ctxs)])
        opt_kv.pull("w", out=out)
        return seen["g"], out.asnumpy()

    (seen_j, w_j), (seen_t, w_t) = _both(run)
    np.testing.assert_allclose(seen_t, seen_j, **TOL)
    np.testing.assert_allclose(seen_t, sum(grads[0]), **TOL)
    np.testing.assert_allclose(w_t, w_j, **TOL)


def test_list_keys_and_single_values():
    def run(pkg):
        kv = pkg.kv.create("local")
        kv.init([1, 2], [pkg.nd.ones((2,), ctx=pkg.cpu()),
                         pkg.nd.zeros((2,), ctx=pkg.cpu())])
        kv.push(2, pkg.nd.full((2,), 5.0, ctx=pkg.cpu()))
        outs = [pkg.nd.zeros((2,), ctx=pkg.cpu()) for _ in range(2)]
        kv.pull([1, 2], out=outs)
        with pytest.raises(pkg.base.MXNetError):
            kv.init(1, pkg.nd.ones((2,), ctx=pkg.cpu()))
        return [o.asnumpy() for o in outs]

    got_j, got_t = _both(run)
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(b, a)


def test_device_store_spreads_merge_owners_as_the_jax_package_does():
    """Keys of uneven sizes over 4 contexts: each key's owner, least
    loaded first by bytes, is the JAX package's (the port names an owner
    by its position among the copies, the JAX package by its context)."""
    rng = np.random.RandomState(0)
    shapes = [(16, 4), (3,), (8, 8), (2, 2), (40,), (5, 5), (1,), (9, 3)]

    def run(pkg):
        kv = pkg.kv.create("device")
        ctxs = [pkg.cpu(i) for i in range(4)]
        for i, s in enumerate(shapes):
            kv.init(i, pkg.nd.zeros(s, ctx=ctxs[0]))
            kv.push(i, [pkg.nd.array(rng.standard_normal(s), ctx=c)
                        for c in ctxs])
        return kv._merge_owner

    owners_j, owners_t = _both(run)
    assert {k: str(c) for k, c in owners_j.items()} == \
        {k: "cpu(%d)" % p for k, p in owners_t.items()}
    assert len(set(owners_t.values())) == 4


def test_device_store_names_owners_by_position_on_one_device():
    """Two contexts on one device are two merge owners."""
    kv = mt.kv.create("device")
    ctxs = [mt.cpu(0)] * 2
    for k in range(4):
        kv.init(k, mt.nd.zeros((8,), ctx=mt.cpu()))
        kv.push(k, [mt.nd.ones((8,), ctx=c) for c in ctxs])
    assert sorted(set(kv._merge_owner.values())) == [0, 1]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 1000])
def test_two_bit_codes_byte_for_byte_with_residuals(n):
    """``quantize_flat`` over 3 pushes carrying the residual: the packed
    codes equal the JAX package's byte for byte (pad-to-4 tail included),
    the residuals within 1e-6, at thresholds 0.5 and 0.3."""
    rng = np.random.RandomState(n)
    for threshold in (0.5, 0.3):
        res_j = np.zeros(n, np.float32)
        res_t = torch.zeros(n)
        for _ in range(3):
            g = rng.standard_normal(n).astype(np.float32)
            codes_j, res_j = gc_j.quantize_flat(g, res_j, threshold)
            codes_t, res_t = gc_t.quantize_flat(torch.from_numpy(g), res_t,
                                                threshold)
            assert codes_t.dtype == torch.uint8
            assert codes_t.numel() == gc_t.packed_nbytes(n) == \
                gc_j.packed_nbytes(n)
            np.testing.assert_array_equal(codes_t.numpy(),
                                          np.asarray(codes_j))
            np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j),
                                       **TOL)
            np.testing.assert_array_equal(
                gc_t.dequantize_flat(codes_t, n, threshold).numpy(),
                np.asarray(gc_j.dequantize_flat(codes_j, n, threshold)))


@pytest.mark.parametrize("n", [1, 5, 1000])
def test_dequantize_sum_is_the_sum_of_the_rows(n):
    rng = np.random.RandomState(n + 7)
    rows = rng.randint(0, 256, (3, gc_t.packed_nbytes(n))).astype(np.uint8)
    got = gc_t.dequantize_sum_flat(torch.from_numpy(rows), n, 0.5)
    want = gc_j.dequantize_sum_flat(rows, n, 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    by_row = sum(gc_t.dequantize_flat(torch.from_numpy(r), n, 0.5)
                 for r in rows)
    np.testing.assert_array_equal(got.numpy(), by_row.numpy())
    comp = gc_t.GradientCompression(threshold=0.5)
    np.testing.assert_array_equal(
        comp.dequantize_sum(torch.from_numpy(rows), (n,)).numpy(),
        got.numpy())


def test_device_store_compresses_each_context_with_its_own_residual():
    """Two pushes over two contexts under 2-bit compression: the sums of
    the per-context quantized values, then of the quantized residuals,
    equal to the JAX package's."""
    g0 = np.array([1.0, -0.2, 0.6, -0.9, 0.1, 0.0], np.float32)
    g1 = np.array([0.4, -1.1, 0.5, 0.2, -0.6, 2.0], np.float32)

    def run(pkg):
        kv = pkg.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        ctxs = [pkg.cpu(0), pkg.cpu(1)]
        kv.init("w", pkg.nd.zeros((6,), ctx=ctxs[0]))
        out, seen = pkg.nd.zeros((6,), ctx=ctxs[0]), []
        for vals in ((g0, g1), (np.zeros(6, np.float32),) * 2):
            kv.push("w", [pkg.nd.array(v, ctx=c) for v, c in zip(vals, ctxs)])
            kv.pull("w", out=out)
            seen.append(out.asnumpy())
        return seen

    got_j, got_t = _both(run)
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(b, a)

    def q(x):
        return np.where(x >= 0.5, 0.5, np.where(x <= -0.5, -0.5, 0.0))
    np.testing.assert_allclose(got_t[0], q(g0) + q(g1), **TOL)
    np.testing.assert_allclose(got_t[1], q(g0 - q(g0)) + q(g1 - q(g1)),
                               **TOL)


@pytest.mark.parametrize("store", ["local", "tpu_ici", "nccl"])
def test_compression_needs_a_device_or_dist_store(store):
    for pkg in (mj, mt):
        with pytest.raises(pkg.base.MXNetError):
            pkg.kv.create(store).set_gradient_compression(
                {"type": "2bit", "threshold": 0.5})
    with pytest.raises(mt.MXNetError):
        mt.kv.create("device").set_gradient_compression({"type": "1bit"})


def test_push_pull_list_reduces_once_per_dtype_group_in_place(monkeypatch):
    """Keys of two dtypes over 4 contexts: one reduction per dtype group
    (counted), the sums written back into the pushed arrays, equal to the
    JAX package's per key."""
    rng = np.random.RandomState(3)
    shapes = {"a": ((2, 3), np.float32), "b": ((5,), np.float32),
              "c": ((1, 2, 2), np.float64), "d": ((4,), np.float32)}
    vals = {k: [rng.standard_normal(s).astype(dt) for _ in range(4)]
            for k, (s, dt) in shapes.items()}
    calls = []
    real = nccl.allreduce_arrays
    monkeypatch.setattr(nccl, "allreduce_arrays",
                        lambda ts: calls.append(len(ts)) or real(ts))

    def run(pkg):
        kv = pkg.kv.create("tpu_ici")
        ctxs = [pkg.cpu(i) for i in range(4)]
        arrays = {}
        for k, (s, dt) in shapes.items():
            kv.init(k, pkg.nd.zeros(s, ctx=ctxs[0], dtype=dt))
            arrays[k] = [pkg.nd.array(v, ctx=c, dtype=dt)
                         for v, c in zip(vals[k], ctxs)]
        kv.push_pull_list(list(shapes), [arrays[k] for k in shapes],
                          [arrays[k] for k in shapes])
        return {k: [a.asnumpy() for a in arrays[k]] for k in shapes}

    got_j, got_t = _both(run)
    assert calls == [4, 4]
    for k in shapes:
        for a, b in zip(got_j[k], got_t[k]):
            assert b.dtype == shapes[k][1]
            np.testing.assert_allclose(b, a, **TOL)
            np.testing.assert_allclose(b, sum(vals[k]), **TOL)


def test_push_pull_list_on_one_device_is_one_reduction(monkeypatch):
    """Grouping is by context: copies on one device ([cpu(0)] * 2) still
    reduce once for every key."""
    calls = []
    real = nccl.allreduce_arrays
    monkeypatch.setattr(nccl, "allreduce_arrays",
                        lambda ts: calls.append(len(ts)) or real(ts))
    kv = mt.kv.create("tpu_ici")
    grads = []
    for k in range(5):
        kv.init(k, mt.nd.zeros((3,), ctx=mt.cpu()))
        grads.append([mt.nd.full((3,), k + c, ctx=mt.cpu()) for c in (1, 2)])
    kv.push_pull_list(list(range(5)), grads, grads)
    assert calls == [2]
    for k, (a, b) in enumerate(grads):
        np.testing.assert_array_equal(a.asnumpy(), 2 * k + 3)
        np.testing.assert_array_equal(b.asnumpy(), 2 * k + 3)
        assert a.tensor.data_ptr() != b.tensor.data_ptr()


def test_row_sparse_pull_into_dense_outputs():
    rng = np.random.RandomState(5)
    table = rng.standard_normal((6, 3)).astype(np.float32)
    ids = np.array([4, 1, 4, 9], np.int64)  # a duplicate, one past the end

    def run(pkg):
        kv = pkg.kv.create("local")
        kv.init("emb", pkg.nd.array(table, ctx=pkg.cpu()))
        out = pkg.nd.zeros((6, 3), ctx=pkg.cpu())
        kv.row_sparse_pull("emb", out=out,
                           row_ids=pkg.nd.array(ids, ctx=pkg.cpu()))
        full = pkg.nd.zeros((6, 3), ctx=pkg.cpu())
        kv.row_sparse_pull("emb", out=full)
        return out.asnumpy(), full.asnumpy()

    (rows_j, full_j), (rows_t, full_t) = _both(run)
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(full_t, table)
    np.testing.assert_array_equal(rows_t[[1, 4, 5]], table[[1, 4, 5]])
    np.testing.assert_array_equal(rows_t[[0, 2, 3]], 0.0)


def test_row_sparse_pull_into_a_sparse_output_names_its_slice():
    kv = mt.kv.create("local")
    kv.init("emb", mt.nd.ones((4, 2), ctx=mt.cpu()))
    from mxnet_tpu_torch.ndarray.sparse import CSRNDArray
    sparse = CSRNDArray(np.ones(1, np.float32), [0], [0, 1, 1, 1, 1],
                        (4, 2), ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="into a csr array"):
        kv.row_sparse_pull("emb", out=sparse, row_ids=[0, 1])


def test_optimizer_states_through_the_store(tmp_path):
    """States saved by the port's store load into the port's store and
    resume the same trajectory; the JAX package's store writes the same
    momenta."""
    rng = np.random.RandomState(9)
    w0 = rng.standard_normal((3, 2)).astype(np.float32)
    grads = [rng.standard_normal((3, 2)).astype(np.float32)
             for _ in range(4)]

    def store(pkg):
        kv = pkg.kv.create("device")
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                           rescale_grad=1.0))
        kv.init(0, pkg.nd.array(w0, ctx=pkg.cpu()))
        return kv

    def step(pkg, kv, g):
        kv.push(0, [pkg.nd.array(g / 2, ctx=pkg.cpu(c)) for c in (0, 1)])

    kv_j, kv_t = store(mj), store(mt)
    for g in grads[:2]:
        step(mj, kv_j, g)
        step(mt, kv_t, g)
    np.testing.assert_allclose(kv_t._updater.states[0].asnumpy(),
                               kv_j._updater.states[0].asnumpy(), **TOL)
    fname = str(tmp_path / "kv.states")
    kv_t.save_optimizer_states(fname)
    resumed = store(mt)
    kv_t.pull(0, out=resumed._stored[0])
    resumed.load_optimizer_states(fname)
    for g in grads[2:]:
        step(mt, kv_t, g)
        step(mt, resumed, g)
    a, b = (mt.nd.zeros((3, 2), ctx=mt.cpu()) for _ in range(2))
    kv_t.pull(0, out=a)
    resumed.pull(0, out=b)
    np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    with pytest.raises(mt.MXNetError):
        mt.kv.create("local").save_optimizer_states(fname)
