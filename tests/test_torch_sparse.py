"""Parity of the port's sparse storage (``mxnet_tpu_torch/ndarray/
sparse.py``, the storage ops, the lazy updates, the KVStore's sparse
paths) with the JAX package's, on the host.

Tolerances: storage conversions, retains, pulls and lazy updates exactly
(the same arithmetic on the same rows); ``dot`` within 1e-5 (the
products are summed in another order); the linear fit within 1e-5 of the
JAX package's over its first steps.  The no-sync paths are held to zero
host reads by counting ``asnumpy`` calls, as ``tests/test_sparse.py``
does, and the torch calls that read a tensor on the host.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.ndarray import sparse as sp
from mxnet_tpu_torch.ndarray.ndarray import NDArray


@pytest.fixture(autouse=True)
def host():
    with mx.cpu():
        yield


def _rand_dense(shape, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.randn(*shape).astype(np.float32)
    d[rng.rand(*shape) > density] = 0
    return d


def _rsp(pkg, rows, vals, shape):
    data = np.zeros((len(rows),) + shape[1:], np.float32) + vals
    return pkg.nd.sparse.row_sparse_array((data, rows), shape=shape)


@contextlib.contextmanager
def host_reads():
    """Counts the calls that read device data on the host: NDArray's
    ``asnumpy`` and torch's ``item``, ``tolist``, ``cpu``, ``nonzero``
    and ``unique``."""
    calls = []
    saved = [(NDArray, "asnumpy"), (torch.Tensor, "item"),
             (torch.Tensor, "tolist"), (torch.Tensor, "cpu"),
             (torch.Tensor, "nonzero"), (torch, "nonzero"),
             (torch, "unique")]
    real = [getattr(o, n) for o, n in saved]
    for (o, n), fn in zip(saved, real):
        setattr(o, n, (lambda fn, n: lambda *a, **k: (
            calls.append(n), fn(*a, **k))[1])(fn, n))
    try:
        yield calls
    finally:
        for (o, n), fn in zip(saved, real):
            setattr(o, n, fn)


# -- the sparse.py API ----------------------------------------------------------

def test_row_sparse_roundtrip_and_sorted_indices():
    d = _rand_dense((8, 5))
    for pkg in (mx, jmx):
        rs = pkg.nd.sparse.row_sparse_array(d)
        assert rs.stype == "row_sparse" and rs.shape == (8, 5)
        np.testing.assert_array_equal(rs.asnumpy(), d)
        np.testing.assert_array_equal(
            pkg.nd.array(d).tostype("row_sparse").asnumpy(), d)
    t = _rsp(mx, [4, 1], 1.0, (6, 3))
    j = _rsp(jmx, [4, 1], 1.0, (6, 3))
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_csr_roundtrip_slice_and_dot_against_the_jax_package():
    d = _rand_dense((6, 4), seed=1)
    rhs = np.random.RandomState(2).rand(4, 3).astype(np.float32)
    lhs_t = np.random.RandomState(3).rand(6, 2).astype(np.float32)
    res = {}
    for pkg in (mx, jmx):
        csr = pkg.nd.sparse.csr_matrix(d)
        assert csr.stype == "csr"
        res[pkg] = (csr.asnumpy(), csr.indptr.asnumpy(),
                    csr.indices.asnumpy(), csr[1:4].asnumpy(),
                    pkg.nd.sparse.dot(csr, pkg.nd.array(rhs)).asnumpy(),
                    pkg.nd.sparse.dot(csr, pkg.nd.array(lhs_t),
                                      transpose_a=True).asnumpy())
    for t, j in zip(res[mx], res[jmx]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(res[mx][0], d)


def test_zeros_empty_array_and_scipy():
    import scipy.sparse
    for stype in ("row_sparse", "csr"):
        z = sp.zeros(stype, (4, 3))
        assert z.stype == stype and z.asnumpy().sum() == 0
        assert sp.empty(stype, (4, 3)).shape == (4, 3)
    d = _rand_dense((5, 7), seed=9)
    a = sp.array(scipy.sparse.csr_matrix(d))
    assert a.stype == "csr"
    np.testing.assert_array_equal(a.asnumpy(), d)
    assert sp.array(a) is a


def test_cast_storage_and_the_storage_ops_against_the_jax_package():
    d = np.array([[1.0, 0.0, 2.0], [0.0, 0.0, 0.0], [3.0, 0.0, 0.0]],
                 np.float32)
    rsp = _rsp(mx, [0, 2], 1.0, (4, 3))
    jrsp = _rsp(jmx, [0, 2], 1.0, (4, 3))
    for pkg, r in ((mx, rsp), (jmx, jrsp)):
        x = pkg.nd.array(d)
        rs = pkg.nd.cast_storage(x, "row_sparse")
        assert rs.stype == "row_sparse"
        np.testing.assert_array_equal(
            pkg.nd.cast_storage(rs, "default").asnumpy(), d)
        assert pkg.nd.cast_storage(x, "csr").stype == "csr"
        assert pkg.nd.sparse.cast_storage(x, "csr").stype == "csr"
    idx_t, idx_j = mx.nd.array([2.0]), jmx.nd.array([2.0])
    kept = mx.nd.sparse_retain(rsp, idx_t)
    assert kept.stype == "row_sparse"
    np.testing.assert_array_equal(
        kept.asnumpy(), jmx.nd.sparse_retain(jrsp, idx_j).asnumpy())
    np.testing.assert_array_equal(
        mx.nd.sparse_retain(rsp.todense(), idx_t).asnumpy(), kept.asnumpy())
    q = mx.nd._square_sum(rsp, axis=1, keepdims=True)
    assert q.stype == "row_sparse"
    np.testing.assert_array_equal(
        q.asnumpy(), jmx.nd._square_sum(jrsp, axis=1, keepdims=True)
        .asnumpy())
    for kw in ({}, {"axis": 0}, {"axis": 1}, {"axis": 0, "keepdims": True}):
        np.testing.assert_array_equal(
            mx.nd.square_sum(rsp, **kw).asnumpy(),
            jmx.nd.square_sum(jrsp, **kw).asnumpy())
    # the dense forms in a symbol graph
    x = rsp.todense().asnumpy()
    exe = mx.sym.sparse_retain(mx.sym.Variable("x"), mx.sym.Variable(
        "i")).simple_bind(mx.cpu(), x=(4, 3), i=(1,))
    exe.arg_dict["x"][:] = x
    exe.arg_dict["i"][:] = [2.0]
    np.testing.assert_array_equal(exe.forward()[0].asnumpy(),
                                  kept.asnumpy())


def test_retain_keeps_requested_ids_absent_rows_zero_and_no_host_read():
    d = _rand_dense((16, 4), density=1.0, seed=11)
    rs = sp.row_sparse_array(d)
    jrs = jsp.row_sparse_array(d)
    ids = [3.0, 9.0, 12.0, 9.0]
    rid = mx.nd.array(ids)
    with host_reads() as calls:
        kept = rs.retain(rid)
    assert calls == []
    want = jrs.retain(jmx.nd.array(ids))
    np.testing.assert_array_equal(kept.indices.asnumpy(),
                                  want.indices.asnumpy())
    np.testing.assert_array_equal(kept.data.asnumpy(), want.data.asnumpy())
    np.testing.assert_array_equal(kept.asnumpy(), want.asnumpy())
    part = sp.RowSparseNDArray(mx.nd.array([[1., 1], [2, 2]]),
                               mx.nd.array([1, 3]), (6, 2))
    got = sp.retain(part, mx.nd.array([0.0, 1.0, 3.0, 5.0])).asnumpy()
    np.testing.assert_array_equal(got[[1, 3]], [[1, 1], [2, 2]])
    assert np.abs(got[[0, 2, 4, 5]]).sum() == 0


# -- lazy updates and the storage fallback ----------------------------------

@pytest.mark.parametrize("op", ["sgd_update", "sgd_mom_update",
                                "adam_update"])
@pytest.mark.parametrize("lazy", [True, False])
def test_lazy_updates_against_the_jax_package(op, lazy):
    """A row_sparse gradient touches its rows alone (weight and states);
    under ``lazy_update=False`` every row decays, as the dense math."""
    n_states = {"sgd_update": 0, "sgd_mom_update": 1, "adam_update": 2}[op]
    attrs = dict(lr=0.1, wd=0.1, lazy_update=lazy)
    if op == "sgd_mom_update":
        attrs["momentum"] = 0.9
    res = []
    for pkg in (mx, jmx):
        w = pkg.nd.array(np.linspace(-1, 1, 12, dtype=np.float32)
                         .reshape(4, 3))
        states = [pkg.nd.array(np.full((4, 3), 0.5, np.float32))
                  for _ in range(n_states)]
        g = _rsp(pkg, [2, 0], np.float32([0.3, -0.2, 0.1]), (4, 3))
        new_w = getattr(pkg.nd, op)(w, g, *states, **attrs)
        res.append([new_w.asnumpy(), w.asnumpy()]
                   + [s.asnumpy() for s in states])
    for t, j in zip(*res):
        np.testing.assert_array_equal(t, j)
    untouched = res[0][0][[1, 3]]
    if lazy:
        np.testing.assert_array_equal(untouched, res[0][1][[1, 3]])
    else:
        assert not np.array_equal(untouched, res[0][1][[1, 3]])


def test_storage_fallback_densifies_and_a_mutated_sparse_input_raises():
    g = _rsp(mx, [0, 2], 1.0, (4, 3))
    assert float(mx.nd.sum(g).asnumpy()) == 6.0
    r = mx.nd.elemwise_add(g, g)
    assert r.stype == "default" and float(r.asnumpy()[0, 0]) == 2.0
    np.testing.assert_array_equal((g * 3).asnumpy(), g.asnumpy() * 3)
    with pytest.raises(mx.MXNetError, match="would be mutated"):
        mx.nd.sgd_mom_update(mx.nd.ones((4, 3)), g,
                             _rsp(mx, [1], 0.0, (4, 3)), lr=0.1)
    with pytest.raises(mx.MXNetError, match="no dense tensor"):
        g.tensor
    with pytest.raises(mx.MXNetError):
        g += 1


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizers_update_row_sparse_gradients_lazily(name):
    """SGD(momentum) and Adam through an Updater, three steps of row_sparse
    gradients with repeated ids: the JAX package's weights and states
    bit for bit, untouched rows unchanged."""
    kw = {"sgd": dict(learning_rate=0.1, momentum=0.9, wd=0.01),
          "adam": dict(learning_rate=0.05, wd=0.01)}[name]
    res = []
    for pkg in (mx, jmx):
        upd = pkg.optimizer.get_updater(pkg.optimizer.create(name, **kw))
        w = pkg.nd.array(np.linspace(-1, 1, 18, dtype=np.float32)
                         .reshape(6, 3))
        for step, rows in enumerate(([1, 4], [4, 4, 0], [1])):
            vals = np.float32(0.1 * (step + 1)) * np.ones(
                (len(rows), 3), np.float32)
            g = pkg.nd.sparse.RowSparseNDArray(
                pkg.nd.array(vals), pkg.nd.array(np.array(rows, np.int64),
                                                 dtype=np.int64), (6, 3))
            upd(0, g, w)
        res.append(w.asnumpy())
    np.testing.assert_array_equal(res[0], res[1])
    start = np.linspace(-1, 1, 18, dtype=np.float32).reshape(6, 3)
    np.testing.assert_array_equal(res[0][[2, 3, 5]], start[[2, 3, 5]])


@pytest.mark.parametrize("name", ["adamax", "rmsprop", "adagrad"])
def test_other_optimizers_densify_row_sparse_gradients(name):
    """An optimizer with no lazy op densifies a row_sparse gradient (the
    storage fallback): three Updater steps match the JAX package's within
    1e-6 relative, and the untouched rows decay under wd as dense rows."""
    res = []
    for pkg in (mx, jmx):
        upd = pkg.optimizer.get_updater(pkg.optimizer.create(
            name, learning_rate=0.05, wd=0.01))
        w = pkg.nd.array(np.linspace(-1, 1, 18, dtype=np.float32)
                         .reshape(6, 3))
        for step, rows in enumerate(([1, 4], [4, 0], [1])):
            vals = np.float32(0.1 * (step + 1)) * np.ones(
                (len(rows), 3), np.float32)
            g = pkg.nd.sparse.RowSparseNDArray(
                pkg.nd.array(vals), pkg.nd.array(np.array(rows, np.int64),
                                                 dtype=np.int64), (6, 3))
            upd(0, g, w)
        res.append(w.asnumpy())
    np.testing.assert_allclose(res[0], res[1], rtol=1e-6, atol=1e-7)
    start = np.linspace(-1, 1, 18, dtype=np.float32).reshape(6, 3)
    assert not np.array_equal(res[0][[2, 3, 5]], start[[2, 3, 5]])


# -- KVStore ---------------------------------------------------------------------

def test_row_sparse_pull_push_retain_loop_makes_no_host_read():
    """The embedding loop of ``tests/test_sparse.py``: row_sparse_pull,
    retain and a sparse push every step, duplicate ids included, with no
    host read inside the loop; the table equals the JAX package's."""
    vocab, dim, steps = 64, 16, 5
    rng = np.random.RandomState(13)
    table = rng.randn(vocab, dim).astype(np.float32)
    ids = [rng.randint(0, vocab, (8,)).astype(np.float32)
           for _ in range(steps)]
    res = []
    for pkg in (mx, jmx):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.array(table))
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1))
        out = pkg.nd.sparse.zeros("row_sparse", (vocab, dim))
        rids = [pkg.nd.array(i) for i in ids]
        with (host_reads() if pkg is mx else contextlib.nullcontext([])) \
                as calls:
            for rid in rids:
                kv.row_sparse_pull("w", out=out, row_ids=rid)
                kv.push("w", out.retain(rid))
        assert calls == []
        res.append(kv._stored["w"].asnumpy())
    np.testing.assert_array_equal(res[0], res[1])


def test_row_sparse_pull_duplicate_ids_into_sparse_and_dense_outputs():
    """Duplicated ids stay (sorted, static shapes) and carry equal rows, so
    the dense view is the row once: ``index_put`` with duplicates."""
    table = np.arange(24, dtype=np.float32).reshape(6, 4)
    rid = np.array([4, 1, 4, 9], np.float32)   # a duplicate, one past the end
    res = []
    for pkg in (mx, jmx):
        kv = pkg.kv.create("local")
        kv.init("e", pkg.nd.array(table))
        out = pkg.nd.sparse.zeros("row_sparse", (6, 4))
        kv.row_sparse_pull("e", out=out, row_ids=pkg.nd.array(rid))
        dense = pkg.nd.zeros((6, 4))
        kv.row_sparse_pull("e", out=dense, row_ids=pkg.nd.array(rid))
        res.append((out.indices.asnumpy(), out.data.asnumpy(),
                    out.asnumpy(), dense.asnumpy()))
    for t, j in zip(*res):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(res[0][0], [1, 4, 4, 5])


def test_a_sum_of_sparse_copies_reaches_the_updater():
    """Two row_sparse copies of a key: their sum over the ids they name."""
    kv = mx.kv.create("device")
    kv.init("e", mx.nd.zeros((5, 2)))
    seen = {}
    kv.set_updater(lambda k, g, w: seen.setdefault(k, g))
    kv.push("e", [_rsp(mx, [0, 3], 1.0, (5, 2)),
                  _rsp(mx, [3, 4], 2.0, (5, 2))])
    g = seen["e"]
    assert g.stype == "row_sparse"
    np.testing.assert_array_equal(g.indices.asnumpy(), [0, 3, 3, 4])
    np.testing.assert_array_equal(
        g.asnumpy(), [[1, 1], [0, 0], [0, 0], [3, 3], [2, 2]])


def test_tpu_ici_sparse_push_is_not_dropped():
    """``tests/test_kvstore_ici.py::test_sparse_push_not_dropped`` on the
    port: a row_sparse value takes the base store's path, not the dense
    collective over its placeholder."""
    kv = mx.kv.create("tpu_ici")
    kv.init("emb", mx.nd.zeros((4, 2)))
    seen = {}
    kv.set_updater(lambda k, g, w: seen.setdefault(k, g))
    kv.push("emb", [_rsp(mx, [0, 2], 1.0, (4, 2))])
    np.testing.assert_array_equal(seen["emb"].asnumpy(),
                                  [[1, 1], [0, 0], [1, 1], [0, 0]])
    plain = mx.kv.create("tpu_ici")
    plain.init("emb", mx.nd.zeros((4, 2)))
    plain.push("emb", [_rsp(mx, [1], 3.0, (4, 2))])
    out = mx.nd.zeros((4, 2))
    plain.pull("emb", out=out)
    np.testing.assert_array_equal(out.asnumpy(), [[0, 0], [3, 3], [0, 0],
                                                  [0, 0]])


# -- LibSVM linear model, convert, symbols --------------------------------------

def _libsvm(tmp_path, n, dim, per_row, seed, one_valued=False):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(dim).astype(np.float32)
    lines = []
    for _ in range(n):   # tests/test_sparse.py's generator
        cols = rng.choice(dim, size=per_row, replace=False)
        vals = np.ones(per_row, np.float32) if one_valued \
            else rng.randn(per_row).astype(np.float32)
        y = float(vals @ w_true[cols])
        if one_valued:
            y = float(y > 0)
        lines.append("%.6f " % y + " ".join(
            "%d:%.6f" % (c, v) for c, v in sorted(zip(cols, vals))))
    path = tmp_path / "train.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path), w_true


def test_libsvm_linear_fit_recovers_its_weights(tmp_path):
    """``tests/test_sparse.py``'s LibSVM regression on the port: CSR
    batches, ``sparse.dot`` forward and transposed; the first epoch's
    weights equal the JAX package's within 1e-5 and 30 epochs recover the
    generating weights."""
    path, w_true = _libsvm(tmp_path, 256, 12, 4, 3)
    fits = {}
    for pkg in (mx, jmx):
        it = pkg.io.LibSVMIter(data_libsvm=path, data_shape=(12,),
                               batch_size=32)
        w = pkg.nd.zeros((12, 1))
        for epoch in range(30 if pkg is mx else 1):
            it.reset()
            for batch in it:
                xb = batch.data[0]
                err = pkg.nd.sparse.dot(xb, w) \
                    - batch.label[0].reshape((-1, 1))
                w -= 0.05 * pkg.nd.sparse.dot(xb, err, transpose_a=True) \
                    / xb.shape[0]
            if epoch == 0:
                fits[pkg] = w.asnumpy().copy()
        fits[pkg, "last"] = w.asnumpy()
    np.testing.assert_allclose(fits[mx], fits[jmx], rtol=1e-5, atol=1e-5)
    assert np.abs(fits[mx, "last"].ravel() - w_true).max() < 0.05


def test_libsvm_logistic_model_through_the_store(tmp_path):
    """The avazu-shaped loop of ``chip_smoke.py`` phase 20c at a small
    width: one-valued features, row_sparse_pull of the batch's columns,
    the logistic gradient as a row_sparse array of those columns, a lazy
    momentum SGD in the store.  The weights equal the JAX package's
    within 1e-5 over two epochs, and rows no batch touched keep their
    value."""
    path, _ = _libsvm(tmp_path, 128, 40, 3, 5, one_valued=True)
    res = []
    for pkg in (mx, jmx):
        it = pkg.io.LibSVMIter(data_libsvm=path, data_shape=(40,),
                               batch_size=32)
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.array(np.full((40, 1), 0.01, np.float32)))
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.5,
                                              momentum=0.9))
        w = pkg.nd.sparse.zeros("row_sparse", (40, 1))
        for _ in range(2):
            it.reset()
            for batch in it:
                x = batch.data[0]
                cols = x.indices
                kv.row_sparse_pull("w", out=w, row_ids=cols)
                p = pkg.nd.sigmoid(pkg.nd.sparse.dot(x, w.todense()))
                err = (p - batch.label[0].reshape((-1, 1))) / x.shape[0]
                g = pkg.nd.sparse.dot(x, err, transpose_a=True)
                grad = pkg.nd.sparse.RowSparseNDArray(
                    pkg.nd.take(g, w.indices), w.indices, (40, 1))
                kv.push("w", grad)
        res.append(kv._stored["w"].asnumpy())
    np.testing.assert_allclose(res[0], res[1], rtol=1e-5, atol=1e-6)
    text = open(path).read().split()
    used = {int(t.split(":")[0]) for t in text if ":" in t}
    untouched = sorted(set(range(40)) - used)
    np.testing.assert_array_equal(res[0][untouched], 0.01)


def test_convert_carries_sparse_arrays_from_the_jax_package():
    d = _rand_dense((5, 4), seed=21)
    jr = jsp.row_sparse_array(d)
    jc = jsp.csr_matrix(d)
    r = convert.sparse_from_numpy("row_sparse", jr.shape,
                                  jr.data.asnumpy(), jr.indices.asnumpy())
    c = convert.sparse_from_numpy("csr", jc.shape, jc.data.asnumpy(),
                                  jc.indices.asnumpy(), jc.indptr.asnumpy())
    assert (r.stype, c.stype) == ("row_sparse", "csr")
    np.testing.assert_array_equal(r.asnumpy(), d)
    np.testing.assert_array_equal(c.asnumpy(), d)
    np.testing.assert_array_equal(c.indptr.asnumpy(), jc.indptr.asnumpy())


def test_var_takes_stype_and_leaves_it_out_of_the_graph():
    for pkg in (mx, jmx):
        v = pkg.sym.var("w", stype="row_sparse", shape=(4, 2))
        assert "stype" not in str(v.attr_dict())
    assert mx.sym.var("w", stype="csr").tojson() == \
        jmx.sym.var("w", stype="csr").tojson()
