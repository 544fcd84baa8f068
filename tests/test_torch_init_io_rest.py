"""The rest of the initializers, the iterators, AttrScope and name
prefixes: the port against the JAX package on the CPU.

Deterministic initializers must agree exactly; the random ones
(Orthogonal, MSRAPrelu) draw from different generators in the two
packages, so they are held to their defining properties.  The file
iterators read files the tests write (no download) and must give the
same batches as the JAX package's.
"""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt


def _host(mx, shape):
    return mx.nd.zeros(shape, ctx=mx.cpu())


def _both(fn):
    return fn(mt), fn(mj)


@pytest.mark.parametrize("name,make,shape", [
    ("upsampling_weight", lambda mx: mx.initializer.Bilinear(), (2, 1, 4, 5)),
    ("lstm_i2h_bias", lambda mx: mx.initializer.LSTMBias(0.7), (16,)),
    ("fc_weight", lambda mx: mx.initializer.Mixed(
        ["fc_.*", ".*"], [mx.initializer.Constant(0.3),
                          mx.initializer.Zero()]), (3, 4)),
    ("conv_bias", lambda mx: mx.initializer.Mixed(
        ["fc_.*", ".*"], [mx.initializer.Constant(0.3),
                          mx.initializer.One()]), (3,)),
], ids=["bilinear", "lstm_bias", "mixed_first", "mixed_fallback"])
def test_deterministic_initializers_match_exactly(name, make, shape):
    got, want = _both(lambda mx: _host(mx, shape))
    make(mt)(name, got)
    make(mj)(name, want)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_legacy_prefix_rules_match():
    for name, shape in (("upsampling0_weight", (1, 1, 4, 4)),
                        ("stn_loc_weight", (6, 3)),
                        ("stn_loc_bias", (6,))):
        got, want = _both(lambda mx: _host(mx, shape))
        mt.initializer.Uniform(0.5)(name, got)
        mj.initializer.Uniform(0.5)(name, want)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_load_initializer_matches(tmp_path):
    r = np.random.RandomState(0)
    params = {"arg:fc_weight": r.rand(3, 4).astype(np.float32)}
    fname = str(tmp_path / "p.params")
    mj.nd.save(fname, {k: mj.nd.array(v) for k, v in params.items()})
    for mx in (mt, mj):
        init = mx.initializer.Load(fname,
                                   default_init=mx.initializer.Constant(2))
        w, b = _host(mx, (3, 4)), _host(mx, (3,))
        init("fc_weight", w)
        init("fc_bias", b)
        np.testing.assert_array_equal(w.asnumpy(), params["arg:fc_weight"])
        np.testing.assert_array_equal(b.asnumpy(), 0.0)  # bias rule
        with pytest.raises(ValueError):
            mx.initializer.Load(fname)("other_weight", w)
        with pytest.raises(ValueError):
            init("fc_weight", _host(mx, (4, 3)))


@pytest.mark.parametrize("shape", [(4, 6), (6, 4), (3, 2, 2, 2)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_orthonormal(shape, rand_type):
    for mx in (mt, mj):
        arr = _host(mx, shape)
        mx.initializer.Orthogonal(scale=1.5, rand_type=rand_type)(
            mx.initializer.InitDesc("q_weight"), arr)
        m = arr.asnumpy().reshape(shape[0], -1) / 1.5
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-5)


def test_msra_prelu_scale_and_dumps():
    shape = (64, 50)
    arr = _host(mt, shape)
    init = mt.initializer.MSRAPrelu(factor_type="in", slope=0.25)
    init(mt.initializer.InitDesc("p_weight"), arr)
    std = np.sqrt(2.0 / (1 + 0.25 ** 2) / 50)
    assert abs(arr.asnumpy().std() / std - 1) < 0.1
    assert init.dumps() == mj.initializer.MSRAPrelu(
        factor_type="in", slope=0.25).dumps()
    for cls in ("Bilinear", "LSTMBias", "Orthogonal", "FusedRNN"):
        assert cls.lower() in mt.initializer._REGISTRY


def _write_idx(tmp_path, n, gz):
    r = np.random.RandomState(5)
    images = r.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = r.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    img = str(tmp_path / ("train-images-idx3-ubyte" + (".gz" if gz else "")))
    lab = str(tmp_path / ("train-labels-idx1-ubyte" + (".gz" if gz else "")))
    with opener(img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(lab, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return img, lab


def _drain(it, epochs=1):
    out = []
    for _ in range(epochs):
        it.reset()
        for batch in it:
            out.append(([d.asnumpy() for d in batch.data],
                        [l.asnumpy() for l in batch.label], batch.pad))
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gz,flat", [(False, False), (True, True)])
def test_mnist_iter_matches_jax(tmp_path, gz, flat):
    img, lab = _write_idx(tmp_path, 40, gz)
    its = [mx.io.MNISTIter(image=img, label=lab, batch_size=16,
                           shuffle=True, flat=flat, seed=3)
           for mx in (mt, mj)]
    assert [tuple(d.shape) for d in its[0].provide_data] == \
        [tuple(d.shape) for d in its[1].provide_data]
    _same_batches(_drain(its[0]), _drain(its[1]))


def test_mnist_iter_partial_files_raise(tmp_path):
    img, _ = _write_idx(tmp_path, 8, False)
    with pytest.raises(mt.MXNetError):
        mt.io.MNISTIter(image=img, label=str(tmp_path / "missing"))


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    r = np.random.RandomState(2)
    data = r.rand(10, 6).astype(np.float32)
    label = r.randint(0, 3, 10).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    its = [mx.io.CSVIter(data_csv=str(tmp_path / "d.csv"),
                         data_shape=(2, 3),
                         label_csv=str(tmp_path / "l.csv"), batch_size=4,
                         round_batch=round_batch) for mx in (mt, mj)]
    _same_batches(_drain(its[0], 2), _drain(its[1], 2))
    via_name = mt.io.MXDataIter("CSVIter", data_csv=str(tmp_path / "d.csv"),
                                data_shape=(6,), batch_size=5)
    assert via_name.provide_data[0].shape == (5, 6)


def test_libsvm_iter_matches_jax(tmp_path):
    path = tmp_path / "d.libsvm"
    path.write_text("1 0:1.5 3:2\n0 2:-1\n# comment\n1 1:0.5 2:0.25 4:3\n"
                    "0\n1 4:1\n")
    got_it, want_it = [mx.io.LibSVMIter(data_libsvm=str(path),
                                        data_shape=(5,), batch_size=2)
                       for mx in (mt, mj)]
    assert [tuple(d.shape) for d in got_it.provide_data] == \
        [tuple(d.shape) for d in want_it.provide_data]
    got, want = list(got_it), list(want_it)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.pad == w.pad
        gd, wd = g.data[0], w.data[0]
        assert gd.stype == wd.stype == "csr"
        np.testing.assert_array_equal(gd.tostype("default").asnumpy(),
                                      wd.tostype("default").asnumpy())
        np.testing.assert_array_equal(gd.indptr.asnumpy(),
                                      wd.indptr.asnumpy())
        np.testing.assert_array_equal(g.label[0].asnumpy(),
                                      w.label[0].asnumpy())
    assert mt.io.MXDataIter("LibSVMIter", data_libsvm=str(path),
                            data_shape=(5,)).num_rows == 5


def test_resize_iter_matches_jax():
    r = np.random.RandomState(1)
    x = r.rand(10, 3).astype(np.float32)
    y = r.rand(10).astype(np.float32)
    its = [mx.io.ResizeIter(mx.io.NDArrayIter(x, y, batch_size=4), 5)
           for mx in (mt, mj)]
    got, want = _drain(its[0], 2), _drain(its[1], 2)
    assert len(got) == 10
    _same_batches(got, want)


def test_prefetching_iter_matches_jax_and_joins():
    r = np.random.RandomState(1)
    x1, x2 = r.rand(12, 3).astype(np.float32), r.rand(12, 2).astype(
        np.float32)
    y = r.rand(12).astype(np.float32)
    out = []
    for mx in (mt, mj):
        it = mx.io.PrefetchingIter(
            [mx.io.NDArrayIter(x1, y, batch_size=4),
             mx.io.NDArrayIter(x2, y, batch_size=4, data_name="other",
                               label_name="other_label")],
            rename_data=[{"data": "a"}, {"other": "b"}])
        assert [d.name for d in it.provide_data] == ["a", "b"]
        out.append(_drain(it, 2))
        it.close()
    _same_batches(*out)
    assert not [t for t in mt.threads.live_package_threads()
                if "/io/prefetch" in t.name]
    with pytest.raises(mt.MXNetError):
        it = mt.io.PrefetchingIter(mt.io.NDArrayIter(x1, y, batch_size=4))
        it.close()
        it.reset()


def _scoped(mx):
    with mx.AttrScope(ctx_group="dev1", __lr_mult__="0.5"):
        data = mx.sym.Variable("data")
        with mx.AttrScope(ctx_group="dev2"):
            fc = mx.sym.FullyConnected(data, num_hidden=4, name="fc",
                                       attr={"__wd_mult__": "0"})
    with mx.name.Prefix("pre_"):
        act = mx.sym.Activation(fc, act_type="relu")
        out = mx.sym.FullyConnected(act, num_hidden=2)
    return out


def test_attr_scope_and_name_prefix_match_jax():
    got, want = _both(_scoped)
    assert got.tojson() == want.tojson()
    assert got.attr_dict() == want.attr_dict()
    assert got.list_arguments() == want.list_arguments()
    assert "pre_fullyconnected0_weight" in got.list_arguments()
    assert got.attr_dict()["fc_weight"]["ctx_group"] == "dev2"
    assert got.attr_dict()["data"] == {"ctx_group": "dev1",
                                       "__lr_mult__": "0.5"}
    assert mt.attribute.AttrScope is mt.AttrScope
    assert mt.name.NameManager is mt.NameManager
    # the scope's attrs ride along into a bound graph unharmed
    exe = got.simple_bind(mt.cpu(), data=(2, 3))
    assert exe.forward()[0].shape == (2, 2)
