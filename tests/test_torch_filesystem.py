"""Checkpoints over a registered URI scheme, between the port and the JAX
package.

A ``mem://`` scheme backed by one in-memory object store is registered in
both packages' ``filesystem`` registries.  ``nd.save``/``nd.load``,
``model.save_checkpoint``/``load_checkpoint`` and Gluon's
``save_parameters``/``load_parameters`` round-trip through it in the
port, and each file the port writes there is read back by the JAX
package and the other way round.  Everything is exact: the symbol JSON
and the ``.params`` blobs are compared byte for byte, arrays bit for
bit.
"""
import io

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import filesystem as jfs
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import filesystem as tfs
from mxnet_tpu_torch.symbol import NameManager

PACKAGES = {"port": (mx, NameManager), "jax": (jmx, JNameManager)}
DIRECTIONS = [("port", "jax"), ("jax", "port"), ("port", "port")]


class _MemStore:
    """A dict-backed object store whose writes publish on close."""

    def __init__(self):
        self.blobs = {}

    def opener(self, path, mode):
        store = self
        if mode.startswith("r"):
            if path not in store.blobs:
                raise FileNotFoundError("mem://" + path)
            raw = store.blobs[path]
            return io.StringIO(raw.decode()) if mode == "r" \
                else io.BytesIO(raw)

        class _Writer(io.BytesIO):
            def close(self):
                store.blobs[path] = self.getvalue()
                super().close()

        class _TextWriter(io.StringIO):
            def close(self):
                store.blobs[path] = self.getvalue().encode()
                super().close()

        return _TextWriter() if mode == "w" else _Writer()


@pytest.fixture()
def mem():
    store = _MemStore()
    prev = [fs.register_scheme("mem", store.opener) for fs in (tfs, jfs)]
    yield store
    for fs, old in zip((tfs, jfs), prev):
        if old is None:
            fs.unregister_scheme("mem")
        else:
            fs.register_scheme("mem", old)


def _arrays(pkg, seed=0):
    rng = np.random.RandomState(seed)
    values = {"w": rng.rand(3, 4).astype(np.float32),
              "b": rng.rand(3).astype(np.float32),
              "i": rng.randint(0, 9, (2, 5)).astype(np.int32)}
    kw = {"ctx": mx.cpu()} if pkg is mx else {}
    return values, {k: pkg.nd.array(v, dtype=v.dtype, **kw)
                    for k, v in values.items()}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_nd_save_load_over_mem(mem, writer, reader):
    wpkg, rpkg = PACKAGES[writer][0], PACKAGES[reader][0]
    values, arrays = _arrays(wpkg)
    wpkg.nd.save("mem://nd/dict.params", arrays)
    wpkg.nd.save("mem://nd/list.params", [arrays["w"], arrays["i"]])
    assert {"nd/dict.params", "nd/list.params"} <= set(mem.blobs)
    got = rpkg.nd.load("mem://nd/dict.params")
    assert sorted(got) == sorted(values)
    for k, v in values.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
        assert got[k].asnumpy().dtype == v.dtype
    listed = rpkg.nd.load("mem://nd/list.params")
    np.testing.assert_array_equal(listed[0].asnumpy(), values["w"])
    np.testing.assert_array_equal(listed[1].asnumpy(), values["i"])


def test_nd_save_blob_equals_local_file(mem, tmp_path):
    """A scheme's blob holds the bytes a local save writes, and a local
    save still goes through a temporary file that it renames away."""
    _, arrays = _arrays(mx)
    mx.nd.save("mem://nd/a.params", arrays)
    local = tmp_path / "a.params"
    mx.nd.save(str(local), arrays)
    assert local.read_bytes() == mem.blobs["nd/a.params"]
    assert not (tmp_path / "a.params.tmp").exists()


def _fc_net(pkg, names):
    with names():
        return pkg.sym.SoftmaxOutput(
            pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=3,
                                   name="fc"), name="softmax")


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_checkpoint_roundtrip_over_mem(mem, writer, reader):
    (wpkg, wnames), (rpkg, _) = PACKAGES[writer], PACKAGES[reader]
    net = _fc_net(wpkg, wnames)
    rng = np.random.RandomState(1)
    values = {"fc_weight": rng.rand(3, 4).astype(np.float32),
              "fc_bias": rng.rand(3).astype(np.float32)}
    kw = {"ctx": mx.cpu()} if wpkg is mx else {}
    args = {k: wpkg.nd.array(v, **kw) for k, v in values.items()}
    wpkg.model.save_checkpoint("mem://ckpt/model", 7, net, args, {})
    assert {"ckpt/model-symbol.json", "ckpt/model-0007.params"} \
        <= set(mem.blobs)
    sym2, args2, aux2 = rpkg.model.load_checkpoint("mem://ckpt/model", 7)
    assert sym2.list_arguments() == net.list_arguments()
    assert sym2.tojson() == net.tojson()
    for k, v in values.items():
        np.testing.assert_array_equal(args2[k].asnumpy(), v)
    assert aux2 == {}


def test_checkpoint_blobs_are_the_jax_packages_bytes(mem):
    """The port's checkpoint over the scheme is byte for byte the JAX
    package's of the same net and values."""
    blobs = {}
    for side in ("port", "jax"):
        pkg, names = PACKAGES[side]
        net = _fc_net(pkg, names)
        rng = np.random.RandomState(2)
        kw = {"ctx": mx.cpu()} if pkg is mx else {}
        args = {"fc_weight": pkg.nd.array(rng.rand(3, 4).astype(np.float32),
                                          **kw),
                "fc_bias": pkg.nd.array(rng.rand(3).astype(np.float32),
                                        **kw)}
        pkg.model.save_checkpoint("mem://%s/m" % side, 0, net, args, {})
        blobs[side] = (mem.blobs["%s/m-symbol.json" % side],
                       mem.blobs["%s/m-0000.params" % side])
    assert blobs["port"] == blobs["jax"]


def _dense(pkg, names):
    with names():
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(8, in_units=5, activation="relu"))
            net.add(pkg.gluon.nn.Dense(3, in_units=8))
    return net


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_gluon_parameters_over_mem(mem, writer, reader):
    (wpkg, wnames), (rpkg, rnames) = PACKAGES[writer], PACKAGES[reader]
    src = _dense(wpkg, wnames)
    src.initialize(wpkg.initializer.Uniform(0.5),
                   **({"ctx": mx.cpu()} if wpkg is mx else {}))
    want = {k.split("_", 1)[1]: v.data().asnumpy()
            for k, v in src.collect_params().items()}
    src.save_parameters("mem://gluon/net.params")
    assert "gluon/net.params" in mem.blobs
    dst = _dense(rpkg, rnames)
    dst.load_parameters("mem://gluon/net.params",
                        **({"ctx": mx.cpu()} if rpkg is mx else {}))
    got = {k.split("_", 1)[1]: v.data().asnumpy()
           for k, v in dst.collect_params().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_unregistered_scheme_raises_naming_the_fix():
    _, arrays = _arrays(mx)
    tfs.unregister_scheme("nowhere")
    with pytest.raises(mx.MXNetError, match="register_scheme"):
        mx.nd.save("nowhere://x.params", arrays)
    with pytest.raises(mx.MXNetError, match="register_scheme"):
        mx.sym.load("nowhere://x-symbol.json")
