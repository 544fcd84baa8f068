"""The port's ``gluon.data.vision`` (datasets and transforms) and
``RecordFileDataset`` against the JAX package, on the CPU.

CIFAR-10/100 python batches, MNIST/FashionMNIST idx files (plain and
gzipped) and the synthetic fallback of an empty root give identical
arrays; a partial dataset raises in both; the transforms agree within
1e-6 (the same numpy arithmetic, the same seeded draws); the record
datasets give the same records and pixels; and BASELINE config 3's
pipeline (CIFAR-10 -> ToTensor/Normalize -> DataLoader) feeds a ResNet-18
thumbnail whose batch-2 training step agrees with the JAX package's:
outputs within 1e-4 and every gradient within 1e-3 relative L2."""
import gzip
import os
import pickle
import random
import struct

import cv2
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.symbol.symbol import NameManager

PKGS = (jmx, mx)
CIFAR_MEAN = [0.4914, 0.4822, 0.4465]
CIFAR_STD = [0.2023, 0.1994, 0.2010]


def _vision(pkg):
    return pkg.gluon.data.vision


def write_cifar(root, n=12, seed=0, hundred=False):
    """The python pickle batches of CIFAR-10 (or CIFAR-100) under root."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "cifar-100-python" if hundred
                     else "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    names = ["train", "test"] if hundred else \
        ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]
    for name in names:
        batch = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8)}
        if hundred:
            batch[b"fine_labels"] = list(rng.randint(0, 100, n))
            batch[b"coarse_labels"] = list(rng.randint(0, 20, n))
        else:
            batch[b"labels"] = list(rng.randint(0, 10, n))
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(batch, f)
    return d


def write_mnist(root, n=10, seed=0, gz=False):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for prefix in ("train", "t10k"):
        opener = gzip.open if gz else open
        suffix = ".gz" if gz else ""
        with opener(os.path.join(root, "%s-images-idx3-ubyte%s"
                                 % (prefix, suffix)), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
                    .tobytes())
        with opener(os.path.join(root, "%s-labels-idx1-ubyte%s"
                                 % (prefix, suffix)), "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(rng.randint(0, 10, n).astype(np.uint8).tobytes())


def _arrays(ds):
    return ds._data.asnumpy(), np.asarray(ds._label)


def _same_dataset(a, b):
    (da, la), (db, lb) = _arrays(a), _arrays(b)
    assert da.dtype == db.dtype == np.uint8
    np.testing.assert_array_equal(da, db)
    np.testing.assert_array_equal(la, lb)
    assert len(a) == len(b)
    for i in (0, len(b) - 1):
        (xa, ya), (xb, yb) = a[i], b[i]
        np.testing.assert_array_equal(xa.asnumpy(), xb.asnumpy())
        assert ya == yb
    assert b[0][0].context == mx.cpu()


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_and_100(tmp_path, train):
    write_cifar(str(tmp_path / "c10"))
    write_cifar(str(tmp_path / "c100"), hundred=True)
    a, b = (_vision(p).CIFAR10(root=str(tmp_path / "c10"), train=train)
            for p in PKGS)
    _same_dataset(a, b)
    assert _arrays(b)[0].shape == ((60 if train else 12), 32, 32, 3)
    for fine in (True, False):
        a, b = (_vision(p).CIFAR100(root=str(tmp_path / "c100"),
                                    fine_label=fine, train=train)
                for p in PKGS)
        _same_dataset(a, b)


def test_cifar10_partial_raises(tmp_path):
    d = write_cifar(str(tmp_path))
    os.remove(os.path.join(d, "data_batch_3"))
    for pkg in PKGS:
        with pytest.raises(FileNotFoundError, match="data_batch_3"):
            _vision(pkg).CIFAR10(root=str(tmp_path))


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_files(tmp_path, gz, cls):
    write_mnist(str(tmp_path), gz=gz)
    for train in (True, False):
        a, b = (getattr(_vision(p), cls)(root=str(tmp_path), train=train)
                for p in PKGS)
        _same_dataset(a, b)
        assert _arrays(b)[0].shape == (10, 28, 28, 1)


def test_mnist_partial_raises(tmp_path):
    write_mnist(str(tmp_path))
    os.remove(str(tmp_path / "train-labels-idx1-ubyte"))
    for pkg in PKGS:
        with pytest.raises(FileNotFoundError):
            _vision(pkg).MNIST(root=str(tmp_path))


@pytest.mark.parametrize("cls,kw", [("MNIST", {}), ("CIFAR10", {}),
                                    ("CIFAR100", {"fine_label": False})])
def test_synthetic_fallback(tmp_path, cls, kw):
    for train in (True, False):
        a, b = (getattr(_vision(p), cls)(root=str(tmp_path / p.__name__),
                                         train=train, **kw) for p in PKGS)
        _same_dataset(a, b)


def _transforms(pkg):
    t = _vision(pkg).transforms
    return {
        "to_tensor_normalize": t.Compose([t.ToTensor(),
                                          t.Normalize(CIFAR_MEAN, CIFAR_STD)]),
        "cast": t.Cast("float64"),
        "resize": t.Resize(20),
        "resize_keep": t.Resize(20, keep_ratio=True),
        "resize_pair": t.Resize((24, 18), interpolation=2),
        "center_crop": t.CenterCrop(20),
        "random_resized_crop": t.RandomResizedCrop(20),
        "flip_lr": t.RandomFlipLeftRight(),
        "flip_tb": t.RandomFlipTopBottom(),
        "brightness": t.RandomBrightness(0.3),
        "contrast": t.RandomContrast(0.3),
        "saturation": t.RandomSaturation(0.3),
        "hue": t.RandomHue(0.2),
        "color_jitter": t.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
        "lighting": t.RandomLighting(0.1),
    }


@pytest.mark.parametrize("name", sorted(_transforms(mx)))
def test_transforms(name):
    img = cv2.GaussianBlur(np.random.RandomState(3).randint(
        0, 256, (30, 36, 3)).astype(np.uint8), (5, 5), 1.0)
    numpy_in = name in ("resize", "resize_keep", "resize_pair",
                        "center_crop", "random_resized_crop")
    floats = name in ("brightness", "contrast", "saturation", "hue",
                      "color_jitter", "lighting")
    outs = []
    for pkg in PKGS:
        x = img.astype(np.float32) if floats else img
        if not numpy_in:
            x = pkg.nd.array(x, ctx=pkg.cpu())
        for seed in (0, 1, 2):
            random.seed(seed)
            np.random.seed(seed)
            out = _transforms(pkg)[name](x)
            outs.append(np.asarray(out.asnumpy() if hasattr(out, "asnumpy")
                                   else out))
    half = len(outs) // 2
    for a, b in zip(outs[:half], outs[half:]):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


@pytest.fixture
def rec_file(tmp_path):
    rng = np.random.RandomState(5)
    w = jrec.MXIndexedRecordIO(str(tmp_path / "r.idx"),
                               str(tmp_path / "r.rec"), "w")
    for i in range(7):
        img = cv2.GaussianBlur(rng.randint(0, 256, (20, 24, 3))
                               .astype(np.uint8), (3, 3), 1.0)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i), i, 0), img))
    w.close()
    return str(tmp_path / "r.rec")


def test_record_file_dataset(rec_file):
    a = jmx.gluon.data.RecordFileDataset(rec_file)
    b = mx.gluon.data.RecordFileDataset(rec_file)
    assert len(a) == len(b) == 7
    assert [a[i] for i in range(7)] == [b[i] for i in range(7)]


@pytest.mark.parametrize("flag", [1, 0])
def test_image_record_dataset(rec_file, flag):
    a, b = (_vision(p).ImageRecordDataset(rec_file, flag=flag) for p in PKGS)
    for i in range(7):
        (xa, ya), (xb, yb) = a[i], b[i]
        np.testing.assert_array_equal(xa.asnumpy(), xb.asnumpy())
        assert ya == yb
    a, b = (_vision(p).ImageRecordDataset(
        rec_file, transform=lambda x, y: (x.astype("float32") / 2, y + 1))
        for p in PKGS)
    np.testing.assert_array_equal(a[3][0].asnumpy(), b[3][0].asnumpy())
    assert a[3][1] == b[3][1]


def test_image_folder_dataset(tmp_path):
    rng = np.random.RandomState(6)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / cls)
        for i in range(3):
            cv2.imwrite(str(tmp_path / cls / ("%d.png" % i)),
                        rng.randint(0, 256, (10, 12, 3)).astype(np.uint8))
    (tmp_path / "cat" / "notes.txt").write_text("skipped")
    a, b = (_vision(p).ImageFolderDataset(str(tmp_path)) for p in PKGS)
    assert a.synsets == b.synsets == ["cat", "dog"]
    assert a.items == b.items and len(b) == 6
    for i in range(6):
        np.testing.assert_array_equal(a[i][0].asnumpy(), b[i][0].asnumpy())


def _cifar_batches(pkg, root, batch, n_batches):
    t = _vision(pkg).transforms
    transform = t.Compose([t.ToTensor(), t.Normalize(CIFAR_MEAN, CIFAR_STD)])
    np.random.seed(9)  # the loader's RandomSampler draws from numpy
    loader = pkg.gluon.data.DataLoader(
        _vision(pkg).CIFAR10(root=root, train=True).transform_first(
            lambda x: transform(x)),
        batch_size=batch, shuffle=True, last_batch="discard")
    out = []
    with pkg.cpu():
        for data, label in loader:
            out.append((data.asnumpy(), label.asnumpy()))
            if len(out) == n_batches:
                break
    return out


def test_cifar_loader_batches(tmp_path):
    write_cifar(str(tmp_path))
    a, b = (_cifar_batches(p, str(tmp_path), 8, 4) for p in PKGS)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xb.shape == (8, 3, 32, 32) and xb.dtype == np.float32
        np.testing.assert_allclose(xb, xa, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ya, yb)


def _resnet18(pkg):
    names = NameManager if pkg is mx else JNameManager
    with names():
        return pkg.gluon.model_zoo.vision.get_model(
            "resnet18_v1", classes=10, thumbnail=True)


def _weights(net, seed=0):
    """Well-scaled weights: He-normal convolutions and dense weights,
    gamma and the moving variance near 1, beta, biases and the moving
    mean near 0."""
    r = np.random.RandomState(seed)
    out = {}
    for name, p in net.collect_params().items():
        shape = tuple(p.shape)
        if name.endswith(("gamma", "running_var")):
            v = 1 + 0.1 * r.uniform(-1, 1, shape)
        elif name.endswith(("beta", "running_mean", "bias")):
            v = 0.1 * r.uniform(-1, 1, shape)
        else:
            v = r.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        out[name] = v.astype(np.float32)
    return out


def _step(pkg, weights, x, y):
    net = _resnet18(pkg)
    ctx = pkg.cpu()
    net.infer_shape(pkg.nd.array(x, ctx=ctx))
    if pkg is mx:
        mx.convert.set_gluon_params(net, weights, ctx=ctx)
    else:
        for name, p in net.collect_params().items():
            p._load_init(jmx.nd.array(weights[name], ctx=ctx), ctx)
    net.hybridize()
    with pkg.autograd.record():
        out = net(pkg.nd.array(x, ctx=ctx))
        loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
            out, pkg.nd.array(y, ctx=ctx))
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in net.collect_params().items()
             if p.grad_req != "null"}
    return out.asnumpy(), grads


def test_resnet18_thumbnail_step_on_cifar_batches(tmp_path):
    write_cifar(str(tmp_path))
    (x, y), = _cifar_batches(mx, str(tmp_path), 2, 1)
    net = _resnet18(mx)
    net.infer_shape(mx.nd.array(x, ctx=mx.cpu()))
    weights = _weights(net)
    out, grads = _step(mx, weights, x, y)
    out_j, grads_j = _step(jmx, weights, x, y)
    assert np.all(np.isfinite(out))

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)

    assert rel(out, out_j) <= 1e-4
    assert len(grads) == len(grads_j) > 40
    worst = max((rel(grads[k], grads_j[k]), k) for k in grads_j)
    assert worst[0] <= 1e-3, worst
