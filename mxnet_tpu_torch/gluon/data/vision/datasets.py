"""Vision datasets (ref: python/mxnet/gluon/data/vision.py).

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py``.  Datasets read
the standard file formats from a local root (default
``~/.mxnet/datasets/<name>``); nothing is downloaded.  When the root holds
no files, they substitute synthetic data with a loud chance-level warning
(``test_utils.synthetic_image_dataset``, so example scripts still run); a
partial dataset (some files present, some missing) raises, since that is
a copy mistake rather than a missing download.  The images are host
arrays (``cpu()``), as the reference's are CPU NDArrays.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ..dataset import _DownloadedDataset, RecordFileDataset
from ....context import cpu
from ....ndarray import array
from .... import image as image_mod

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def nd_array(data, dtype=None):
    return array(data, ctx=cpu(), dtype=dtype)


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)


def _find(root, names):
    for name in names:
        p = os.path.join(root, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        "none of %s found under %s; nothing is downloaded: place the "
        "dataset files there" % (names, root))


def _synthetic_fallback(shape_hw, channels, n_train, n_test, train,
                        what, root, num_classes=10):
    from ....test_utils import synthetic_image_dataset
    return synthetic_image_dataset(
        shape_hw, channels, n_train if train else n_test,
        num_classes=num_classes, seed=42 if train else 43,
        what=what, root=root)


class MNIST(_DownloadedDataset):
    """MNIST from idx-ubyte files (ref: vision.py:MNIST)."""

    _base = "mnist"
    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root=None, train=True, transform=None):
        self._train = train
        root = root or os.path.join(os.path.expanduser("~"), ".mxnet",
                                    "datasets", self._base)
        super().__init__(root, transform)

    def _get_data(self):
        img_name, lbl_name = self._files[self._train]
        present = [n for n in (img_name, lbl_name)
                   if os.path.exists(os.path.join(self._root, n))
                   or os.path.exists(os.path.join(self._root, n + ".gz"))]
        if len(present) == 1:
            # a PARTIAL dataset is a user mistake, not a missing download —
            # keep the actionable error instead of silently using noise
            raise FileNotFoundError(
                "found %s but not its counterpart under %s; place both "
                "files there" % (present[0], self._root))
        if present:
            img_path = _find(self._root, [img_name, img_name + ".gz"])
            lbl_path = _find(self._root, [lbl_name, lbl_name + ".gz"])
            data = _read_idx_images(img_path)
            label = _read_idx_labels(lbl_path)
        else:
            data, label = _synthetic_fallback(
                (28, 28), 1, 2048, 512, self._train, self._base, self._root)
        self._data = nd_array(data, dtype=np.uint8)
        self._label = label


class FashionMNIST(MNIST):
    _base = "fashion-mnist"


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python pickle batches (ref: vision.py:CIFAR10)."""

    _prefix = "cifar-10-batches-py"
    _train_batches = ["data_batch_%d" % i for i in range(1, 6)]
    _test_batches = ["test_batch"]
    _label_key = b"labels"

    def __init__(self, root=None, train=True, transform=None):
        self._train = train
        root = root or os.path.join(os.path.expanduser("~"), ".mxnet",
                                    "datasets", "cifar10")
        super().__init__(root, transform)

    def _read_batch(self, path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return data, np.asarray(d[self._label_key], np.int32)

    # synthetic-fallback class count (CIFAR100 overrides)
    _num_classes = 10

    def _get_data(self):
        names = self._train_batches if self._train else self._test_batches
        base = self._root
        if os.path.isdir(os.path.join(base, self._prefix)):
            base = os.path.join(base, self._prefix)
        present = [n for n in names
                   if os.path.exists(os.path.join(base, n))]
        if present and len(present) < len(names):
            # partial dataset: user mistake — keep the actionable error
            missing = sorted(set(names) - set(present))
            raise FileNotFoundError(
                "found %s but missing %s under %s; place all batch files "
                "there" % (present, missing, base))
        if present:
            datas, labels = [], []
            for name in names:
                d, l = self._read_batch(_find(base, [name]))
                datas.append(d)
                labels.append(l)
            data = np.concatenate(datas)
            label = np.concatenate(labels)
        else:
            data, label = _synthetic_fallback(
                (32, 32), 3, 2048, 512, self._train, self._prefix,
                self._root, num_classes=self._num_classes)
        self._data = nd_array(data, dtype=np.uint8)
        self._label = label


class CIFAR100(CIFAR10):
    _prefix = "cifar-100-python"
    _train_batches = ["train"]
    _test_batches = ["test"]

    def __init__(self, root=None, fine_label=True, train=True,
                 transform=None):
        self._label_key = b"fine_labels" if fine_label else b"coarse_labels"
        self._num_classes = 100 if fine_label else 20
        root = root or os.path.join(os.path.expanduser("~"), ".mxnet",
                                    "datasets", "cifar100")
        super().__init__(root=root, train=train, transform=transform)


class ImageRecordDataset(RecordFileDataset):
    """Images packed in a .rec file (ref: vision.py:ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio
        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        img = image_mod.imdecode(img, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(_DownloadedDataset):
    """root/<class>/<img>.jpg layout (ref: vision.py:ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._flag = flag
        self._exts = [".jpg", ".jpeg", ".png"]
        super().__init__(root, transform)

    def _get_data(self):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))
        self._label = [i[1] for i in self.items]

    def __getitem__(self, idx):
        img = image_mod.imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
