"""The port's ``gluon.data`` core (datasets, transforms, samplers,
``DataLoader``) against the JAX package, on the CPU; the cases of
``tests/test_gluon_data.py`` (ArrayDataset and DataLoader, threaded
workers, transforms) run in both packages, then the samplers' three
``last_batch`` modes and ``num_workers`` 0 against 2.  Batches are
compared exactly (the same numpy data, stacked)."""
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import data as jdata

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import data as gdata

PKGS = ((gdata, mx), (jdata, jmx))


def as_numpy(batch):
    if isinstance(batch, (list, tuple)):
        return [as_numpy(b) for b in batch]
    return batch.asnumpy()


def batches(data, pkg, loader):
    with pkg.cpu():  # the port's batches land on the current context
        return [as_numpy(b) for b in loader]


def test_array_dataset_and_loader():
    X = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    Y = np.arange(20, dtype=np.float32)
    got = []
    for data, pkg in PKGS:
        ds = data.ArrayDataset(X, Y)
        assert len(ds) == 20
        x0, y0 = ds[3]
        np.testing.assert_allclose(x0, X[3])
        assert y0 == 3
        keep = batches(data, pkg, data.DataLoader(ds, batch_size=6,
                                                  shuffle=False))
        assert len(keep) == 4
        assert keep[0][0].shape == (6, 3)
        assert keep[-1][0].shape == (2, 3)  # last_batch='keep'
        discard = batches(data, pkg, data.DataLoader(
            ds, batch_size=6, last_batch="discard"))
        assert len(discard) == 3
        got.append((keep, discard))
    for a, b in zip(*got):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])


def test_dataloader_threaded_workers():
    for data, pkg in PKGS:
        ds = data.ArrayDataset(np.arange(64, dtype=np.float32))
        dl = data.DataLoader(ds, batch_size=8, num_workers=3)
        got = np.concatenate(batches(data, pkg, dl))
        np.testing.assert_array_equal(got, np.arange(64))  # in order


def test_dataset_transform_and_transform_first():
    for data, _ in PKGS:
        ds = data.SimpleDataset(list(range(10))).transform(lambda x: x * 2)
        assert ds[4] == 8 and len(ds) == 10
        pairs = data.ArrayDataset(np.arange(5), np.arange(5) + 10)
        first = pairs.transform_first(lambda x: x * 3)
        assert first[2] == (6, 12)
        both = pairs.transform(lambda x, y: x + y, lazy=False)
        assert isinstance(both, data.SimpleDataset) and both[4] == 18
        assert data.SimpleDataset([7, 8]).transform_first(
            lambda x: -x)[1] == -8


def test_array_dataset_rejects_bad_sources():
    for data, _ in PKGS:
        with pytest.raises(AssertionError):
            data.ArrayDataset()
        with pytest.raises(AssertionError):
            data.ArrayDataset(np.arange(3), np.arange(4))
    one_d = mx.nd.array(np.arange(4, dtype=np.float32), ctx=mx.cpu())
    ds = gdata.ArrayDataset(one_d, np.arange(4))
    assert isinstance(ds[1][0], np.float32)  # 1-D arrays read as numpy


@pytest.mark.parametrize("mode", ["keep", "discard", "rollover"])
def test_batch_sampler_last_batch_modes(mode):
    got = []
    for data, _ in PKGS:
        sampler = data.BatchSampler(data.SequentialSampler(10), 4, mode)
        epochs = [list(sampler) for _ in range(3)]
        got.append((epochs, len(sampler)))
    assert got[0] == got[1]
    epochs, _ = got[0]
    if mode == "keep":
        assert epochs[0] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    elif mode == "discard":
        assert epochs[0] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    else:  # the tail opens the next epoch
        assert epochs[1][0] == [8, 9, 0, 1]
    with pytest.raises(ValueError):
        gdata.BatchSampler(gdata.SequentialSampler(3), 2, "pad")


def test_random_sampler_is_a_permutation_from_numpy_seed():
    orders = []
    for data, _ in PKGS:
        np.random.seed(3)
        orders.append(list(data.RandomSampler(12)))
    assert orders[0] == orders[1]
    assert sorted(orders[0]) == list(range(12)) and orders[0] != \
        list(range(12))
    assert list(gdata.SequentialSampler(4)) == [0, 1, 2, 3]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_workers_zero_and_two_give_the_same_batches(last_batch):
    r = np.random.RandomState(1)
    x = r.rand(23, 2, 3).astype(np.float32)
    y = r.randint(0, 9, 23).astype(np.int32)
    ds = gdata.ArrayDataset(x, y)
    runs = {}
    for workers in (0, 2):
        dl = gdata.DataLoader(ds, batch_size=5, last_batch=last_batch,
                              num_workers=workers)
        runs[workers] = [batches(gdata, mx, dl) for _ in range(2)]
        assert len(dl) == len(runs[workers][0])
    jdl = jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=5,
                           last_batch=last_batch)
    want = [batches(jdata, jmx, jdl) for _ in range(2)]
    for got in runs.values():
        for epoch, jepoch in zip(got, want):
            assert len(epoch) == len(jepoch)
            for (bx, by), (jx, jy) in zip(epoch, jepoch):
                np.testing.assert_array_equal(bx, jx)
                np.testing.assert_array_equal(by, jy)
                assert bx.dtype == jx.dtype and by.dtype == jy.dtype


def test_dataloader_argument_rules_and_worker_context():
    ds = gdata.SimpleDataset(np.arange(6, dtype=np.float32))
    with pytest.raises(ValueError):
        gdata.DataLoader(ds)
    with pytest.raises(ValueError):
        gdata.DataLoader(ds, batch_size=2, shuffle=True,
                         sampler=gdata.SequentialSampler(6))
    with pytest.raises(ValueError):
        gdata.DataLoader(ds, batch_size=2, batch_sampler=gdata.BatchSampler(
            gdata.SequentialSampler(6), 2))
    seen = []

    def batchify(items):
        seen.append((threading.current_thread().name,
                     mx.current_context()))
        return gdata.default_batchify_fn(items)

    with mx.cpu():
        out = list(gdata.DataLoader(ds, batch_size=2, num_workers=2,
                                    batchify_fn=batchify))
    assert [b.context for b in out] == [mx.cpu()] * 3
    assert all(ctx == mx.cpu() for _, ctx in seen)
    assert any(name != threading.current_thread().name for name, _ in seen)
    assert mx.current_context() == mx.gpu(0)  # the default is restored


def test_dataloader_off_the_host_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ds = gdata.SimpleDataset(np.arange(4, dtype=np.float32))
    with pytest.raises(mx.MXNetError):
        list(gdata.DataLoader(ds, batch_size=2, num_workers=2))
