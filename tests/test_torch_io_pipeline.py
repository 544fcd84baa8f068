"""The port's ``mx.io_pipeline`` against the JAX package's, on the CPU.

For a fixed seed a batch is a pure function of (seed, epoch, position):
the port's batches are bit for bit the JAX package's at 1, 2 and 4
workers, in thread and in spawn-process mode, at prefetch depth 1 and 4
and with the double buffer on and off, for a decoder that draws per
record (``NoisyDecoder``) and for the image chain (``ImageRecordDecoder``:
resize, random crop and mirror, mean/std).  The epoch plan, the reorder
buffer, mid-epoch reset and close, a decode error, the adapter that
``fit`` makes from a raw Pipeline and closes, and a process pool that
cannot start are covered too.  A LeNet fit from a Pipeline (one epoch,
4 steps at lr 0.05 with momentum) matches the JAX package's fit on the
same records and weights within 1e-5 relative L2 per parameter in f32:
the two packages' convolutions sum in other orders (3e-7 at 4 steps; a
second epoch at this rate amplifies that to 1.1e-5).
"""
import multiprocessing
import threading
import time
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io_pipeline as jiop

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io_pipeline as iop
from mxnet_tpu_torch.io_pipeline.executor import (PipelineClosed,
                                                  ReorderBuffer)

from io_pipeline_cases import (FEAT, N_REC, BrokenInWorker, ExplodingDecoder,
                               NoisyDecoder)

IMG_REC = 24
IMG_SHAPE = (3, 32, 32)
IMG_MEAN = (123.68, 116.779, 103.939)
IMG_STD = (58.395, 57.12, 57.375)


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    """N_REC records of FEAT f32 each, written by the JAX package."""
    path = str(tmp_path_factory.mktemp("iop") / "t.rec")
    rng = np.random.RandomState(0)
    writer = jmx.recordio.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(N_REC):
        arr = rng.rand(FEAT).astype(np.float32)
        writer.write_idx(i, jmx.recordio.pack(
            jmx.recordio.IRHeader(0, float(i % 5), i, 0), arr.tobytes()))
    writer.close()
    return path


@pytest.fixture(scope="module")
def jpeg_file(tmp_path_factory):
    """IMG_REC JPEG records of 36-60 x 40-70 pixels, written by the JAX
    package's recordio (cv2 at quality 90)."""
    import cv2
    path = str(tmp_path_factory.mktemp("iopimg") / "img.rec")
    rng = np.random.RandomState(1)
    writer = jmx.recordio.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(IMG_REC):
        h, w = rng.randint(36, 61), rng.randint(40, 71)
        img = cv2.GaussianBlur(
            rng.randint(0, 256, (h, w, 3)).astype(np.uint8), (5, 5), 1.5)
        writer.write_idx(i, jmx.recordio.pack_img(
            jmx.recordio.IRHeader(0, float(i % 7), i, 0), img, quality=90))
    writer.close()
    return path


def _sequence(pipe, epoch=0):
    return [(b.data.tobytes(), b.label.tobytes(), b.pad)
            for b in pipe.host_batches(epoch)]


def _no_pipeline_threads():
    return not [t for t in mx.threads.live_package_threads()
                if "io_pipeline" in t.name]


def _noisy_pipeline(pkg_iop, package, rec, **kw):
    kw.setdefault("batch_size", 8)
    kw.setdefault("shuffle", True)
    kw.setdefault("seed", 11)
    return pkg_iop.Pipeline(pkg_iop.RecordFileSource(rec, rec + ".idx"),
                            NoisyDecoder(package), **kw)


@pytest.fixture(scope="module")
def jax_noisy(rec_file):
    """The JAX package's batches at one thread worker, epochs 0 and 1."""
    pipe = _noisy_pipeline(jiop, "mxnet_tpu", rec_file, num_workers=1)
    return [_sequence(pipe, e) for e in (0, 1)]


# -- sharding ----------------------------------------------------------------

def test_sharding_gives_the_jax_packages_integers():
    for seed, epoch, gidx in ((0, 0, 0), (11, 3, 36), (2 ** 31 + 5, 7, 999),
                              (-4, 2, 12345)):
        assert iop.epoch_seed(seed, epoch) == jiop.epoch_seed(seed, epoch)
        assert iop.record_seed(seed, epoch, gidx) == \
            jiop.record_seed(seed, epoch, gidx)
    for n, seed, epoch, shuffle in ((37, 9, 2, True), (37, 9, 2, False),
                                    (1000, 3, 0, True), (1, 0, 5, True)):
        np.testing.assert_array_equal(iop.epoch_order(n, seed, epoch, shuffle),
                                      jiop.epoch_order(n, seed, epoch,
                                                       shuffle))
    for n, k in ((10, 3), (37, 4), (100, 7)):
        for i in range(k):
            np.testing.assert_array_equal(iop.shard_records(n, k, i),
                                          jiop.shard_records(n, k, i))
    for handle in ("pad", "discard"):
        ours = iop.epoch_plan(N_REC, 8, 9, 2, True, handle)
        theirs = jiop.epoch_plan(N_REC, 8, 9, 2, True, handle)
        assert [t.__getstate__() for t in ours] == \
            [t.__getstate__() for t in theirs]


@pytest.mark.parametrize("n,k", [(10, 3), (37, 4), (8, 8), (5, 1), (100, 7)])
def test_shard_assignment_exact_cover(n, k):
    parts = [iop.shard_records(n, k, i) for i in range(k)]
    assert sorted(np.concatenate(parts).tolist()) == list(range(n))
    assert max(len(p) for p in parts) - min(len(p) for p in parts) <= 1
    with pytest.raises(mx.MXNetError):
        iop.shard_records(n, k, k)


@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_plan_covers_every_record_once(shuffle):
    plan = iop.epoch_plan(N_REC, 8, seed=9, epoch=2, shuffle=shuffle)
    rows = []
    for task in plan:
        rows.extend(task.indices[:len(task.indices) - task.pad])
    assert sorted(rows) == list(range(N_REC))
    tail = plan[-1]
    assert tail.pad == 3
    assert list(tail.indices[-tail.pad:]) == \
        list(iop.epoch_order(N_REC, 9, 2, shuffle)[:tail.pad])
    discard = iop.epoch_plan(N_REC, 8, 9, 2, shuffle, "discard")
    assert len(discard) == N_REC // 8 and all(t.pad == 0 for t in discard)


def test_record_file_source_num_parts(rec_file):
    srcs = [iop.RecordFileSource(rec_file, rec_file + ".idx", num_parts=3,
                                 part_index=i) for i in range(3)]
    assert sorted(k for s in srcs for k in s.keys) == list(range(N_REC))
    for i, s in enumerate(srcs):
        assert s.keys == jiop.RecordFileSource(
            rec_file, rec_file + ".idx", num_parts=3, part_index=i).keys


# -- batches against the JAX package -----------------------------------------

@pytest.mark.parametrize("mode", ["thread", "process"])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_batches_are_the_jax_packages(rec_file, jax_noisy, workers, mode):
    """Bit for bit the JAX package's epochs 0 and 1 at any worker count,
    in either mode; the spawn pool persists across the two epochs."""
    with _noisy_pipeline(iop, "mxnet_tpu_torch", rec_file,
                         num_workers=workers, mode=mode) as pipe:
        got = [_sequence(pipe, e) for e in (0, 1)]
        if mode == "process":
            pool = pipe._proc_exec._pool
            assert pool._mp_context.get_start_method() == "spawn"
    assert got == jax_noisy
    assert len(got[0]) == 5 and got[0][-1][2] == 3  # 37 -> pad 3
    assert got[0] != got[1]  # epochs draw distinct orders and noise
    assert _no_pipeline_threads()
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("double_buffer", [True, False])
def test_depth_and_double_buffer_keep_the_batches(rec_file, jax_noisy, depth,
                                                  double_buffer):
    """The adapter's view on a host context, at depth 1 and 4, with the
    double buffer on and off: the JAX package's batches, as host
    NDArrays, for two epochs (reset() arms the next)."""
    pipe = _noisy_pipeline(iop, "mxnet_tpu_torch", rec_file, num_workers=2,
                           prefetch_depth=depth, ctx=mx.cpu(),
                           double_buffer=double_buffer)
    assert _sequence(pipe) == jax_noisy[0]
    with pipe.as_dataiter() as it:
        epochs = []
        for _ in range(2):
            got = []
            for b in it:
                assert b.data[0].context == mx.cpu()
                got.append((b.data[0].asnumpy().tobytes(),
                            b.label[0].asnumpy().tobytes(), b.pad))
            epochs.append(got)
            it.reset()
    assert epochs == jax_noisy
    assert _no_pipeline_threads()


def test_batches_without_a_context_are_host_ndarrays(rec_file, jax_noisy):
    pipe = _noisy_pipeline(iop, "mxnet_tpu_torch", rec_file, num_workers=2)
    got = list(pipe.batches(0))
    assert all(b.data[0].context == mx.cpu() for b in got)
    assert [(b.data[0].asnumpy().tobytes(), b.label[0].asnumpy().tobytes(),
             b.pad) for b in got] == jax_noisy[0]
    assert pipe.provide_data[0].shape == (8, FEAT)
    assert pipe.provide_label[0].shape == (8,)
    assert len(pipe) == 5


def _image_pipeline(pkg_iop, rec, **kw):
    decoder = pkg_iop.ImageRecordDecoder(IMG_SHAPE, resize=36,
                                         rand_crop=True, rand_mirror=True,
                                         mean=IMG_MEAN, std=IMG_STD)
    return pkg_iop.Pipeline(pkg_iop.RecordFileSource(rec, rec + ".idx"),
                            decoder, batch_size=5, shuffle=True, seed=7,
                            **kw)


@pytest.mark.parametrize("workers,mode", [(1, "thread"), (2, "thread"),
                                          (4, "thread"), (2, "process")])
def test_image_decoder_batches_are_the_jax_packages(jpeg_file, workers, mode):
    """JPEG decode, short-side resize, random crop and mirror and mean/std
    from the per-record RNG: bit for bit the JAX package's."""
    want = [_sequence(_image_pipeline(jiop, jpeg_file, num_workers=1), e)
            for e in (0, 1)]
    with _image_pipeline(iop, jpeg_file, num_workers=workers,
                         mode=mode) as pipe:
        got = [_sequence(pipe, e) for e in (0, 1)]
    assert got == want
    assert len(got[0]) == 5 and got[0][-1][2] == 1
    first = np.frombuffer(got[0][0][0], np.float32).reshape((5,) + IMG_SHAPE)
    assert np.isfinite(first).all() and first.std() > 0.1


def test_epochs_reproducible(rec_file):
    def run():
        pipe = _noisy_pipeline(iop, "mxnet_tpu_torch", rec_file, seed=5,
                               num_workers=2)
        return [_sequence(pipe, e) for e in (0, 1)]

    (e0, e1), (f0, f1) = run(), run()
    assert e0 == f0 and e1 == f1 and e0 != e1


def test_more_workers_than_cores_under_a_short_switch_interval(rec_file,
                                                               jax_noisy):
    """16 thread workers, one record a task, the interpreter switching
    threads every microsecond: the rows are the JAX package's rows of the
    batch-8 run, in order (a record's draws depend on its position only)."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = _noisy_pipeline(iop, "mxnet_tpu_torch", rec_file,
                               batch_size=1, num_workers=16,
                               prefetch_depth=1)
        rows = [(b.data, b.label) for b in pipe.host_batches(0)]
    finally:
        sys.setswitchinterval(old)
    assert len(rows) == N_REC
    want_data = np.concatenate([np.frombuffer(d, np.float32).reshape(-1, FEAT)
                                for d, _, _ in jax_noisy[0]])[:N_REC]
    want_label = np.concatenate([np.frombuffer(lab, np.float32)
                                 for _, lab, _ in jax_noisy[0]])[:N_REC]
    np.testing.assert_array_equal(np.concatenate([d for d, _ in rows]),
                                  want_data)
    np.testing.assert_array_equal(np.concatenate([lab for _, lab in rows]),
                                  want_label)
    assert _no_pipeline_threads()


# -- reorder buffer ----------------------------------------------------------

def test_reorder_buffer_releases_in_order_and_bounds_fill():
    rb = ReorderBuffer(capacity=3)
    threads = [threading.Thread(target=rb.put, args=(s, "item%d" % s),
                                daemon=True) for s in (2, 0, 1, 4, 3, 5)]
    for t in threads:
        t.start()
    out = [rb.get() for _ in range(6)]
    for t in threads:
        t.join(timeout=5)
    assert out == ["item%d" % i for i in range(6)]
    assert rb.max_fill <= 3
    with pytest.raises(mx.MXNetError, match="already released"):
        rb.put(1, "late")


def test_reorder_buffer_put_blocks_past_capacity():
    rb = ReorderBuffer(capacity=2)
    rb.put(0, "a")
    rb.put(1, "b")
    passed = threading.Event()

    def far_ahead():
        rb.put(2, "c")  # 2 >= next(0) + capacity(2): blocks
        passed.set()

    t = threading.Thread(target=far_ahead, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not passed.is_set(), "a put past the bound did not block"
    assert rb.get() == "a"
    assert passed.wait(5)
    t.join(timeout=5)
    assert [rb.get(), rb.get()] == ["b", "c"]


def test_reorder_buffer_close_wakes_everyone_and_drops_items():
    rb = ReorderBuffer(capacity=1)
    woken = []

    def blocked(fn, tag):
        try:
            fn()
        except PipelineClosed:
            woken.append(tag)

    threads = [threading.Thread(target=blocked, args=(rb.get, "get")),
               threading.Thread(target=blocked,
                                args=(lambda: rb.put(5, "far"), "put"))]
    for t in threads:
        t.start()
    time.sleep(0.05)
    rb.close()
    for t in threads:
        t.join(timeout=5)
    assert sorted(woken) == ["get", "put"]
    rb2 = ReorderBuffer(capacity=2)
    rb2.put(0, "ready")
    rb2.close()
    assert rb2.fill() == 0
    with pytest.raises(PipelineClosed):
        rb2.get()


# -- lifecycle ---------------------------------------------------------------

def test_close_mid_epoch(rec_file):
    pipe = _noisy_pipeline(iop, "mxnet_tpu_torch", rec_file, batch_size=4,
                           seed=1, num_workers=3, ctx=mx.cpu())
    it = pipe.as_dataiter()
    next(it)
    next(it)
    it.close()
    assert _no_pipeline_threads()
    it.close()  # idempotent
    with pytest.raises(mx.MXNetError):
        it.next()
    with pytest.raises(mx.MXNetError):
        it.reset()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_reset_mid_epoch_restarts_cleanly(rec_file, jax_noisy, mode):
    pipe = _noisy_pipeline(iop, "mxnet_tpu_torch", rec_file, num_workers=2,
                           ctx=mx.cpu(), mode=mode)
    with pipe.as_dataiter() as it:
        next(it)
        it.reset()  # abandon epoch 0 mid-flight
        assert it.epoch == 1
        got = [(b.data[0].asnumpy().tobytes(), b.label[0].asnumpy().tobytes(),
                b.pad) for b in it]
        it.hard_reset()
        assert it.epoch == 0
        again = [(b.data[0].asnumpy().tobytes(),
                  b.label[0].asnumpy().tobytes(), b.pad) for b in it]
    assert got == jax_noisy[1] and again == jax_noisy[0]
    assert _no_pipeline_threads()
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_decode_error_aborts_the_epoch(rec_file, mode):
    pipe = iop.Pipeline(iop.RecordFileSource(rec_file, rec_file + ".idx"),
                        ExplodingDecoder("mxnet_tpu_torch"), batch_size=8,
                        num_workers=2, mode=mode)
    seen = 0
    with pytest.raises(ValueError, match="boom on record 3"):
        for _ in pipe.host_batches(0):
            seen += 1
    assert seen == 0  # record 3 is in the first batch
    pipe.close()
    assert _no_pipeline_threads()
    assert not multiprocessing.active_children()


def test_a_process_pool_that_cannot_start_raises(rec_file):
    """No quiet fall back to thread mode: the broken pool's error."""
    pipe = iop.Pipeline(iop.RecordFileSource(rec_file, rec_file + ".idx"),
                        BrokenInWorker("mxnet_tpu_torch"), batch_size=8,
                        num_workers=2, mode="process")
    with pytest.raises(BrokenProcessPool):
        list(pipe.host_batches(0))
    pipe.close()
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_fit_adapts_and_closes_a_raw_pipeline(rec_file, mode):
    """fit() takes the raw Pipeline, trains on it and closes the adapter
    it made: no io_pipeline thread or worker process is left.  With
    shuffle off the parameters equal those of the same data through
    NDArrayIter, bit for bit."""
    reader = iop.RecordFileSource(rec_file, rec_file + ".idx").open_reader()
    feats = np.stack([iop.NDArrayRecordDecoder((FEAT,))(reader.read(i),
                                                        None)[0]
                      for i in range(32)])
    reader.close()
    labels = np.asarray([float(i % 5) for i in range(32)], np.float32)

    def fit(data):
        with mx.sym.NameManager():
            fc1 = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=16,
                                        name="fc1")
            act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
            net = mx.sym.SoftmaxOutput(
                mx.sym.FullyConnected(act, num_hidden=5, name="fc2"),
                name="softmax")
        mx.random.seed(0)
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(data, num_epoch=2, optimizer_params={"learning_rate": 0.1})
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    want = fit(mx.io.NDArrayIter(feats, labels, batch_size=8))
    source = iop.RecordFileSource(rec_file, rec_file + ".idx")
    source.keys = source.keys[:32]
    got = fit(iop.Pipeline(source, iop.NDArrayRecordDecoder((FEAT,)),
                           batch_size=8, num_workers=2, mode=mode))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert _no_pipeline_threads()
    assert not multiprocessing.active_children()


def test_fit_closes_the_adapter_when_training_raises(rec_file):
    pipe = _noisy_pipeline(iop, "mxnet_tpu_torch", rec_file, num_workers=2)
    with mx.sym.NameManager():
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.var("data"), num_hidden=5, name="fc"), name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())

    def explode(param):
        raise RuntimeError("callback failed")

    with pytest.raises(RuntimeError, match="callback failed"):
        mod.fit(pipe, num_epoch=1, batch_end_callback=explode)
    assert _no_pipeline_threads()


# -- LeNet from a Pipeline against the JAX package ---------------------------

LENET_N, LENET_BATCH = 32, 8


@pytest.fixture(scope="module")
def mnist_like(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lenet") / "mnist.rec")
    rng = np.random.RandomState(3)
    writer = jmx.recordio.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(LENET_N):
        img = rng.rand(1, 28, 28).astype(np.float32)
        writer.write_idx(i, jmx.recordio.pack(
            jmx.recordio.IRHeader(0, float(i % 10), i, 0), img.tobytes()))
    writer.close()
    return path


def _lenet_fit(pkg, pkg_iop, rec, weights, names):
    with names():
        sym = pkg.models.lenet.get_symbol(10)
    kw = {"ctx": mx.cpu()} if pkg is mx else {}
    pipe = pkg_iop.Pipeline(pkg_iop.RecordFileSource(rec, rec + ".idx"),
                            pkg_iop.NDArrayRecordDecoder((1, 28, 28)),
                            batch_size=LENET_BATCH, shuffle=True, seed=4,
                            num_workers=2)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.fit(pipe, num_epoch=1,
            arg_params={k: pkg.nd.array(v, **kw) for k, v in weights.items()},
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_lenet_fit_from_a_pipeline_matches_the_jax_package(mnist_like):
    from mxnet_tpu.symbol.symbol import NameManager as JNameManager
    with mx.sym.NameManager():
        sym = mx.models.lenet.get_symbol(10)
    shapes, _, _ = sym.infer_shape(data=(LENET_BATCH, 1, 28, 28))
    rng = np.random.RandomState(5)
    weights = {n: (rng.randn(*s) * (0.1 if n.endswith("bias") else
                                    np.sqrt(2.0 / np.prod(s[1:]))))
               .astype(np.float32)
               for n, s in zip(sym.list_arguments(), shapes)
               if n not in ("data", "softmax_label")}
    got = _lenet_fit(mx, iop, mnist_like, weights, mx.sym.NameManager)
    want = _lenet_fit(jmx, jiop, mnist_like, weights, JNameManager)
    assert sorted(got) == sorted(want) == sorted(weights)
    for k in want:
        moved = np.linalg.norm(want[k] - weights[k])
        assert moved > 0, k
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel <= 1e-5, (k, rel)
    assert _no_pipeline_threads()
