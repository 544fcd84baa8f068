"""The port's continuous batcher against the JAX package's.

An ``LSTMCell`` step symbol (4 features, 5 hidden, a 3-way projection)
built by each package from the same numpy weights: both batchers decode
the same streams, joining and leaving mid-flight, with outputs within
atol=1e-5 (f32 on both sides, GEMM sums in another order).  Inside the
port every contract of ``tests/test_serving_fleet.py``'s continuous
cases holds: zero plan builds after warmup, each stream bit for bit what
it decodes alone at the same slot count, the occupancy select keeping a
departed stream's Inf out of the next occupant, ``eos_fn`` ending or
failing only its own stream, close, and validation.  Everything runs on
``mx.cpu()``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.rnn import rnn_cell as jrnn_cell

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import executor_cache, serving

H = 5
FEAT = 4
VOCAB = 3
OUT_TOL = dict(atol=1e-5, rtol=0.0)


@pytest.fixture(autouse=True)
def _no_slot_env(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_SERVING_SLOT_COUNT", raising=False)


def _step(pkg, cell_cls):
    data = pkg.sym.Variable("data")
    h = pkg.sym.Variable("state_h")
    c = pkg.sym.Variable("state_c")
    out, (nh, nc) = cell_cls(H, prefix="lstm_")(data, [h, c])
    logits = pkg.sym.FullyConnected(out, num_hidden=VOCAB, name="proj")
    return pkg.sym.Group([logits, nh, nc])


@pytest.fixture(scope="module")
def parts():
    step = _step(mx, mx.rnn.LSTMCell)
    r = np.random.RandomState(23)
    arg_shapes, _, _ = step.infer_shape(data=(1, FEAT), state_h=(1, H),
                                        state_c=(1, H))
    params = {n: r.normal(0, 0.3, s).astype(np.float32)
              for n, s in zip(step.list_arguments(), arg_shapes)
              if n not in ("data", "state_h", "state_c")}
    return step, params


def _batcher(parts, slots, pkg=serving, step=None, **kw):
    sym, params = parts
    return pkg.ContinuousBatcher(
        step if step is not None else sym, params,
        input_shapes={"data": (FEAT,)},
        state_shapes={"state_h": (H,), "state_c": (H,)},
        state_pairs=[("state_h", 1), ("state_c", 2)], slot_count=slots,
        **kw)


def _decode_solo(parts, seq, slots):
    solo = _batcher(parts, slots, ctx=mx.cpu())
    try:
        solo.warmup()
        stream = solo.submit({"data": seq})
        solo.drain(max_iterations=200)
        return stream.outputs()[0]
    finally:
        solo.close()


def _seqs(seed, lengths):
    r = np.random.RandomState(seed)
    return [r.rand(t, FEAT).astype(np.float32) for t in lengths]


def _join_leave(cb, seqs):
    streams = [cb.submit({"data": s}) for s in seqs[:3]]
    cb.step()
    cb.step()
    streams += [cb.submit({"data": s}) for s in seqs[3:]]
    cb.drain(max_iterations=200)
    return streams


def test_matches_the_jax_batcher(parts):
    seqs = _seqs(5, (6, 3, 8, 4, 2, 5))
    jstep = _step(jmx, jrnn_cell.LSTMCell)
    jcb = _batcher(parts, 4, pkg=jserving, step=jstep)
    cb = _batcher(parts, 4, ctx=mx.cpu())
    try:
        jcb.warmup()
        cb.warmup()
        want = _join_leave(jcb, seqs)
        got = _join_leave(cb, seqs)
    finally:
        jcb.close()
        cb.close()
    for g, w in zip(got, want):
        assert g.steps_decoded == w.steps_decoded
        np.testing.assert_allclose(g.outputs()[0], w.outputs()[0],
                                   **OUT_TOL)


def test_join_leave_zero_builds_bitwise_parity(parts):
    cb = _batcher(parts, 4, ctx=mx.cpu())
    try:
        assert cb.warmup()["slot_count"] == 4
        seqs = _seqs(5, (6, 3, 8, 4, 2, 5))
        with executor_cache.watch_traces() as w:
            streams = _join_leave(cb, seqs)
        assert w.total() == 0, w.delta()
    finally:
        cb.close()
    assert [s.steps_decoded for s in streams] == [6, 3, 8, 4, 2, 5]
    for seq, stream in zip(seqs, streams):
        want = _decode_solo(parts, seq, slots=4)
        assert np.array_equal(stream.outputs()[0], want)


def test_more_streams_than_slots_queue_and_finish(parts):
    cb = _batcher(parts, 2, ctx=mx.cpu())
    try:
        cb.warmup()
        seqs = _seqs(9, (4, 2, 3, 5, 1))
        streams = [cb.submit({"data": s}) for s in seqs]
        assert cb.pending() == 5
        assert cb.drain(max_iterations=200) >= 5
    finally:
        cb.close()
    for seq, stream in zip(seqs, streams):
        assert np.array_equal(stream.outputs()[0],
                              _decode_solo(parts, seq, slots=2))


def test_eos_fn_leaves_early(parts):
    cb = _batcher(parts, 2, ctx=mx.cpu())
    try:
        cb.warmup()
        fired = []

        def eos_after_three(rows):
            fired.append(1)
            return len(fired) >= 3

        stream = cb.submit({"data": _seqs(13, (10,))[0]},
                           eos_fn=eos_after_three)
        cb.drain(max_iterations=50)
        assert stream.done and stream.steps_decoded == 3
    finally:
        cb.close()


def test_nonfinite_carry_cannot_poison_next_occupant(parts):
    cb = _batcher(parts, 2, ctx=mx.cpu())
    try:
        cb.warmup()
        first = cb.submit({"data": _seqs(29, (2,))[0]})
        cb.drain(max_iterations=20)
        assert first.done
        # a stream that overflowed before leaving: poison every free
        # slot's carried state on the device
        for name in ("state_h", "state_c"):
            cb._carry[name] = torch.full((2, H), float("inf"))
        seq = _seqs(31, (4,))[0]
        stream = cb.submit({"data": seq})
        cb.drain(max_iterations=20)
        got = stream.outputs()[0]
    finally:
        cb.close()
    assert np.all(np.isfinite(got))
    assert np.array_equal(got, _decode_solo(parts, seq, slots=2))


def test_raising_eos_fn_fails_only_its_stream(parts):
    cb = _batcher(parts, 2, ctx=mx.cpu())
    try:
        cb.warmup()
        good_seq, bad_seq = _seqs(21, (5, 6))

        def bad_eos(rows):
            raise ValueError("user callback bug")

        bad = cb.submit({"data": bad_seq}, eos_fn=bad_eos)
        good = cb.submit({"data": good_seq})
        cb.drain(max_iterations=50)
    finally:
        cb.close()
    assert bad.done and good.done
    with pytest.raises(ValueError):
        bad.outputs()
    assert np.array_equal(good.outputs()[0],
                          _decode_solo(parts, good_seq, slots=2))


def test_occupancy_metrics_and_close(parts):
    serving.metrics.reset()
    cb = _batcher(parts, 2, ctx=mx.cpu())
    cb.warmup()
    s1 = cb.submit({"data": _seqs(17, (6,))[0]})
    cb.step()
    counters = serving.metrics.snapshot()["counters"]
    assert counters["serving.decode.iterations"] >= 1
    assert counters["serving.decode.joins"] >= 1
    cb.close()
    assert s1.done
    with pytest.raises(mx.base.MXNetError):
        s1.outputs()
    with pytest.raises(mx.base.MXNetError):
        cb.submit({"data": _seqs(18, (2,))[0]})


def test_validates_shapes_and_states(parts):
    step, params = parts
    with pytest.raises(mx.base.MXNetError):
        serving.ContinuousBatcher(
            step, params, input_shapes={"data": (FEAT,)},
            state_shapes={"state_h": (H,), "state_c": (H,)},
            state_pairs=[("bogus", 1)], slot_count=2, ctx=mx.cpu())
    cb = _batcher(parts, 2, ctx=mx.cpu())
    try:
        with pytest.raises(mx.base.MXNetError):
            cb.submit({"data": np.zeros((3, FEAT + 1), np.float32)})
        with pytest.raises(mx.base.MXNetError):
            cb.submit({"wrong": np.zeros((3, FEAT), np.float32)})
    finally:
        cb.close()


def test_default_context_is_the_card(parts):
    """The JAX package's batcher defaults to ``cpu()``, the port's to the
    current context, ``gpu(0)``: without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context works there")
    with pytest.raises(mx.base.MXNetError, match="CUDA"):
        _batcher(parts, 2)
