"""The port's paged-KV tier against the JAX package's.

``KVBlockPool``: the same scripted alloc/release/prefix/copy-on-write
sequence through both packages' pools gives the same page ids and
stats, and each pool behaviour of ``tests/test_kv_cache.py`` holds in
the port.  ``PagedTransformerDecoder``: the zoo ``TransformerLM``'s
``decode_param_arrays()`` (vocab 64, width 32, 2 heads, 2 layers, 64
positions) feeds both packages' decoders; tokens are equal and logits
agree within atol=1e-5 (f32 on both sides, sums in another order).
Inside the port, a stream co-batched with others equals the same stream
decoded alone bit for bit at the same slot count, and within
atol=rtol=1e-6 across slot counts (another GEMM shape; ROADMAP R8).
Everything runs on ``mx.cpu()``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import transformer_lm as jtransformer_lm
from mxnet_tpu.serving import KVBlockPool as JPool
from mxnet_tpu.serving import PagedTransformerDecoder as JDecoder
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import executor_cache
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import transformer_lm
from mxnet_tpu_torch.serving import KVBlockPool, PagedTransformerDecoder
from mxnet_tpu_torch.serving.errors import Overloaded
from mxnet_tpu_torch.serving.kv_cache import page_chain_hash
from mxnet_tpu_torch.symbol import NameManager

VOCAB, EMBED, HEADS, LAYERS, SEQ = 64, 32, 2, 2, 64
LOGIT_TOL = dict(atol=1e-5, rtol=0.0)
SLOT_COUNT_TOL = dict(atol=1e-6, rtol=1e-6)


def _rng(seed=0):
    return np.random.RandomState(seed)


@pytest.fixture(scope="module")
def jax_lm():
    jmx.random.seed(4)
    with JNameManager():
        lm = jtransformer_lm(VOCAB, embed_dim=EMBED, num_heads=HEADS,
                             num_layers=LAYERS, seq_len=SEQ)
    lm.initialize(jmx.initializer.Xavier())
    lm(jmx.nd.array(np.zeros((1, SEQ), np.float32)))
    return lm


@pytest.fixture(scope="module")
def lm_params(jax_lm):
    """(decode params, config): the dict both decoders take as is."""
    return jax_lm.decode_param_arrays(), jax_lm.config


def _pool(num_pages=4, page_size=8, name="t"):
    return KVBlockPool(LAYERS, HEADS, EMBED // HEADS, num_pages=num_pages,
                       page_size=page_size, name=name, ctx=mx.cpu())


def _decoder(lm_params, slot_count=3, num_pages=24, page_size=8,
             name="pdec"):
    params, config = lm_params
    return PagedTransformerDecoder(
        params, config, slot_count=slot_count,
        pool=_pool(num_pages, page_size, name="%s.kv" % name), name=name)


def _decode_solo(lm_params, prompt, max_new_tokens, slot_count=1):
    dec = _decoder(lm_params, slot_count=slot_count, name="solo")
    try:
        dec.warmup(verify=False)
        stream = dec.submit(prompt, max_new_tokens=max_new_tokens)
        dec.drain(max_iterations=500)
        return stream.outputs()
    finally:
        dec.close()


# -- the zoo's decode parameter dict ------------------------------------------

def test_decode_param_arrays_equal_the_jax_packages(jax_lm):
    with NameManager():
        net = transformer_lm(VOCAB, embed_dim=EMBED, num_heads=HEADS,
                             num_layers=LAYERS, seq_len=SEQ)
    mx.convert.set_gluon_params(
        net, {k: v.data().asnumpy()
              for k, v in jax_lm.collect_params().items()}, ctx=mx.cpu())
    got, want = net.decode_param_arrays(), jax_lm.decode_param_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], want[k]), k
    assert net.config == jax_lm.config


# -- KVBlockPool: the same script through both packages -----------------------

def _pool_script(pool):
    """A scripted mix of every pool transition; returns what it saw."""
    seen = []
    pages = [pool.alloc() for _ in range(3)]
    seen.append(("alloc", pages))
    h0 = page_chain_hash(0, range(pool.page_size))
    h1 = page_chain_hash(h0, range(1, pool.page_size + 1))
    pool.register_prefix(h0, pages[0])
    pool.register_prefix(h1, pages[1])
    seen.append(("hit", pool.lookup_retain(h0), pool.refcount(pages[0])))
    seen.append(("cow", pool.ensure_private(pages[0])))
    pool.release(pages[1])
    seen.append(("idle", pool.stats()))
    seen.append(("alloc4", pool.alloc()))
    seen.append(("evict", pool.alloc(), pool.lookup_retain(h1)))
    try:
        pool.alloc()
        seen.append(("full", None))
    except Exception as exc:  # noqa: BLE001 - each package's Overloaded
        seen.append(("full", type(exc).__name__))
    seen.append(("end", pool.stats()))
    return seen


def test_pool_script_matches_the_jax_pool():
    jpool = JPool(LAYERS, HEADS, EMBED // HEADS, num_pages=5, page_size=4,
                  name="t.script")
    pool = KVBlockPool(LAYERS, HEADS, EMBED // HEADS, num_pages=5,
                       page_size=4, name="t.script", ctx=mx.cpu())
    try:
        assert _pool_script(pool) == _pool_script(jpool)
    finally:
        jpool.close()
        pool.close()


# -- KVBlockPool: each behaviour ----------------------------------------------

def test_pool_alloc_release_recycle():
    pool = _pool(num_pages=3)
    pages = [pool.alloc() for _ in range(3)]
    assert sorted(pages) == [1, 2, 3]  # page 0 is the trash page
    assert pool.pages_used() == 3
    with pytest.raises(Overloaded):
        pool.alloc()
    pool.release(pages[0])
    assert pool.pages_used() == 2
    assert pool.alloc() == pages[0]  # unregistered pages recycle directly
    st = pool.stats()
    assert st["pages_total"] == 3 and st["pages_active"] == 3
    assert st["pages_high_water"] == 3


def test_pool_refcount_and_shared_release():
    pool = _pool(num_pages=2)
    page = pool.alloc()
    h = page_chain_hash(0, range(pool.page_size))
    pool.register_prefix(h, page)
    assert pool.lookup_retain(h) == page
    assert pool.refcount(page) == 2
    pool.release(page)
    assert pool.refcount(page) == 1
    pool.release(page)
    # refcount 0 but registered: parked in the LRU, hittable, still used
    assert pool.refcount(page) == 0
    assert pool.pages_used() == 1
    assert pool.stats()["pages_cached_idle"] == 1
    assert pool.lookup_retain(h) == page


def test_pool_lru_eviction_frees_idle_cached_pages():
    pool = _pool(num_pages=2)
    hashes = []
    for i in range(2):
        page = pool.alloc()
        h = page_chain_hash(i, range(pool.page_size))
        pool.register_prefix(h, page)
        hashes.append(h)
        pool.release(page)
    assert pool.stats()["pages_cached_idle"] == 2
    pool.alloc()  # evicts the least recently idle page and its entry
    assert pool.lookup_retain(hashes[0]) is None
    assert pool.lookup_retain(hashes[1]) is not None


def test_pool_exhaustion_is_typed_and_actionable():
    pool = _pool(num_pages=1)
    pool.alloc()
    with pytest.raises(Overloaded, match="MXNET_TPU_KV_POOL_PAGES"):
        pool.alloc()


def test_register_prefix_first_writer_wins_and_skips_released():
    pool = _pool(num_pages=3)
    h = page_chain_hash(0, range(pool.page_size))
    a, b = pool.alloc(), pool.alloc()
    pool.register_prefix(h, a)
    pool.register_prefix(h, b)
    assert pool.lookup_retain(h) == a
    released = pool.alloc()
    pool.release(released)
    h2 = page_chain_hash(1, range(pool.page_size))
    pool.register_prefix(h2, released)  # never resurrects a free page
    assert pool.lookup_retain(h2) is None


def test_cow_clones_shared_and_registered_pages():
    pool = _pool(num_pages=4)
    pool.warm_cow()
    mine = pool.alloc()
    assert pool.ensure_private(mine) == (mine, False)
    h = page_chain_hash(0, range(pool.page_size))
    pool.register_prefix(h, mine)
    assert pool.lookup_retain(h) == mine and pool.refcount(mine) == 2
    fresh, cloned = pool.ensure_private(mine)
    assert cloned and fresh != mine
    assert pool.refcount(mine) == 1 and pool.refcount(fresh) == 1
    fresh2, cloned2 = pool.ensure_private(mine)  # registered at refcount 1
    assert cloned2 and fresh2 not in (mine, fresh)
    assert pool.stats()["cow_clones"] == 2
    assert pool.lookup_retain(h) == mine


def test_cow_preserves_page_bits_and_the_pool_tensors():
    pool = _pool(num_pages=2, page_size=4)
    k_pool, v_pool = pool.k_pool, pool.v_pool
    page = pool.alloc()
    stamp = torch.arange(LAYERS * 4 * HEADS * (EMBED // HEADS),
                         dtype=torch.float32).reshape(LAYERS, 4, HEADS, -1)
    pool.k_pool[:, page] = stamp
    pool.v_pool[:, page] = 2 * stamp
    pool.register_prefix(page_chain_hash(0, [1, 2, 3, 4]), page)
    fresh, cloned = pool.ensure_private(page)
    assert cloned
    assert torch.equal(pool.k_pool[:, fresh], stamp)
    assert torch.equal(pool.v_pool[:, fresh], 2 * stamp)
    # written in place: a captured graph reading the pools stays valid
    assert pool.k_pool is k_pool and pool.v_pool is v_pool


def test_pool_stats_carry_the_page_footprint():
    pool = _pool(num_pages=4)
    pool.alloc()
    st = pool.stats()
    assert st["pages_total"] == 4 and st["pages_free"] == 3
    assert st["page_bytes"] == pool.page_bytes == \
        2 * LAYERS * pool.page_size * HEADS * (EMBED // HEADS) * 4
    assert pool.k_pool.shape == (LAYERS, 5, pool.page_size, HEADS,
                                 EMBED // HEADS)


# -- PagedTransformerDecoder --------------------------------------------------

def test_decoder_matches_the_jax_decoder(lm_params):
    params, config = lm_params
    r = _rng(1)
    prompts = [r.randint(0, VOCAB, size=n) for n in (3, 11, 20)]
    jdec = JDecoder(params, config, slot_count=3,
                    pool=JPool(LAYERS, HEADS, EMBED // HEADS, num_pages=24,
                               page_size=8, name="jdec.kv"), name="jdec")
    dec = _decoder(lm_params, slot_count=3, name="pdec.jax")
    try:
        jdec.warmup()
        dec.warmup()
        want = [jdec.submit(p, max_new_tokens=6) for p in prompts]
        got = [dec.submit(p, max_new_tokens=6) for p in prompts]
        jdec.drain(max_iterations=500)
        dec.drain(max_iterations=500)
    finally:
        jdec.close()
        jdec.pool.close()
        dec.close()
    for g, w in zip(got, want):
        assert g.outputs()[0] == w.outputs()[0]
        np.testing.assert_allclose(g.outputs()[1], w.outputs()[1],
                                   **LOGIT_TOL)
        assert g.prefix_pages == w.prefix_pages


def test_batched_decode_bitwise_equals_solo_at_the_same_slot_count(
        lm_params):
    r = _rng(2)
    prompts = [r.randint(0, VOCAB, size=n) for n in (3, 11, 20)]
    dec = _decoder(lm_params, slot_count=3, name="pdec.bw")
    try:
        dec.warmup()
        streams = [dec.submit(p, max_new_tokens=6) for p in prompts]
        dec.drain(max_iterations=500)
    finally:
        dec.close()
    for i, (p, s) in enumerate(zip(prompts, streams)):
        toks, logits = s.outputs()
        assert len(toks) == 6
        ref_toks, ref_logits = _decode_solo(lm_params, p, 6, slot_count=3)
        assert toks == ref_toks
        assert np.array_equal(logits, ref_logits), \
            "co-batched stream %d not bit for bit the solo decode" % i
        one_toks, one_logits = _decode_solo(lm_params, p, 6, slot_count=1)
        assert one_toks == toks
        np.testing.assert_allclose(logits, one_logits, **SLOT_COUNT_TOL)


def test_join_leave_steady_state_builds_nothing(lm_params):
    r = _rng(3)
    dec = _decoder(lm_params, slot_count=2, name="pdec.zr")
    try:
        report = dec.warmup()
        assert report["captures"] == 0  # the host runs the step eagerly
        with executor_cache.watch_traces() as w:
            first = dec.submit(r.randint(0, VOCAB, size=9), max_new_tokens=4)
            dec.step()
            dec.step()
            dec.submit(r.randint(0, VOCAB, size=17), max_new_tokens=5)
            dec.drain(max_iterations=500)
        assert w.total() == 0, w.delta()
        assert first.done
    finally:
        dec.close()


def test_prefix_hit_skips_prefill_and_cow_diverges(lm_params):
    r = _rng(4)
    dec = _decoder(lm_params, slot_count=2, page_size=8, name="pdec.pfx")
    try:
        dec.warmup()
        shared = r.randint(0, VOCAB, size=2 * dec.page_size)
        seed = dec.submit(shared, max_new_tokens=4)
        dec.drain(max_iterations=500)
        base_clones = dec.pool.stats()["cow_clones"]
        with executor_cache.watch_traces() as w:
            again = dec.submit(shared, max_new_tokens=4)
            iters = dec.drain(max_iterations=500)
        assert w.total() == 0, w.delta()
        assert again.prefix_pages == 2
        # the backed-off last prompt token's forward gives the first
        # generated token: 4 iterations, no prefill
        assert iters == 4
        assert dec.pool.stats()["cow_clones"] == base_clones + 1
        assert again.outputs()[0] == seed.outputs()[0]
        assert np.array_equal(again.outputs()[1], seed.outputs()[1])
        forked = np.concatenate([shared[:dec.page_size],
                                 r.randint(0, VOCAB, size=3)])
        s2 = dec.submit(forked, max_new_tokens=4)
        dec.drain(max_iterations=500)
        assert s2.prefix_pages == 1
        toks, logits = s2.outputs()
    finally:
        dec.close()
    ref_toks, ref_logits = _decode_solo(lm_params, forked, 4, slot_count=2)
    assert toks == ref_toks and np.array_equal(logits, ref_logits)


def test_pool_exhaustion_sheds_the_stream_not_the_decoder(lm_params):
    r = _rng(5)
    dec = _decoder(lm_params, slot_count=2, num_pages=2, page_size=8,
                   name="pdec.shed")
    try:
        dec.warmup()
        a = dec.submit(r.randint(0, VOCAB, size=7), max_new_tokens=8)
        b = dec.submit(r.randint(0, VOCAB, size=7), max_new_tokens=8)
        dec.drain(max_iterations=500)
        shed, survived = (a, b) if a.error is not None else (b, a)
        with pytest.raises(Overloaded):
            shed.wait(1)
        assert len(survived.outputs()[0]) == 8
        c = dec.submit(r.randint(0, VOCAB, size=3), max_new_tokens=2)
        dec.drain(max_iterations=500)
        assert len(c.outputs()[0]) == 2
    finally:
        dec.close()


def test_close_fails_unfinished_and_refuses_new(lm_params):
    r = _rng(6)
    dec = _decoder(lm_params, slot_count=2, name="pdec.close")
    dec.warmup()
    held = dec.submit(r.randint(0, VOCAB, size=5), max_new_tokens=30)
    dec.step()
    dec.close()
    with pytest.raises(MXNetError, match="closed with the stream"):
        held.wait(1)
    assert dec.pool.pages_used() == 0
    with pytest.raises(MXNetError, match="closed"):
        dec.submit(r.randint(0, VOCAB, size=3))


def test_submit_validates_prompt_and_context(lm_params):
    dec = _decoder(lm_params, slot_count=1, name="pdec.val")
    try:
        with pytest.raises(MXNetError, match="at least one token"):
            dec.submit(np.zeros((0,), np.int64))
        with pytest.raises(MXNetError, match="exceeds max context"):
            dec.submit(np.zeros((SEQ,), np.int64), max_new_tokens=8)
    finally:
        dec.close()


def test_decoder_rejects_mismatched_pool_geometry(lm_params):
    params, config = lm_params
    wrong = KVBlockPool(LAYERS + 1, HEADS, EMBED // HEADS, num_pages=2,
                        ctx=mx.cpu())
    with pytest.raises(MXNetError, match="geometry"):
        PagedTransformerDecoder(params, config, slot_count=1, pool=wrong)


def test_default_context_is_the_card(lm_params):
    """Not given ``mx.cpu()``, the pool and decoder go to ``gpu(0)``: on
    a machine without a card that raises, never runs on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context works there")
    params, config = lm_params
    with pytest.raises(MXNetError, match="CUDA"):
        KVBlockPool(LAYERS, HEADS, EMBED // HEADS, num_pages=2)
    with pytest.raises(MXNetError, match="CUDA"):
        PagedTransformerDecoder(params, config, slot_count=1)
