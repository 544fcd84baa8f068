"""Paged-KV autoregressive decode: iteration-level transformer serving
over the :class:`~mxnet_tpu_torch.serving.kv_cache.KVBlockPool`.

Counterpart of ``mxnet_tpu/serving/decode.py``.  The slot scheduling of
``continuous.py`` stays; the per-slot carry becomes a slot -> page-table
indirection into one device-resident block pool:

- ONE fixed-shape step per decoder configuration: ``(k_pool, v_pool,
  params, tokens, positions, active, tables) -> (next_tokens, logits)``,
  writing the pools in place.  A scatter writes this step's K/V row at
  each stream's (page, offset) cursor; the attention gathers the stream's
  window through its table.  Joins, leaves, prefill and decode all run
  this one step, built once (``executor_cache.note_trace``).
- **On the card** ``warmup()`` captures the step once as a CUDA graph;
  every iteration then copies its inputs into the graph's static buffers
  and replays it, so after warmup nothing is built and nothing captured.
  The capture opens a memprof program record (``decode_step``).
  **On the host** the step runs eagerly.
- Inactive slots write into trash page 0 and attend over nothing: the
  ``valid`` SELECT zeroes the gathered operands and masks the scores
  with -1e30, never a multiply (``0 * garbage`` may be NaN).  Their
  writes all land on page 0, offset 0: ``index_put_`` leaves which of
  the duplicates wins unspecified, which is harmless only because
  nothing reads page 0 unmasked.
- A row's attention window is exactly its own appended tokens, so at a
  fixed slot count every served stream is bit for bit what decoding it
  alone gives.
- Prefill is the same step fed one prompt token an iteration; decode
  feeds the previous argmax (greedy).
- **Prefix reuse and copy-on-write.**  ``submit`` probes the prefix cache
  with the chain hash of each leading full prompt page; hits are
  retained and skipped by prefill.  A prompt cached whole (an exact page
  multiple) backs off one token, since the last prompt token's forward
  gives the first generated token, and its K/V rewrite targets the
  shared tail page: ``KVBlockPool.ensure_private`` copies that page first.
- A stream that cannot get a page sheds with the typed ``Overloaded``;
  co-batched streams proceed.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .. import executor_cache
from ..base import MXNetError
from ..context import current_context
from ..observability import memprof as _memprof
from . import metrics
from .continuous import SlotScheduler, _Stream
from .errors import Overloaded
from .kv_cache import KVBlockPool, page_chain_hash


def _ln(x, g, b):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


@functools.lru_cache(maxsize=None)
def _paged_step_plan(num_layers, num_heads, head_dim, slot_count, max_pages,
                     page_size, device):
    """Build (once per configuration, counted as one plan build) the
    fixed-shape decode step: (k_pool, v_pool, params, tokens, positions,
    active, tables) -> (next_tokens, logits), the pools written in
    place.  ``device`` keys the plan as the executor cache's does."""
    executor_cache.note_trace("fwd")
    S, T = slot_count, max_pages * page_size
    H, D = num_heads, head_dim
    scale = 1.0 / float(head_dim) ** 0.5

    def step(k_pool, v_pool, params, tokens, positions, active, tables):
        dev = tokens.device
        rows = torch.arange(S, device=dev)
        h = params["embed"][tokens] + params["pos"][positions]   # [S, E]
        page_idx = torch.where(
            active, tables[rows, positions // page_size],
            torch.zeros((), dtype=tables.dtype, device=dev))
        in_page = positions % page_size
        t_idx = torch.arange(T, device=dev)
        # a row sees exactly the pool positions up to its own write
        # cursor; the rest of the gathered window (the trash page, table
        # zeros, other streams' leftovers) is dropped by SELECT
        valid = (t_idx[None, :] <= positions[:, None]) & active[:, None]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
        for l in range(num_layers):
            p = "l%d." % l
            x = _ln(h, params[p + "ln1_g"], params[p + "ln1_b"])
            q = (x @ params[p + "wq"].t() + params[p + "bq"]) \
                .reshape(S, H, D)
            k = (x @ params[p + "wk"].t() + params[p + "bk"]) \
                .reshape(S, H, D)
            v = (x @ params[p + "wv"].t() + params[p + "bv"]) \
                .reshape(S, H, D)
            # append: one scatter per layer writes this step's K/V row at
            # each stream's (page, offset); inactive slots hit page 0
            k_pool[l].index_put_((page_idx, in_page), k)
            v_pool[l].index_put_((page_idx, in_page), v)
            # gather-attend over the stream's page table
            k_ctx = k_pool[l][tables].reshape(S, T, H, D)
            v_ctx = v_pool[l][tables].reshape(S, T, H, D)
            k_ctx = torch.where(valid[:, :, None, None], k_ctx, zero)
            v_ctx = torch.where(valid[:, :, None, None], v_ctx, zero)
            s = torch.einsum("shd,sthd->sht", q, k_ctx) * scale
            s = torch.where(valid[:, None, :], s, neg)
            w = torch.softmax(s, dim=-1)
            o = torch.einsum("sht,sthd->shd", w, v_ctx).reshape(S, H * D)
            h = h + o @ params[p + "wo"].t() + params[p + "bo"]
            y = _ln(h, params[p + "ln2_g"], params[p + "ln2_b"])
            f = y @ params[p + "w1"].t() + params[p + "b1"]
            f = 0.5 * f * (1.0 + torch.erf(f * 0.7071067811865476))
            h = h + f @ params[p + "w2"].t() + params[p + "b2"]
        hf = _ln(h, params["lnf_g"], params["lnf_b"])
        logits = hf @ params["head_w"].t() + params["head_b"]
        nxt = torch.argmax(logits, dim=-1)
        return nxt, logits

    return step


class PagedDecodeStream(_Stream):
    """One generation request against a :class:`PagedTransformerDecoder`:
    the prompt, the greedy continuation and completion state."""

    def __init__(self, prompt, max_new_tokens, eos_token):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token = None if eos_token is None else int(eos_token)
        self.slot = None
        self.position = 0          # tokens already appended to KV
        self.history = []          # every appended token, in order
        self.pages = []            # page ids, table order
        self.chain = 0             # chain hash through the last full page
        self.prefix_pages = 0      # pages reused from the prefix cache
        self.generated = []        # greedy continuation token ids
        self.logits_rows = []      # per generated token: [vocab] f32 row
        self._init_done()

    def outputs(self):
        """(token_ids list, logits array [n_generated, vocab])."""
        if self.error is not None:
            raise self.error
        logits = np.stack(self.logits_rows) if self.logits_rows \
            else np.zeros((0, 0), np.float32)
        return list(self.generated), logits

    @property
    def steps_decoded(self):
        return len(self.generated)


class PagedTransformerDecoder(SlotScheduler):
    """Iteration-level greedy decode over a paged KV pool (the module
    docstring has the model).

    ``params``: f32 arrays of the ``TransformerLM.decode_param_arrays()``
    schema (numpy, either package's).  ``config``: vocab_size /
    embed_dim / num_heads / num_layers / ffn_dim / seq_len
    (``TransformerLM(...).config``).  ``max_len`` caps a stream's context
    (default: the position table's size).  The pool (``pool``, else one
    built here on ``ctx``, default the current context) fixes the device.
    On the card ``warmup()`` captures the step as a CUDA graph; setting
    ``cuda_graph`` to False before it keeps every step eager."""

    def __init__(self, params, config, slot_count=None, pool=None,
                 max_len=None, name="paged", ctx=None):
        self._init_slots(slot_count, name)
        cfg = dict(config)
        self.vocab_size = int(cfg["vocab_size"])
        self.embed_dim = int(cfg["embed_dim"])
        self.num_heads = int(cfg["num_heads"])
        self.num_layers = int(cfg["num_layers"])
        self.ffn_dim = int(cfg.get("ffn_dim") or 4 * self.embed_dim)
        self.head_dim = self.embed_dim // self.num_heads
        pos_len = int(np.shape(params["pos"])[0])
        self.max_len = min(int(max_len), pos_len) if max_len else pos_len
        self._owns_pool = pool is None
        self.pool = pool if pool is not None else KVBlockPool(
            self.num_layers, self.num_heads, self.head_dim,
            name="%s.kv" % self.name, ctx=ctx or current_context())
        if (self.pool.num_layers, self.pool.num_heads,
                self.pool.head_dim) != (self.num_layers, self.num_heads,
                                        self.head_dim):
            raise MXNetError("KVBlockPool geometry %s does not match "
                             "model (%d layers, %d heads, %d head_dim)"
                             % ((self.pool.num_layers,
                                 self.pool.num_heads, self.pool.head_dim),
                                self.num_layers, self.num_heads,
                                self.head_dim))
        self.device = self.pool.device
        self.page_size = self.pool.page_size
        self.max_pages = -(-self.max_len // self.page_size)
        self._params = {
            k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
                self.device) for k, v in params.items()}
        self._step_fn = _paged_step_plan(
            self.num_layers, self.num_heads, self.head_dim,
            self.slot_count, self.max_pages, self.page_size,
            str(self.device))
        # the CUDA graph of the step (card only)
        self.cuda_graph = self.device.type == "cuda"
        self._graph = None
        self._static = None
        self.captures = 0
        self.replays = 0
        self.capture_seconds = None

    # -- scheduling --------------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, eos_token=None):
        """Queue one greedy-decode request.  ``prompt``: 1-D int token ids
        (at least one).  Every leading full page of the prompt whose
        chain hash is cached is reused (retained, never re-prefilled)."""
        prompt = np.asarray(prompt).reshape(-1).astype(np.int64)
        if prompt.size == 0:
            raise MXNetError("prompt must have at least one token")
        if prompt.size + int(max_new_tokens) > self.max_len:
            raise MXNetError(
                "prompt (%d) + max_new_tokens (%d) exceeds max context "
                "%d" % (prompt.size, int(max_new_tokens), self.max_len))
        stream = PagedDecodeStream(prompt, max_new_tokens, eos_token)
        ps = self.page_size
        chain = 0
        probes = 0
        for pg in range(len(stream.prompt) // ps):
            nxt = page_chain_hash(
                chain, stream.prompt[pg * ps:(pg + 1) * ps])
            probes += 1
            page = self.pool.lookup_retain(nxt)
            if page is None:
                break
            stream.pages.append(page)
            chain = nxt
        stream.prefix_pages = len(stream.pages)
        stream.position = stream.prefix_pages * ps
        if stream.position >= len(stream.prompt):
            # the whole prompt (an exact page multiple) is cached: back
            # off one token, whose forward gives the first generated
            # token.  Its K/V rewrite targets the shared tail page, the
            # copy-on-write trigger; the chain rewinds to the pages that
            # stay untouched.
            stream.position = len(stream.prompt) - 1
            chain = 0
            for pg in range(stream.prefix_pages - 1):
                chain = page_chain_hash(
                    chain, stream.prompt[pg * ps:(pg + 1) * ps])
        stream.chain = chain
        stream.history = stream.prompt[:stream.position]
        metrics.record_kv_prefix(lookups=probes,
                                 hit_pages=stream.prefix_pages)
        self._enqueue(stream)
        return stream

    # SlotScheduler hooks --------------------------------------------------

    def _on_reject_locked(self, stream):
        self._release_stream_locked(stream)

    def _on_close_locked(self, doomed):
        for stream in doomed:
            self._release_stream_locked(stream)

    def _close_error(self, stream):
        return MXNetError(
            "PagedTransformerDecoder closed with the stream "
            "unfinished (%d tokens generated)" % len(stream.generated))

    # -- the step ----------------------------------------------------------

    def _inputs(self):
        """Host buffers of one step: tokens, positions, active, tables."""
        return (np.zeros((self.slot_count,), np.int64),
                np.zeros((self.slot_count,), np.int64),
                np.zeros((self.slot_count,), bool),
                np.zeros((self.slot_count, self.max_pages), np.int64))

    def _eager(self, inputs):
        return self._step_fn(self.pool.k_pool, self.pool.v_pool,
                             self._params, *inputs)

    def _capture(self):
        """Capture the step as a CUDA graph over static input buffers,
        after one eager run on a side stream (cuBLAS handles and
        workspaces exist before capture)."""
        static = [torch.from_numpy(a).to(self.device)
                  for a in self._inputs()]
        # one memprof record a capture: its time and, under the flag, the
        # warm-up run's peak and the graph pool's bytes
        probe = _memprof.CaptureProbe(_memprof.note_build(
            "decode_step", "paged_decode@L%dH%dD%dS%d" % (
                self.pool.num_layers, self.pool.num_heads,
                self.pool.head_dim, self.slot_count)), self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with probe.warmup(), torch.cuda.stream(side):
            self._eager(static)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            # thread_local: a server's other threads may use the card
            # while this step is captured
            with probe.capture(
                    lambda: [self.pool.k_pool, self.pool.v_pool] + static
                    + list(self._params.values()), lambda: list(outs)), \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = self._eager(static)
        except Exception as exc:
            raise MXNetError("capturing the paged decode step as a CUDA "
                             "graph failed: %s" % exc) from exc
        self.capture_seconds = time.perf_counter() - t0
        self._graph, self._static, self._graph_outs = graph, static, outs
        self.captures += 1

    def _run(self, tokens, positions, active, tables):
        """One step on the pools from host inputs; returns the device
        (next_tokens, logits).  On the card: a graph replay, captured at
        the first call (``warmup()`` makes that call)."""
        host = (tokens, positions, active, tables)
        if not self.cuda_graph:
            return self._eager([torch.from_numpy(a).to(self.device)
                                for a in host])
        if self._graph is None:
            self._capture()
        for buf, a in zip(self._static, host):
            buf.copy_(torch.from_numpy(a))
        self._graph.replay()
        self.replays += 1
        return self._graph_outs

    def _release_stream_locked(self, stream):
        for page in stream.pages:
            self.pool.release(page)
        stream.pages = []

    def _shed(self, slot, stream, exc, overflow):
        self._slots[slot] = None
        self._release_stream_locked(stream)
        overflow.append((stream, exc))

    def step(self):
        """One decode iteration: seat waiting streams, make each active
        stream's write-target page exist and be private (a shared or
        prefix-registered page is copied first; a stream that cannot get
        a page fails with ``Overloaded``, not the decoder), run the step,
        append and advance, register completed pages with the prefix
        cache, collect generated tokens, retire EOS streams.  Returns the
        number of active slots run."""
        overflow = []
        with self._lock:
            joins = self._admit_locked()
            batch = []
            for slot, stream in enumerate(self._slots):
                if stream is None:
                    continue
                need = stream.position // self.page_size
                if need >= len(stream.pages):
                    try:
                        stream.pages.append(self.pool.alloc())
                    except Overloaded as exc:
                        self._shed(slot, stream, exc, overflow)
                        continue
                batch.append((slot, stream, need))
        # copy-on-write outside the scheduler lock: streams seated in
        # slots are only changed by this stepping thread
        active = []
        tokens, positions, active_mask, tables = self._inputs()
        for slot, stream, need in batch:
            try:
                page, cloned = self.pool.ensure_private(stream.pages[need])
            except Overloaded as exc:
                with self._lock:
                    self._shed(slot, stream, exc, overflow)
                continue
            if cloned:
                stream.pages[need] = page
            if stream.position < len(stream.prompt):
                fed = stream.prompt[stream.position]   # prefill
            else:
                fed = stream.generated[-1]             # decode
            tokens[slot] = fed
            positions[slot] = stream.position
            active_mask[slot] = True
            tables[slot, :len(stream.pages)] = stream.pages
            active.append((slot, stream, fed))
        for stream, exc in overflow:
            metrics.record_rejection(exc.reason)
            stream._finish(exc)
        if not active:
            return 0
        nxt, logits = self._run(tokens, positions, active_mask, tables)
        nxt_host = nxt.cpu().numpy()
        logits_host = logits.cpu().numpy()
        self.iterations += 1
        finished = []
        leaves = 0
        with self._lock:
            for slot, stream, fed in active:
                stream.history.append(int(fed))
                stream.position += 1
                if stream.position % self.page_size == 0:
                    # a page just filled: immutable from here on, offered
                    # to the prefix cache under its chain hash
                    pg = stream.position // self.page_size - 1
                    stream.chain = page_chain_hash(
                        stream.chain,
                        stream.history[pg * self.page_size:])
                    self.pool.register_prefix(stream.chain,
                                              stream.pages[pg])
                eos = False
                if stream.position >= len(stream.prompt):
                    g = int(nxt_host[slot])
                    stream.generated.append(g)
                    stream.logits_rows.append(logits_host[slot].copy())
                    eos = (len(stream.generated) >= stream.max_new_tokens
                           or (stream.eos_token is not None
                               and g == stream.eos_token)
                           or stream.position >= self.max_len)
                if eos:
                    self._slots[slot] = None
                    pages_held = len(stream.pages)
                    self._release_stream_locked(stream)
                    leaves += 1
                    finished.append((stream, pages_held))
        for stream, pages_held in finished:
            metrics.record_kv_stream_finished(pages_held)
            stream._finish(None)
        metrics.record_decode_step(len(active), joins, leaves)
        return len(active)

    # -- warmup ------------------------------------------------------------

    def warmup(self, verify=True):
        """Build the step and the copy-on-write page copy before traffic,
        and on the card capture the step's CUDA graph (all slots
        inactive: writes land in the trash page, reads are masked).  With
        ``verify`` a second iteration must build and capture nothing, the
        contract every join, leave, prefill, decode and copy-on-write
        inherits."""
        if self.pending():
            raise MXNetError("warmup must run before streams are "
                             "submitted")
        with executor_cache.watch_traces() as w:
            self._warm_iteration()
        traces = w.total()
        if verify:
            captures = self.captures
            with executor_cache.watch_traces() as w2:
                self._warm_iteration()
            if w2.total() or self.captures != captures:
                raise MXNetError(
                    "paged-decoder warmup verification failed: %d plan "
                    "builds and %d captures on the second iteration"
                    % (w2.total(), self.captures - captures))
        self.iterations = 0
        return {"traces": traces, "captures": self.captures,
                "slot_count": self.slot_count, "pool": self.pool.stats()}

    def _warm_iteration(self):
        self._run(*self._inputs())
        self.pool.warm_cow()

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        SlotScheduler.close(self)
        if self._owns_pool:
            # a caller-supplied pool may outlive this decoder
            self.pool.close()
