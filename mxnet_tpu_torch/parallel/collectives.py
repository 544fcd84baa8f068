"""Collectives over the positions of a mesh axis.

The JAX package writes its parallel primitives as ``shard_map`` bodies
that call ``lax.psum``, ``pmean``, ``all_gather``, ``ppermute`` and
``all_to_all``; XLA lowers each to one collective of the compiled
program, over every group of devices along the axis at once.  The port
has no ``shard_map``: a primitive holds one tensor per mesh position (a
list in flat position order, see ``mesh.split``) and calls these
functions, each of which acts on every group along one axis and counts
as one collective.  (The JAX package's ``parallel/_smap.py``, a
``shard_map`` import shim for jax versions, has no counterpart.)

How a group's tensors move:

- positions on one device: torch ops where the tensors sit (sums,
  stacks, slices), differentiable;
- distinct CUDA devices, outside autograd: ``torch.cuda.nccl`` for the
  sum and the gather (as ``kvstore/nccl.py`` does), peer copies for the
  permutation and the all-to-all;
- otherwise peer copies (``Tensor.to``), which autograd differentiates.

Sums reduce in position order (``((x0 + x1) + x2) + ...`` on the first
position's device), so results are deterministic; the NCCL branch sums
in NCCL's order.  The NCCL and peer-copy branches need two cards.

Every call is counted by kind in each active ``watch()``: the five kinds
of the JAX package's ``comm.collective_counts`` over compiled HLO text,
which the port has no counterpart of.  A watch made with ``timed=True``
also records, on a card, CUDA events around each call (their span on the
stream, host gaps between the call's launches included).  A CUDA graph's
capture issues nothing: ``captured()`` takes the calls made inside it
out of the active watches, and ``add_counts`` counts them again at each
replay (no span: a replay is one launch).
"""
from __future__ import annotations

import contextlib

import torch

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
         "all-to-all")

_WATCHES = []


class Watch:
    """Counts of the collectives issued while this watch is active, by
    kind, and with ``timed`` their CUDA-event spans."""

    def __init__(self, timed=False):
        self.counts = dict.fromkeys(KINDS, 0)
        self.timed = timed
        self._events = {k: [] for k in KINDS}

    def spans_ms(self):
        """Summed ms of each kind's calls (synchronizes); 0.0 for kinds
        issued on the host only."""
        if any(self._events.values()):
            torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in ev)
                for k, ev in self._events.items()}


@contextlib.contextmanager
def watch(timed=False):
    """``with watch() as w: ...`` then ``w.counts``."""
    w = Watch(timed)
    _WATCHES.append(w)
    try:
        yield w
    finally:
        _WATCHES.remove(w)


@contextlib.contextmanager
def captured():
    """Around the capture of a CUDA graph: yields a dict that holds, once
    the block ends without error, the calls made inside it by kind (the
    graph's collectives), which the active watches do not keep."""
    before = [dict(w.counts) for w in _WATCHES]
    probe = Watch()
    _WATCHES.append(probe)
    recorded = {}
    try:
        yield recorded
        recorded.update((k, n) for k, n in probe.counts.items() if n)
    finally:
        _WATCHES.remove(probe)
        for w, counts in zip(_WATCHES, before):
            w.counts.update(counts)


def add_counts(counts):
    """Count one replay of a captured graph: the calls ``captured``
    recorded, in every active watch."""
    for w in _WATCHES:
        for kind, n in counts.items():
            w.counts[kind] += n


@contextlib.contextmanager
def _issue(kind, device):
    for w in _WATCHES:
        w.counts[kind] += 1
    # events cannot be timed inside a graph's capture
    timers = [w for w in _WATCHES if w.timed] \
        if device.type == "cuda" \
        and not torch.cuda.is_current_stream_capturing() else []
    if not timers:
        yield
        return
    with torch.cuda.device(device):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        yield
        e1.record()
    for w in timers:
        w._events[kind].append((e0, e1))


def _per_group(blocks, mesh, axis, fn):
    """Apply ``fn(tensors, devices)`` to each group along ``axis``; it
    returns one tensor per member."""
    out = [None] * mesh.size
    for group in mesh.groups(axis):
        res = fn([blocks[p] for p in group],
                 [mesh.torch_devices[p] for p in group])
        for p, r in zip(group, res):
            out[p] = r
    return out


def _nccl_group(tensors):
    """Whether a group can take ``torch.cuda.nccl``: every member on its
    own CUDA device, and nothing to differentiate."""
    devs = [t.device for t in tensors]
    return (len(devs) > 1 and len(set(devs)) == len(devs)
            and all(d.type == "cuda" for d in devs)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in tensors)))


def _sum_group(xs, devs):
    if _nccl_group(xs):
        outs = [x.clone() for x in xs]
        torch.cuda.nccl.all_reduce(outs)
        return outs
    s = xs[0]
    for x in xs[1:]:
        s = s + x.to(s.device)
    return [s.to(d) for d in devs]


def psum(blocks, mesh, axis):
    """Each position gets the sum over its group along ``axis``."""
    with _issue("all-reduce", mesh.torch_devices[0]):
        return _per_group(blocks, mesh, axis, _sum_group)


def pmean(blocks, mesh, axis):
    n = mesh.shape[axis]
    return [s / n for s in psum(blocks, mesh, axis)]


def _gather_group(xs, devs):
    if _nccl_group(xs):
        outs = [torch.empty((len(xs),) + tuple(x.shape), dtype=x.dtype,
                            device=x.device) for x in xs]
        torch.cuda.nccl.all_gather(xs, outs)
        return outs
    first = torch.stack([x.to(devs[0]) for x in xs])
    return [first.to(d) for d in devs]


def all_gather(blocks, mesh, axis):
    """Each position gets its group's tensors stacked on a new leading
    dimension, in axis order (``lax.all_gather``, not tiled)."""
    with _issue("all-gather", mesh.torch_devices[0]):
        return _per_group(blocks, mesh, axis, _gather_group)


def ppermute(blocks, mesh, axis, perm):
    """Position ``dst`` along ``axis`` gets position ``src``'s tensor for
    each ``(src, dst)`` in ``perm``; a position no pair names gets
    zeros."""
    def move(xs, devs):
        out = [torch.zeros_like(x) for x in xs]
        for src, dst in perm:
            out[dst] = xs[src].to(devs[dst])
        return out
    with _issue("collective-permute", mesh.torch_devices[0]):
        return _per_group(blocks, mesh, axis, move)


def all_to_all(blocks, mesh, axis, split_axis, concat_axis):
    """Each position cuts its tensor into the group's size of chunks
    along ``split_axis`` and sends chunk ``j`` to member ``j``; each
    member concatenates what it gets along ``concat_axis``, in source
    order."""
    def exchange(xs, devs):
        n = len(xs)
        chunks = [torch.chunk(x, n, dim=split_axis) for x in xs]
        return [torch.cat([chunks[src][dst].to(devs[dst])
                           for src in range(n)], dim=concat_axis)
                for dst in range(n)]
    with _issue("all-to-all", mesh.torch_devices[0]):
        return _per_group(blocks, mesh, axis, exchange)
