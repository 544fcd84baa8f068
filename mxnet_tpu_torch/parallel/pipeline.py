"""Pipeline parallelism: GPipe-style microbatching over the `pp` mesh axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``.  Every position holds
its stage's slice of the stacked stage parameters and its share of the
microbatches.  The schedule runs ``n_micro + pp - 1`` ticks: at each
tick every stage computes ``stage_fn``, the last stage keeps the output
of microbatch ``t - (pp - 1)``, and the states move one stage on
(``collectives.ppermute``), stage 0 injecting microbatch ``t``.  At the
end the last stage's outputs are broadcast to every stage (a ``psum`` of
the last stage's outputs and the others' zeros).  Everything is torch
ops on the positions' blocks, so the whole schedule is differentiable
end to end by torch autograd.
"""
from __future__ import annotations

import torch

from ..serving.continuous import tree_map
from . import collectives
from .mesh import NamedSharding, P, PartitionSpec, assemble, block, \
    current_mesh, split


def _pipeline_local(params, xs, stage_fn, mesh, axis_name):
    """The positions' schedule.  params: each position's stage params
    (tree); xs: each position's microbatch stream [n_micro_local, mb,
    ...] — when the caller runs data parallelism over the leading dim,
    n_micro_local is the per-replica share, not the caller's n_micro.
    Returns each position's [n_micro_local, mb, ...] outputs."""
    pp = mesh.shape[axis_name]
    idx = [mesh.coords(p)[axis_name] for p in range(mesh.size)]
    n_micro = xs[0].shape[0]
    total_steps = n_micro + pp - 1
    perm = [(j, (j + 1) % pp) for j in range(pp)]
    state = [torch.zeros_like(x[0]) for x in xs]
    outputs = [[torch.zeros_like(x[0])] * n_micro for x in xs]
    for t in range(total_steps):
        ys = []
        for p, x in enumerate(xs):
            # stage 0 injects microbatch t; later stages take the incoming
            # state
            x_in = x[min(t, n_micro - 1)] if idx[p] == 0 else state[p]
            y = stage_fn(params[p], x_in)
            # the last stage completes microbatch t-(pp-1) at step t
            out_mb = t - (pp - 1)
            if idx[p] == pp - 1 and out_mb >= 0:
                outputs[p][out_mb] = y
            ys.append(y)
        state = collectives.ppermute(ys, mesh, axis_name, perm)
    # only the last stage holds real outputs; broadcast them to all stages
    last = [torch.stack(o) if i == pp - 1 else torch.zeros_like(x)
            for o, i, x in zip(outputs, idx, xs)]
    return collectives.psum(last, mesh, axis_name)


def pipeline_stages(stage_params, x, stage_fn, n_micro, mesh=None,
                    axis_name="pp", params_spec=None, batch_axis=None,
                    tail_spec=None):
    """Run x through pp pipeline stages.

    stage_params: a tensor, or a tuple/list/dict of tensors, each with a
    leading `n_stages` dim split over `axis_name` (each position gets its
    stage's slice).
    x: [batch, ...] input; split into n_micro microbatches.
    stage_fn(params_slice, x_mb) -> y_mb, same shape as x_mb.
    params_spec: one PartitionSpec for every leaf, or a tree of them
    (default P(axis_name) each).
    tail_spec: PartitionSpec entries for x's trailing (non-batch) dims —
    e.g. ("sp", None) for [b, seq, d] with sequence parallelism.
    """
    mesh = mesh or current_mesh()
    b = x.shape[0]
    if b % n_micro:
        raise ValueError("batch %d not divisible by n_micro %d"
                         % (b, n_micro))
    x_micro = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

    if params_spec is None or isinstance(params_spec, PartitionSpec):
        one = P(axis_name) if params_spec is None else params_spec
        params_spec = tree_map(lambda _: one, stage_params)
    tail = tuple(tail_spec) if tail_spec else (None,) * (x.dim() - 1)

    # the [b] -> [n_micro, mb] reshape lands the batch split on the
    # LEADING (microbatch-count) dim; keeping dp there matches the
    # surrounding layout but shrinks each replica's stream to n_micro/dp —
    # at pp>1 that inflates the pipeline bubble (pp-1)/(n_local+pp-1).
    # Take the aligned layout when there is no bubble to inflate (pp==1)
    # or each replica still pipelines >=2 microbatches; callers who want
    # it at deeper pipelines should raise n_micro (e.g. 2*dp).
    dp_size = mesh.shape.get(batch_axis, 1) if batch_axis else 1
    pp_size = mesh.shape.get(axis_name, 1)
    if (batch_axis and n_micro % dp_size == 0
            and (pp_size == 1 or n_micro // dp_size >= 2)):
        x_spec = P(batch_axis, None, *tail)
    else:
        x_spec = P(None, batch_axis, *tail)

    # each position's params with the stage dim (1 after the split) dropped
    params = [tree_map(lambda leaf, spec, p=p:
                       block(leaf, NamedSharding(mesh, spec), p)[0],
                       stage_params, params_spec)
              for p in range(mesh.size)]
    x_sharding = NamedSharding(mesh, x_spec)
    out = _pipeline_local(params, split(x_micro, x_sharding), stage_fn,
                          mesh, axis_name)
    y_micro = assemble(out, x_sharding, x.device)
    return y_micro.reshape((b,) + tuple(y_micro.shape[2:]))
