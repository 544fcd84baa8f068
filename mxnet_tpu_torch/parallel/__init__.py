"""The mesh layer: meshes, shardings, collectives and the parallel
primitives.

Counterpart of ``mxnet_tpu/parallel/``, with its names.  A mesh is a grid
of positions with the named axes

- dp — data parallel: batch split, gradients summed;
- pp — pipeline parallel: layer stages on mesh slices, microbatched
  (``pipeline_stages``);
- ep — expert parallel: MoE experts split, all_to_all dispatch
  (``moe_ffn``, ``MoELayer``);
- tp — tensor parallel: weight matrices split (``shard_params_rule``);
- sp — sequence parallel: sequence dim split, ring attention rotates K/V
  blocks (``ring_attention``, ``ring_self_attention``);

and ``ShardedTrainStep`` trains a ``loss_fn`` over it.  Positions may
share a device (``create_mesh(dp=2, pp=2, ep=2, devices=[mx.gpu(0)] *
8)``); ``collectives`` moves tensors between them and counts every
collective by kind.
"""
from .mesh import (  # noqa: F401
    AXIS_ORDER, Mesh, MeshSpec, NamedSharding, P, PartitionSpec,
    ShardedArray, create_mesh, current_mesh, set_current_mesh, local_mesh,
    batch_sharding, replicated_sharding, shard_params_rule, shard,
)
from . import collectives, comm  # noqa: F401
from .ring import ring_attention, ring_self_attention  # noqa: F401
from .moe import MoELayer, moe_ffn  # noqa: F401
from .pipeline import pipeline_stages  # noqa: F401
from .train import ShardedTrainStep  # noqa: F401
