"""Device meshes, partition specs and sharded arrays.

Counterpart of ``mxnet_tpu/parallel/mesh.py``.  The JAX package's mesh
is a ``jax.sharding.Mesh`` of devices with named axes, and its arrays
are ``jax.Array``s laid out by a ``NamedSharding``.  The port keeps the
same names and rules with its own small types:

- ``Mesh``: an ndarray of contexts in ``AXIS_ORDER``; its ``shape`` is an
  ordered axis -> size mapping, as jax's ``Mesh.shape`` is.  A mesh is
  made of **positions**, and positions may repeat a device
  (``[mx.gpu(0)] * 8``), as the KVStore names a context by its position
  among a key's copies.  Positions on one device split no memory and buy
  no speed; they run the JAX package's semantics and collective code
  paths on one card.
- ``PartitionSpec`` (``P``) and ``NamedSharding``: which mesh axes split
  which dimension; their ``str()`` is jax's.
- ``ShardedArray``: one block per position, on that position's device,
  plus its sharding; ``np.asarray`` of it is the global value.

``split`` cuts a global tensor into the positions' blocks and
``assemble`` puts blocks back together; both are differentiable, which
is how the primitives (``ring``, ``moe``, ``pipeline``) run under
autograd.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, gpu, num_gpus

# Canonical axis order: data, pipeline(stage), expert, tensor(model), sequence
AXIS_ORDER = ("dp", "pp", "ep", "tp", "sp")

_CURRENT_MESH = None


@dataclass
class MeshSpec:
    """Named axis sizes; axes of size 1 are kept so a single spec works
    from one position to many."""
    dp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    def sizes(self):
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    @property
    def n_devices(self):
        return int(np.prod(self.sizes()))


class PartitionSpec(tuple):
    """One entry per leading dimension: ``None`` (not split), an axis
    name, or a tuple of axis names (split over their product, the first
    one major; a one-name tuple is stored as the name, as jax does).
    Missing trailing entries are ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return "PartitionSpec%r" % (tuple(self),)

    __str__ = __repr__

    def axes(self, dim):
        """The mesh axes that split dimension ``dim``, major first."""
        entry = self[dim] if dim < len(self) else None
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, tuple) else (entry,)


P = PartitionSpec


class Mesh:
    """Positions in a grid with named axes.  ``devices`` is an ndarray of
    ``Context``s shaped by the axis sizes; each position's torch device
    is resolved once, so a gpu position without a card raises here."""

    def __init__(self, devices, axis_names=AXIS_ORDER):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.torch_devices = [c.torch_device() for c in devices.flat]
        self._coords = [
            dict(zip(self.axis_names, (int(i) for i in at)))
            for at in np.ndindex(*devices.shape)]

    @property
    def shape(self):
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def coords(self, pos):
        """The axis coordinates of flat position ``pos`` (C order)."""
        return self._coords[pos]

    def groups(self, axis):
        """Rows of flat positions that differ only along ``axis``, each in
        axis order: the groups a collective over ``axis`` acts in."""
        flat = np.arange(self.size).reshape(self.devices.shape)
        ax = self.axis_names.index(axis)
        return np.moveaxis(flat, ax, -1).reshape(-1, self.devices.shape[ax])

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%r: %d" % kv
                                      for kv in self.shape.items())


class NamedSharding:
    """A ``PartitionSpec`` over a mesh's named axes."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __repr__(self):
        return "NamedSharding(mesh=%r, spec=%r)" % (self.mesh, self.spec)

    def block_counts(self, ndim):
        sizes = self.mesh.shape
        return tuple(int(np.prod([sizes[a] for a in self.spec.axes(d)]))
                     for d in range(ndim))

    def block_index(self, pos, ndim):
        """Which block of each dimension position ``pos`` holds."""
        sizes, at = self.mesh.shape, self.mesh.coords(pos)
        index = []
        for d in range(ndim):
            i = 0
            for a in self.spec.axes(d):
                i = i * sizes[a] + at[a]
            index.append(i)
        return tuple(index)

    def shard_shape(self, shape):
        counts = self.block_counts(len(shape))
        if len(self.spec) > len(shape):
            raise ValueError("%s has more entries than the rank of %s"
                             % (self.spec, tuple(shape)))
        for n, c in zip(shape, counts):
            if n % c:
                raise ValueError("%s does not divide shape %s over %r"
                                 % (self.spec, tuple(shape), self.mesh))
        return tuple(n // c for n, c in zip(shape, counts))

    def slices(self, shape, pos):
        block = self.shard_shape(shape)
        return tuple(slice(i * b, (i + 1) * b)
                     for i, b in zip(self.block_index(pos, len(shape)),
                                     block))


def block(x, sharding, pos):
    """Position ``pos``'s block of the global tensor ``x``, on that
    position's device: a view where the device is ``x``'s own,
    differentiable either way."""
    return x[sharding.slices(x.shape, pos)].to(
        sharding.mesh.torch_devices[pos])


def split(x, sharding):
    """Every position's ``block`` of ``x``, in flat position order."""
    return [block(x, sharding, p) for p in range(sharding.mesh.size)]


def assemble(blocks, sharding, device):
    """The global tensor on ``device`` from the positions' blocks: the
    first position (in flat order) holding each block supplies it.
    Differentiable."""
    ndim = blocks[0].dim()
    grid = np.empty(sharding.block_counts(ndim), dtype=object)
    for p, blk in enumerate(blocks):
        i = sharding.block_index(p, ndim)
        if grid[i] is None:
            grid[i] = blk.to(device)

    def cat(node, d):
        if d == ndim:
            return node
        parts = [cat(n, d + 1) for n in node]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)
    return cat(grid.tolist(), 0)


class ShardedArray:
    """A global array held as one block per mesh position (``shards``, in
    flat position order, each on its position's device and each its own
    storage) laid out by ``sharding``."""

    def __init__(self, shards, sharding, shape):
        self.shards = shards
        self.sharding = sharding
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self.shards[0].dtype

    def global_tensor(self, device=None):
        """The assembled value on ``device`` (default: the first
        position's)."""
        device = device or self.sharding.mesh.torch_devices[0]
        return assemble(self.shards, self.sharding, device)

    def __array__(self, dtype=None, copy=None):
        out = self.global_tensor(torch.device("cpu")).detach().numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self):
        return "ShardedArray(shape=%s, dtype=%s, sharding=%r)" % (
            self.shape, self.dtype, self.sharding)


def _as_tensor(value):
    if isinstance(value, ShardedArray):
        return value.global_tensor()
    if isinstance(value, torch.Tensor):
        return value
    if hasattr(value, "tensor"):  # an NDArray
        return value.tensor
    return host_tensor(value)


def host_tensor(value):
    """A host tensor of an array-like (a read-only numpy array, as
    ``np.asarray`` of a jax array is, is copied first)."""
    a = np.asarray(value)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def shard(value, sharding):
    """A ``ShardedArray`` of ``value`` (a tensor, an NDArray, a numpy
    array or a ``ShardedArray``) laid out by ``sharding``: every position
    gets a copy of its block in storage of its own."""
    x = _as_tensor(value).detach()
    mesh = sharding.mesh
    shards = []
    for p in range(mesh.size):
        blk = x[sharding.slices(x.shape, p)]
        shards.append(torch.empty(blk.shape, dtype=blk.dtype,
                                  device=mesh.torch_devices[p]).copy_(blk))
    return ShardedArray(shards, sharding, x.shape)


def create_mesh(spec=None, devices=None, **axis_sizes):
    """Create a Mesh.  create_mesh(dp=4, tp=2) or create_mesh(MeshSpec(...)).

    Unspecified axes default to 1; if no axis is given, all positions go
    to dp (pure data parallel — the reference's only mode).  ``devices``
    are the positions' contexts and may repeat one (``[mx.gpu(0)] * 8``);
    the default is every CUDA device, one position each.
    """
    if spec is None:
        spec = MeshSpec(**axis_sizes) if axis_sizes else None
    if devices is None:
        if num_gpus() == 0:
            raise MXNetError(
                "create_mesh: no CUDA device; pass devices=[mx.cpu()] * n "
                "to build a mesh of host positions")
        devices = [gpu(i) for i in range(num_gpus())]
    devices = list(devices)
    for d in devices:
        if not isinstance(d, Context):
            raise MXNetError("a mesh position is a Context (mx.gpu(i) or "
                             "mx.cpu()), got %r" % (d,))
    if spec is None:
        spec = MeshSpec(dp=len(devices))
    if spec.n_devices != len(devices):
        raise ValueError("mesh spec %s needs %d devices, got %d" %
                         (spec, spec.n_devices, len(devices)))
    dev_array = np.empty(len(devices), dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(spec.sizes()), AXIS_ORDER)


def local_mesh(**axis_sizes):
    """Mesh over this host's devices (every CUDA device)."""
    return create_mesh(**axis_sizes)


def set_current_mesh(mesh):
    global _CURRENT_MESH
    _CURRENT_MESH = mesh
    return mesh


def current_mesh():
    """The process-wide default mesh (created lazily: all devices on dp)."""
    global _CURRENT_MESH
    if _CURRENT_MESH is None:
        _CURRENT_MESH = create_mesh()
    return _CURRENT_MESH


def batch_sharding(mesh, extra_axes=()):
    """Shard dim 0 (batch) over dp; optionally dim 1 (sequence) over sp."""
    spec = [("dp",)]
    for a in extra_axes:
        spec.append((a,) if a else None)
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh):
    return NamedSharding(mesh, P())


def shard_params_rule(mesh, name, shape):
    """Default parameter partitioning rule.

    2D weights (out, in): shard dim 0 over tp when tp divides it, else
    dim 1 when it divides that; conv weights (O, I, kh, kw) on O.
    Everything else replicates (dp gradients still reduce via the batch
    sharding).
    """
    tp = mesh.shape.get("tp", 1)
    if tp > 1 and len(shape) == 2:
        if shape[0] % tp == 0:
            return NamedSharding(mesh, P("tp", None))
        if shape[1] % tp == 0:
            return NamedSharding(mesh, P(None, "tp"))
    if tp > 1 and len(shape) == 4 and shape[0] % tp == 0:
        # conv weights (O, I, kh, kw): shard output channels
        return NamedSharding(mesh, P("tp", None, None, None))
    return NamedSharding(mesh, P())
