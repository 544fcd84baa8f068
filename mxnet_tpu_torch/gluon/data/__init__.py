"""Gluon data API (ref: python/mxnet/gluon/data/): datasets, samplers,
the DataLoader and ``vision`` (the image datasets and transforms)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401
