"""Gluon data API (ref: python/mxnet/gluon/data/): datasets, samplers
and the DataLoader.  ``gluon.data.vision`` waits for the data I/O slice."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
