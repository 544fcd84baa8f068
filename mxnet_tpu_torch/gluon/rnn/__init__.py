"""Gluon recurrent layers and cells (ref: python/mxnet/gluon/rnn/)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
