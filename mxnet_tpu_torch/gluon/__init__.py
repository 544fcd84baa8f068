"""Gluon: the imperative and hybrid neural-network API (ref:
python/mxnet/gluon/)."""
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (  # noqa: F401
    Constant, DeferredInitializationError, Parameter, ParameterDict,
)
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import data  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
from . import model_zoo  # noqa: F401
