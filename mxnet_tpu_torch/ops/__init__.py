"""Operator library: importing the package registers every op."""
from . import registry  # noqa: F401
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import attention  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import rnn_op  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import quantize  # noqa: F401
from . import random_ops  # noqa: F401
