"""mx.rnn: the legacy symbol-level RNN cells and the bucketing iterator."""
from .rnn_cell import *  # noqa: F401,F403
from .io import BucketSentenceIter  # noqa: F401
from . import rnn_cell  # noqa: F401
