"""mxnet_tpu_torch: the MXNet 1.0 API of ``mxnet_tpu`` in PyTorch and CUDA.

The port of the JAX package to one NVIDIA H100, slice by slice.  It
serves symbol graphs (``Server`` -> ``ServedModel`` -> ``Predictor`` ->
``Symbol.simple_bind`` -> ``Executor.forward``, with the attention of
``multi_head_attention`` in a hand-written CUDA flash-attention kernel)
and trains them (``Module.fit`` -> the fused train step, forward,
backward and update as one CUDA graph replay a batch, in bf16 with f32
master weights under ``multi_precision``, with BatchNorm's channel sums
and the pooling input gradients in hand-written CUDA kernels; the
optimizers, learning-rate schedulers, callbacks and checkpoints with
optimizer states of the JAX package).  Gluon trains imperatively or hybridized
(``autograd.record()`` -> ``loss.backward()`` -> ``gluon.Trainer.step``),
with attention in the flash kernel's LSE variant and its blockwise
backward, and the Gluon vision zoo's conv nets train through the same
path with BatchNorm's channel sums and the 2-D pooling gradients in the
hand-written kernels; an exported graph runs again as a ``SymbolBlock``.
``gluon.rnn``'s layers run the ``RNN`` op on cuDNN's recurrent kernels,
``gluon.data`` feeds batches from worker threads, and ``gluon.loss`` has
every loss of the JAX package, CTC included.  ``mx.rnn``'s symbol cells
and ``BucketSentenceIter`` train variable-length sequences through
``mx.mod.BucketingModule``: one bound executor and one CUDA graph of the
fused step per bucket, over one set of parameters and optimizer states.
``mx.models`` holds the symbol zoo (LeNet and the MLP of BASELINE config 1
through Inception-ResNet-v2), and ``mx.test_utils`` the reference's
testing helpers, ``check_consistency`` among them.

Entry points run on the card (``gpu(0)``) unless given ``cpu()``; without
a card they raise ``MXNetError`` rather than fall back to the host.
"""
from __future__ import annotations

from .base import MXNetError, __version__  # noqa: F401
from .context import Context, cpu, current_context, gpu, num_gpus  # noqa: F401
from . import ops  # noqa: F401
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from .symbol import AttrScope  # noqa: F401
from .symbol.symbol import NameManager  # noqa: F401
from . import executor, executor_cache  # noqa: F401
from .executor import Executor  # noqa: F401
from . import random  # noqa: F401
from .random import seed  # noqa: F401
from . import initializer  # noqa: F401
from .initializer import Initializer  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from . import metric  # noqa: F401
from . import io  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import model  # noqa: F401
from .model import FeedForward  # noqa: F401
from . import callback  # noqa: F401
from . import monitor  # noqa: F401
from .monitor import Monitor  # noqa: F401
from . import rnn  # noqa: F401
from . import attribute  # noqa: F401
from . import name  # noqa: F401
from .predict import Predictor  # noqa: F401
from . import serving  # noqa: F401
from . import models  # noqa: F401
from . import gluon  # noqa: F401
from . import convert  # noqa: F401
from . import threads  # noqa: F401
from . import test_utils  # noqa: F401
from . import visualization  # noqa: F401
from .visualization import plot_network  # noqa: F401
from . import log  # noqa: F401
from . import misc  # noqa: F401
from . import engine  # noqa: F401
from . import libinfo  # noqa: F401
