"""mxnet_tpu_torch.serving — in-process dynamic-batching inference.

Counterpart of ``mxnet_tpu/serving`` (the single-server core): the model
registry with per-bucket predictors (``registry.py``), the bounded
admission queue (``admission.py``), the dynamic batcher (``batcher.py``),
the ``Server`` futures API with warmup verification (``server.py``),
typed rejections (``errors.py``) and counters (``metrics.py``).
"""
from __future__ import annotations

from .admission import (AdmissionController, Request, default_deadline_ms,
                        default_queue_depth)
from .batcher import DynamicBatcher
from .errors import (BadRequest, DeadlineExceeded, ModelNotFound, Overloaded,
                     RequestTooLarge, ServerClosed, ServingError)
from .registry import ModelRegistry, ServedModel, bucket_for, bucket_sizes
from .server import Server

__all__ = [
    "AdmissionController", "BadRequest", "DeadlineExceeded",
    "DynamicBatcher", "ModelNotFound", "ModelRegistry", "Overloaded",
    "Request", "RequestTooLarge", "ServedModel", "Server", "ServerClosed",
    "ServingError", "bucket_for", "bucket_sizes", "default_deadline_ms",
    "default_queue_depth",
]
