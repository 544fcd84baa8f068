"""mxnet_tpu_torch.serving — in-process inference serving.

Counterpart of ``mxnet_tpu/serving``:

- the model registry with per-bucket predictors, int8 included
  (``registry.py``), the bounded admission queue (``admission.py``), the
  dynamic batcher (``batcher.py``), and the ``Server`` futures API with
  warmup verification, the HTTP front end and the SIGTERM drain
  (``server.py``);
- the fleet tier: replica groups behind one admission queue with a
  least-loaded router, quarantine and redispatch (``router.py``);
- continuous batching of recurrent decode over one fixed-shape step
  (``continuous.py``);
- the paged-KV tier for autoregressive transformer decode: the block
  pool with prefix reuse and copy-on-write (``kv_cache.py``) and the
  decoder, one CUDA graph a step on the card (``decode.py``);
- typed rejections (``errors.py``) and the serving instruments on the
  metrics registry (``metrics.py``).
"""
from __future__ import annotations

from .admission import (AdmissionController, Request, default_deadline_ms,
                        default_queue_depth)
from .batcher import DynamicBatcher
from .continuous import (ContinuousBatcher, DecodeStream, SlotScheduler,
                         default_slot_count)
from .decode import PagedDecodeStream, PagedTransformerDecoder
from .errors import (BadRequest, DeadlineExceeded, ModelNotFound,
                     NoHealthyReplica, Overloaded, RequestTooLarge,
                     ServerClosed, ServingError)
from .kv_cache import (KVBlockPool, default_page_tokens,
                       default_pool_pages, page_chain_hash)
from .registry import ModelRegistry, ServedModel, bucket_for, bucket_sizes
from .router import FleetServer, Replica, ReplicaGroup, Router, \
    default_replicas
from .server import Server

__all__ = [
    "AdmissionController", "BadRequest", "ContinuousBatcher",
    "DeadlineExceeded", "DecodeStream", "DynamicBatcher", "FleetServer",
    "KVBlockPool", "ModelNotFound", "ModelRegistry", "NoHealthyReplica",
    "Overloaded", "PagedDecodeStream", "PagedTransformerDecoder",
    "Replica", "ReplicaGroup", "Request", "RequestTooLarge", "Router",
    "ServedModel", "Server", "ServerClosed", "ServingError",
    "SlotScheduler", "bucket_for", "bucket_sizes", "default_deadline_ms",
    "default_page_tokens", "default_pool_pages", "default_queue_depth",
    "default_replicas", "default_slot_count", "page_chain_hash",
]
