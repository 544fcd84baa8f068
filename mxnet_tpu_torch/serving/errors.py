"""Typed rejection errors for the serving layer.

Counterpart of ``mxnet_tpu/serving/errors.py``.  Every way the service can
refuse work is a distinct exception class with a stable ``reason`` slug,
shared by the raised exception and the ``serving.rejected_total.<reason>``
counter (``metrics.py``) and the status the HTTP front end
(``server.py``) answers with (``http_status``).
"""
from __future__ import annotations

from ..base import MXNetError


class ServingError(MXNetError):
    """Base class for every typed serving rejection."""

    reason = "serving_error"
    http_status = 500


class DeadlineExceeded(ServingError):
    """The request's deadline expired while it was still queued.  Raised
    BEFORE the request occupies a batch slot — an expired request is
    never dispatched and then discarded."""

    reason = "deadline_exceeded"
    http_status = 504


class Overloaded(ServingError):
    """Backpressure: the admission queue is full.  The caller should
    retry with backoff or shed load upstream."""

    reason = "overloaded"
    http_status = 429


class RequestTooLarge(ServingError):
    """The request's row count exceeds the service's ``max_batch_size``
    — it can never fit any bucket, so it is refused at submit time."""

    reason = "request_too_large"
    http_status = 413


class ServerClosed(ServingError):
    """The server is draining or shut down; no new work is admitted."""

    reason = "server_closed"
    http_status = 503


class ModelNotFound(ServingError):
    """No model registered under the requested name."""

    reason = "model_not_found"
    http_status = 404


class NoHealthyReplica(ServingError):
    """Every replica in the fleet group is quarantined: the batch had
    nowhere to run.  Distinct from ``Overloaded`` (healthy but full), so
    operators can tell capacity exhaustion from fleet death."""

    reason = "no_healthy_replica"
    http_status = 503


class BadRequest(ServingError):
    """Malformed request payload (HTTP front-end: unparsable JSON,
    missing inputs, wrong feature shape)."""

    reason = "bad_request"
    http_status = 400
