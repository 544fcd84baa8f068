"""mx.nd namespace: NDArray, its constructors and the ``.params`` format.
Imperative op functions (``mx.nd.FullyConnected``) come with autograd."""
from __future__ import annotations

from .ndarray import NDArray, array, load, loads, save, zeros  # noqa: F401
