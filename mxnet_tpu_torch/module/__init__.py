"""mx.mod namespace: the symbolic training interface."""
from .base_module import BaseModule, BatchEndParam  # noqa: F401
from .module import Module  # noqa: F401
