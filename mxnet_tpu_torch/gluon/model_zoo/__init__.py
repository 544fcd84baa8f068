"""Gluon model zoo: the decoder-only TransformerLM."""
from . import transformer  # noqa: F401
from .transformer import TransformerBlock, TransformerLM, transformer_lm  # noqa: F401
