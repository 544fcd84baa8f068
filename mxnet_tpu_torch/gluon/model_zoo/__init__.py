"""Gluon model zoo: the vision models, the decoder-only TransformerLM and
the local pretrained-weight store."""
from . import model_store  # noqa: F401
from . import vision  # noqa: F401
from . import transformer  # noqa: F401
from .transformer import TransformerBlock, TransformerLM, transformer_lm  # noqa: F401
