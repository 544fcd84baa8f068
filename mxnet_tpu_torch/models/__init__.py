"""Symbol builders for the models the port serves and trains."""
from . import resnet  # noqa: F401
from .transformer_lm import transformer_lm_symbol  # noqa: F401
