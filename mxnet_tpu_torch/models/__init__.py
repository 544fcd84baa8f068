"""Symbol builders for the models the port serves."""
from .transformer_lm import transformer_lm_symbol  # noqa: F401
