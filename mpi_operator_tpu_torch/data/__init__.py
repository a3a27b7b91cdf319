"""Input data for the port's trainers (see synthetic.py)."""
from .synthetic import TokenStream, synthetic_token_batch  # noqa: F401

__all__ = ["TokenStream", "synthetic_token_batch"]
