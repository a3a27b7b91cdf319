"""Parallel building blocks of the port; so far the mixture-of-experts
FFN on one device (moe.py). The meshes and collectives are a later
slice."""
from .moe import MoeMlp  # noqa: F401

__all__ = ["MoeMlp"]
