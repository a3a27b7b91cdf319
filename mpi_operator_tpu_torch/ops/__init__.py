"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see attention.py)."""
from .attention import (  # noqa: F401
    decode_attention, decode_attention_ref, decode_block_k, gather_pages,
    launch_counts, paged_decode_attention, paged_decode_attention_ref,
    reset_launch_counts,
)

__all__ = ["decode_attention", "decode_attention_ref", "decode_block_k",
           "gather_pages", "launch_counts", "paged_decode_attention",
           "paged_decode_attention_ref", "reset_launch_counts"]
