"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see attention.py)."""
from .attention import (  # noqa: F401
    FlashAttention, decode_attention, decode_attention_ref, decode_block_k,
    flash_attention, flash_delta, flash_dkv, flash_dkv_ref, flash_dq,
    flash_dq_ref, flash_fwd, flash_fwd_ref, gather_pages,
    launch_counts, paged_decode_attention, paged_decode_attention_ref,
    reset_launch_counts,
)

__all__ = ["FlashAttention", "decode_attention", "decode_attention_ref",
           "decode_block_k", "flash_attention", "flash_delta", "flash_dkv",
           "flash_dkv_ref", "flash_dq", "flash_dq_ref", "flash_fwd",
           "flash_fwd_ref", "gather_pages", "launch_counts",
           "paged_decode_attention", "paged_decode_attention_ref",
           "reset_launch_counts"]
