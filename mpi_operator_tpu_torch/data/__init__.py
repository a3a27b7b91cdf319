"""Input data for the port's trainers: synthetic step-keyed batches
(synthetic.py) and packed token shards behind a prefetch thread
(tokenstream.py, prefetch.py)."""
from .prefetch import PrefetchDataset  # noqa: F401
from .synthetic import TokenStream, synthetic_token_batch  # noqa: F401
from .tokenstream import (NpyTokenDataset, discover_token_shards,  # noqa: F401
                          write_token_shard)

__all__ = ["NpyTokenDataset", "PrefetchDataset", "TokenStream",
           "discover_token_shards", "synthetic_token_batch",
           "write_token_shard"]
