"""Input data for the port's trainers: synthetic step-keyed batches
(synthetic.py) and packed token shards behind a prefetch thread
(tokenstream.py, prefetch.py)."""
from .prefetch import PrefetchDataset  # noqa: F401
from .synthetic import (MLM_MASK_RATE, TokenStream,  # noqa: F401
                        synthetic_token_batch)
from .tokenstream import (NpyTokenDataset, discover_token_shards,  # noqa: F401
                          mlm_host_transform, write_token_shard)

__all__ = ["MLM_MASK_RATE", "NpyTokenDataset", "PrefetchDataset",
           "TokenStream", "discover_token_shards", "mlm_host_transform",
           "synthetic_token_batch", "write_token_shard"]
