"""Input data for the port's trainers: synthetic step-keyed batches
(synthetic.py), packed token shards (tokenstream.py) and image shards
(imagefolder.py) behind a prefetch thread (prefetch.py)."""
from .imagefolder import (NpyImageDataset, discover_shards,  # noqa: F401
                          write_npy_shard)
from .prefetch import PrefetchDataset  # noqa: F401
from .synthetic import (MLM_MASK_RATE, SyntheticImageDataset,  # noqa: F401
                        TokenStream, synthetic_image_batch,
                        synthetic_token_batch)
from .tokenstream import (NpyTokenDataset, discover_token_shards,  # noqa: F401
                          mlm_host_transform, write_token_shard)

__all__ = ["MLM_MASK_RATE", "NpyImageDataset", "NpyTokenDataset",
           "PrefetchDataset", "SyntheticImageDataset", "TokenStream",
           "discover_shards", "discover_token_shards", "mlm_host_transform",
           "synthetic_image_batch", "synthetic_token_batch",
           "write_npy_shard", "write_token_shard"]
