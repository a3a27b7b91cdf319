from .convert import init_params, params_from_flax  # noqa: F401
from .generate import (  # noqa: F401
    GenerateResult, cast_params, decode_model, generate,
)
from .transformer import (  # noqa: F401
    CausalLM, KVCache, TransformerConfig, build_lm, create_lm, gpt2_config,
    llama_config, lm_config,
)

__all__ = ["CausalLM", "GenerateResult", "KVCache", "TransformerConfig",
           "build_lm", "cast_params", "create_lm", "decode_model",
           "generate", "gpt2_config", "init_params", "llama_config",
           "lm_config", "params_from_flax"]
