from .convert import (init_params, init_vit, params_from_flax,  # noqa: F401
                      resnet_params_from_flax, vit_params_from_flax)
from .generate import (  # noqa: F401
    GenerateResult, cast_params, decode_model, generate,
)
from .resnet import ResNet, create_model  # noqa: F401
from .transformer import (  # noqa: F401
    CausalLM, KVCache, MaskedLM, TransformerConfig, ViT, bert_config,
    build_lm, create_lm, create_vit, gpt2_config, llama_config, lm_config,
    vit_config,
)

__all__ = ["CausalLM", "GenerateResult", "KVCache", "MaskedLM", "ResNet",
           "TransformerConfig", "ViT", "bert_config", "build_lm",
           "cast_params", "create_lm", "create_model", "create_vit",
           "decode_model", "generate", "gpt2_config", "init_params",
           "init_vit", "llama_config", "lm_config", "params_from_flax",
           "resnet_params_from_flax", "vit_config", "vit_params_from_flax"]
