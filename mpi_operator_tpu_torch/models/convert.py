"""Parameters for the port's LMs (CausalLM, MaskedLM): converted from the
reference's flax tree, or drawn at random for the card.

`params_from_flax(cfg, tree)` takes the JAX model's `params` collection
as nested dicts of NUMPY arrays (the tests hand it `jax.tree.map(
np.asarray, params)`; nothing here touches JAX) and returns the port's
state dict. The layouts it translates:

  DenseGeneral query/key/value  kernel [E, H, D], bias [H, D]
                                -> Linear weight [H*D, E], bias [H*D]
  DenseGeneral out              kernel [H, D, E] -> weight [E, H*D]
  nn.Dense (fc_in/fc_gate/fc_out, mlm_dense, the MoE router)
                                kernel [in, out] -> weight [out, in]
  wte / wpe / wtte              embedding [N, E] -> weight [N, E]
  LayerNorm                     scale, bias -> weight, bias
  RMSNorm                       scale -> weight
  MoE w_in / w_out, mlm_bias    as they are

`init_params(cfg, generator)` draws the same shapes the way the
reference initializes them: every kernel and embedding normal(0, 0.02)
(`kernel_init`, the MoE experts and router too), biases zero
(`mlm_bias` too), norm scales one — on the generator's device, so a
full-width model never round-trips through host memory.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .transformer import TransformerConfig, param_shapes, uses_moe


def params_from_flax(cfg: TransformerConfig,
                     tree: Mapping) -> Dict[str, torch.Tensor]:
    """The flax `params` tree (nested dicts of numpy arrays) as the
    port's f32 state dict."""
    E, H, KV, D = cfg.embed_dim, cfg.num_heads, cfg.kv_heads, cfg.head_dim

    def t(x, shape=None):
        a = np.array(x, dtype=np.float32)       # a writable copy
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(np.ascontiguousarray(a))

    def norm(node, prefix, out):
        out[prefix + ".weight"] = t(node["scale"])
        if cfg.norm == "layernorm":
            out[prefix + ".bias"] = t(node["bias"])

    def dense(node, prefix, out):
        out[prefix + ".weight"] = t(np.asarray(node["kernel"]).T)
        if "bias" in node:
            out[prefix + ".bias"] = t(node["bias"])

    out: Dict[str, torch.Tensor] = {"wte.weight": t(tree["wte"]["embedding"])}
    for name in ("wpe", "wtte"):
        if name in tree:
            out[name + ".weight"] = t(tree[name]["embedding"])
    if "ln_emb" in tree:
        norm(tree["ln_emb"], "ln_emb", out)
    bb = tree["backbone"]
    for i in range(cfg.num_layers):
        blk = bb[f"block_{i}"]
        p = f"backbone.blocks.{i}."
        norm(blk["ln_1"], p + "ln_1", out)
        norm(blk["ln_2"], p + "ln_2", out)
        attn = blk["attn"]
        for name, heads in (("query", H), ("key", KV), ("value", KV)):
            k = np.asarray(attn[name]["kernel"]).reshape(E, heads * D)
            out[p + f"attn.{name}.weight"] = t(k.T)
            out[p + f"attn.{name}.bias"] = t(attn[name]["bias"], heads * D)
        wo = np.asarray(attn["out"]["kernel"]).reshape(H * D, E)
        out[p + "attn.out.weight"] = t(wo.T)
        out[p + "attn.out.bias"] = t(attn["out"]["bias"])
        if uses_moe(cfg, i):
            moe = blk["moe"]
            dense(moe["router"], p + "moe.router", out)
            out[p + "moe.w_in"] = t(moe["w_in"])
            out[p + "moe.w_out"] = t(moe["w_out"])
            continue
        mlp = blk["mlp"]
        for name in ("fc_gate", "fc_in", "fc_out"):
            if name in mlp:
                dense(mlp[name], p + f"mlp.{name}", out)
    norm(bb["ln_f"], "backbone.ln_f", out)
    if "mlm_dense" in tree:
        dense(tree["mlm_dense"], "mlm_dense", out)
        norm(tree["mlm_ln"], "mlm_ln", out)
        out["mlm_bias"] = t(tree["mlm_bias"])
    missing = set(param_shapes(cfg)) - set(out)
    if missing:
        raise KeyError(f"flax tree lacks {sorted(missing)[:4]}...")
    for k, shape in param_shapes(cfg).items():
        if tuple(out[k].shape) != shape:
            raise ValueError(f"{k}: converted shape {tuple(out[k].shape)} "
                             f"!= {shape}")
    return out


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """Random f32 parameters drawn from `generator` (on its device unless
    `device` says otherwise): weights and embeddings normal(0, 0.02),
    biases zero, norm scales one."""
    dev = torch.device(device) if device is not None else generator.device
    out: Dict[str, torch.Tensor] = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[0].rsplit(".", 1)[-1]
        if leaf.startswith("ln_") or leaf == "mlm_ln":
            fill = 1.0 if name.endswith("weight") else 0.0
            out[name] = torch.full(shape, fill, device=dev)
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=dev)
        else:
            out[name] = torch.empty(shape, device=dev).normal_(
                0.0, 0.02, generator=generator)
    return out


__all__ = ["params_from_flax", "init_params"]
