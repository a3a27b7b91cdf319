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

`params_from_stacked(cfg, stacked, pp, interleave)` takes the
reference's pipeline layout instead (`stack_lm_params` /
`stack_mlm_params` of its pp trainer: the dense blocks stacked on a
leading layer dim under "blocks", the MoE blocks under "moe", each leaf
[L', ...]; under 1F1B with interleave > 1 the dense stack in its
device-major order, `interleave_blocks`) and returns the same whole-model
state dict: the stacks unstacked into `block_{i}` by the MoE alternation
and the interleave's inverse permutation, then `params_from_flax`. An
optax moment tree of the same layout (mu, nu) converts the same way.

`init_params(cfg, generator)` draws the same shapes the way the
reference initializes them: every kernel and embedding normal(0, 0.02)
(`kernel_init`, the MoE experts and router too), biases zero
(`mlm_bias` too), norm scales one — on the generator's device, so a
full-width model never round-trips through host memory.

The image models (train/trainer.py):

  `resnet_params_from_flax(model, params, batch_stats)`: the flax
  ResNet's `params` and `batch_stats` as the port ResNet's state dict.
  nn.Conv kernel HWIO [kh, kw, in, out] -> weight OIHW [out, in, kh,
  kw]; BatchNorm scale, bias -> weight, bias and its batch_stats mean,
  var -> running_mean, running_var; the blocks, auto-named by flax in
  creation order (`BottleneckResNetBlock_<k>` / `ResNetBlock_<k>`,
  inside them `Conv_<j>` / `BatchNorm_<j>`, `conv_proj`, `norm_proj`),
  are the port's `blocks.<k>.conv<j>` / `bn<j>`; the head Dense as
  above.
  `vit_params_from_flax(cfg, params)`: the ViT's `patch_embed` conv
  kernel [p, p, C, E] flattened to [p*p*C, E] in (kh, kw, c) order and
  transposed to a Linear weight, its bias, `cls` [1, 1, E], the `pos`
  table [N + 1, E], the backbone as the LMs', the head Dense.
  `init_vit(model, generator)` draws a ViT as the reference does:
  normal(0, 0.02) kernels and tables, zero biases and `cls`, norm
  scales one. (The ResNet's draw is `models/resnet.py init_resnet`.)
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping

import numpy as np
import torch

from .transformer import TransformerConfig, param_shapes, uses_moe


def params_from_flax(cfg: TransformerConfig,
                     tree: Mapping) -> Dict[str, torch.Tensor]:
    """The flax `params` tree (nested dicts of numpy arrays) as the
    port's f32 state dict."""
    t, norm = _t, functools.partial(_norm, cfg)
    out: Dict[str, torch.Tensor] = {"wte.weight": t(tree["wte"]["embedding"])}
    for name in ("wpe", "wtte"):
        if name in tree:
            out[name + ".weight"] = t(tree[name]["embedding"])
    if "ln_emb" in tree:
        norm(tree["ln_emb"], "ln_emb", out)
    _backbone_from_flax(cfg, tree["backbone"], out)
    if "mlm_dense" in tree:
        _dense(tree["mlm_dense"], "mlm_dense", out)
        _norm(cfg, tree["mlm_ln"], "mlm_ln", out)
        out["mlm_bias"] = _t(tree["mlm_bias"])
    missing = set(param_shapes(cfg)) - set(out)
    if missing:
        raise KeyError(f"flax tree lacks {sorted(missing)[:4]}...")
    for k, shape in param_shapes(cfg).items():
        if tuple(out[k].shape) != shape:
            raise ValueError(f"{k}: converted shape {tuple(out[k].shape)} "
                             f"!= {shape}")
    return out


def _take(node, i):
    """Row i of every leaf of a stacked (nested dict) tree."""
    if isinstance(node, Mapping):
        return {k: _take(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def params_from_stacked(cfg: TransformerConfig, stacked: Mapping,
                        pp: int = 1, interleave: int = 1
                        ) -> Dict[str, torch.Tensor]:
    """The reference pp trainer's stacked tree (see the module docstring;
    nested dicts of numpy arrays) as the port's whole-model f32 state
    dict. `pp` and `interleave` name the 1F1B device-major order the
    dense stack was written in (interleave 1: canonical order)."""
    from ..parallel.pipeline import _moe_layer_split
    from ..parallel.pipeline_1f1b import interleave_order
    dense_idx, moe_idx = _moe_layer_split(cfg.num_layers, cfg.num_experts,
                                          cfg.moe_every)
    rows = list(range(len(dense_idx)))
    if interleave > 1:
        if moe_idx:
            raise ValueError("an interleaved stack is dense (1F1B does not "
                             "compose with MoE)")
        # position j of the stored stack holds canonical layer order[j]
        order = interleave_order(cfg.num_layers, pp, interleave)
        rows = [order.index(i) for i in range(cfg.num_layers)]
    backbone = {"ln_f": stacked["ln_f"]}
    for j, i in enumerate(dense_idx):
        backbone[f"block_{i}"] = _take(stacked["blocks"], rows[j])
    for j, i in enumerate(moe_idx):
        backbone[f"block_{i}"] = _take(stacked["moe"], j)
    tree = {"wte": {"embedding": stacked["wte"]},
            "wpe": {"embedding": stacked["wpe"]}, "backbone": backbone}
    if "wtte" in stacked:
        tree["wtte"] = {"embedding": stacked["wtte"]}
    for name in ("ln_emb", "mlm_dense", "mlm_ln", "mlm_bias"):
        if name in stacked:
            tree[name] = stacked[name]
    return params_from_flax(cfg, tree)


def _t(x, shape=None) -> torch.Tensor:
    """A writable f32 copy of a numpy leaf (reshaped to `shape`)."""
    a = np.array(x, dtype=np.float32)
    if shape is not None:
        a = a.reshape(shape)
    return torch.from_numpy(np.ascontiguousarray(a))


def _norm(cfg, node, prefix, out):
    out[prefix + ".weight"] = _t(node["scale"])
    if cfg.norm == "layernorm":
        out[prefix + ".bias"] = _t(node["bias"])


def _dense(node, prefix, out):
    out[prefix + ".weight"] = _t(np.asarray(node["kernel"]).T)
    if "bias" in node:
        out[prefix + ".bias"] = _t(node["bias"])


def _backbone_from_flax(cfg: TransformerConfig, bb: Mapping, out) -> None:
    """The flax Backbone's blocks and ln_f into `out` (`backbone.*`)."""
    E, H, KV, D = cfg.embed_dim, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    t, norm, dense = _t, functools.partial(_norm, cfg), _dense
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


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """Random f32 parameters drawn from `generator` (on its device unless
    `device` says otherwise): weights and embeddings normal(0, 0.02),
    biases zero, norm scales one."""
    return dict(draw_params(cfg, generator, device))


def draw_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None):
    """`init_params` one (name, tensor) at a time, in `param_shapes`
    order: the same draws, with one parameter alive at a time for a
    caller that keeps only its shard (parallel/sharding.shard_init)."""
    return _draw_iter(param_shapes(cfg).items(), generator, device)


def _draw(shapes, generator: torch.Generator,
          device=None) -> Dict[str, torch.Tensor]:
    return dict(_draw_iter(shapes, generator, device))


def _draw_iter(shapes, generator: torch.Generator, device=None):
    """init_params' rules over (name, shape) pairs: norm scales one,
    biases (and `cls`) zero, everything else normal(0, 0.02)."""
    dev = torch.device(device) if device is not None else generator.device
    for name, shape in shapes:
        leaf = name.rsplit(".", 1)[0].rsplit(".", 1)[-1]
        if leaf.startswith("ln_") or leaf == "mlm_ln":
            fill = 1.0 if name.endswith("weight") else 0.0
            yield name, torch.full(shape, fill, device=dev)
        elif name.endswith("bias") or name == "cls":
            yield name, torch.zeros(shape, device=dev)
        else:
            yield name, torch.empty(shape, device=dev).normal_(
                0.0, 0.02, generator=generator)


# ---------------------------------------------------------------------------
# the image models
# ---------------------------------------------------------------------------

def init_vit(model, generator: torch.Generator,
             device=None) -> Dict[str, torch.Tensor]:
    """Random f32 parameters for a ViT (see the module docstring)."""
    return _draw(((n, tuple(p.shape)) for n, p in model.named_parameters()),
                 generator, device)


def vit_params_from_flax(cfg: TransformerConfig,
                         tree: Mapping) -> Dict[str, torch.Tensor]:
    """The flax ViT's `params` tree (nested dicts of numpy arrays) as
    the port ViT's f32 state dict."""
    k = np.asarray(tree["patch_embed"]["kernel"])
    out = {"patch_embed.weight": _t(k.reshape(-1, k.shape[-1]).T),
           "patch_embed.bias": _t(tree["patch_embed"]["bias"]),
           "cls": _t(tree["cls"]),
           "pos.weight": _t(tree["pos"]["embedding"])}
    _backbone_from_flax(cfg, tree["backbone"], out)
    _dense(tree["head"], "head", out)
    return out


def resnet_params_from_flax(model, params: Mapping,
                            batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The flax ResNet's `params` and `batch_stats` (nested dicts of
    numpy arrays) as the state dict of the port ResNet `model` (which
    may live on the meta device: only its structure is read)."""
    out: Dict[str, torch.Tensor] = {}

    def conv(node, prefix):
        out[prefix + ".weight"] = _t(np.asarray(node["kernel"])
                                     .transpose(3, 2, 0, 1))

    def bn(node, stats, prefix):
        out[prefix + ".weight"] = _t(node["scale"])
        out[prefix + ".bias"] = _t(node["bias"])
        out[prefix + ".running_mean"] = _t(stats["mean"])
        out[prefix + ".running_var"] = _t(stats["var"])

    conv(params["conv_init"], "conv_init")
    bn(params["bn_init"], batch_stats["bn_init"], "bn_init")
    for k, block in enumerate(model.blocks):
        name = f"{type(block).__name__}_{k}"
        node, stats, p = params[name], batch_stats[name], f"blocks.{k}."
        j = 0
        while hasattr(block, f"conv{j}"):
            conv(node[f"Conv_{j}"], p + f"conv{j}")
            bn(node[f"BatchNorm_{j}"], stats[f"BatchNorm_{j}"], p + f"bn{j}")
            j += 1
        if block.has_proj:
            conv(node["conv_proj"], p + "conv_proj")
            bn(node["norm_proj"], stats["norm_proj"], p + "norm_proj")
    _dense(params["head"], "head", out)
    return out


__all__ = ["draw_params", "init_params", "init_vit", "params_from_flax",
           "params_from_stacked", "resnet_params_from_flax",
           "vit_params_from_flax"]
