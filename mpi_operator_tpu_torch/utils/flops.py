"""FLOPs accounting and MFU (model FLOPs utilization) for the card.

Copies of the reference's analytic accounting
(`mpi_operator_tpu/utils/flops.py`): the 6N + attention model FLOPs a
training step does, the ResNet table (3x the forward, scaled with the
image area, the s2d stem's adjustment), the parameter count, and MFU
against the device's peak. For ViT, whose reference trainer reads XLA's
compiled count, `vit_train_flops_per_image` is the analytic count the
port's MFU uses. The peak is looked up by the CUDA device's name; a device this
table does not know (and the CPU) gives `mfu=None`, never a figure taken
for another chip.

All `flops_per_step` values are GLOBAL (every device's share); MFU is
flops_per_step * steps_per_sec / (n_devices * peak).

Decode is bound by HBM bandwidth: `decode_bytes_per_step` counts the
bytes a step must read and `mbu` divides the achieved rate by the card's
bandwidth (`device_hbm_bandwidth`, an H100 table only: the CPU and any
card the table does not know give None).
"""
from __future__ import annotations

from typing import Iterable, Mapping, Optional, Union

import torch

# dense bf16 tensor-core peak FLOP/s by device-name substring (NVIDIA's
# data sheets, SXM parts; the PCIe H100 has a lower peak and is not
# listed): H100 SXM and H200 989e12
_PEAK_TABLE = (
    ("h100 80gb hbm3", 989e12), ("h100 sxm", 989e12), ("h200", 989e12),
)


# HBM bytes/s by device-name substring (NVIDIA's data sheet: the H100
# SXM's 80 GB of HBM3 at 3.35 TB/s)
_HBM_TABLE = (("h100 80gb hbm3", 3.35e12), ("h100 sxm", 3.35e12))


def _device_name(device) -> Optional[str]:
    """The CUDA device's name (a name string passes through); None for
    the CPU or when no card is present."""
    if isinstance(device, str) and device not in ("cuda", "cpu") \
            and not device.startswith("cuda:"):
        return device
    dev = torch.device("cuda" if device is None else device) \
        if not isinstance(device, int) else torch.device("cuda", device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(dev)


def _lookup(device, table) -> Optional[float]:
    name = _device_name(device)
    if name is None:
        return None
    name = name.lower()
    for marker, value in table:
        if marker in name:
            return value
    return None


def device_peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one device; None for the CPU or a card
    the table does not know. `device`: a torch.device, a CUDA index, a
    device name string, or None for the current CUDA device."""
    return _lookup(device, _PEAK_TABLE)


def device_hbm_bandwidth(device=None) -> Optional[float]:
    """Peak HBM bytes/s of one device (same `device` forms as
    device_peak_flops); None for the CPU or a card the table does not
    know."""
    return _lookup(device, _HBM_TABLE)


def decode_bytes_per_step(num_params: int, num_layers: int,
                          num_kv_heads: int, head_dim: int,
                          batch: int, avg_len: float,
                          param_bytes: int = 2,
                          kv_cache_bytes: float = 2.0,
                          kv_scale_bytes: float = 0.0) -> float:
    """HBM bytes one autoregressive decode step must read — the roofline
    numerator for MBU: the full parameter set once (shared by the batch)
    plus each row's KV cache at its current length. `kv_cache_bytes` is
    per cached element (2 bf16, 1 int8); `kv_scale_bytes` covers the
    quantization scales per (position, head) per k/v tensor (4 for one
    f32 scale)."""
    params = num_params * param_bytes
    kv_per_pos = 2 * num_layers * num_kv_heads * (
        head_dim * kv_cache_bytes + kv_scale_bytes)
    return params + batch * avg_len * kv_per_pos


def mbu(bytes_per_step: float, steps_per_sec: float,
        device=None) -> Optional[float]:
    """Achieved fraction of peak HBM bandwidth (one device); None when
    the device's bandwidth is unknown."""
    bw = device_hbm_bandwidth(device)
    if not bw or not bytes_per_step:
        return None
    return bytes_per_step * steps_per_sec / bw


def transformer_train_flops_per_token(num_params: int, num_layers: int,
                                      embed_dim: int, seq_len: int,
                                      causal: bool = True) -> float:
    """Standard accounting (PaLM appendix B): 6N matmul FLOPs per token for
    fwd+bwd, plus attention logits/values 12·L·E·S (halved for causal)."""
    attn = 12.0 * num_layers * embed_dim * seq_len
    if causal:
        attn /= 2.0
    return 6.0 * num_params + attn


# forward FLOPs per 224x224 image (the reference's table: the widely
# quoted GFLOPs, which are multiply-accumulates, doubled)
_RESNET_FWD_FLOPS_224 = {
    "resnet18": 3.64e9,
    "resnet34": 7.36e9,
    "resnet50": 8.24e9,
    "resnet101": 15.70e9,
    "resnet152": 23.16e9,
}


def resnet_train_flops_per_image(model_name: str,
                                 image_size: int = 224,
                                 stem: str = "conv7") -> Optional[float]:
    """fwd+bwd FLOPs per image ~ 3x forward, conv FLOPs scaled with the
    spatial area from the 224 px table. The "s2d" stem swaps the 7x7/2
    conv (2 * 112^2 * 64 * 7*7*3 = 236.0 MF at 224 px) for a 2x2 conv
    over 48 channels (2 * 56^2 * 64 * 2*2*48 = 77.1 MF). None for an
    architecture the table does not know."""
    fwd = _RESNET_FWD_FLOPS_224.get(model_name)
    if fwd is None:
        return None
    if stem == "s2d":
        fwd = fwd - (236.0e6 - 77.1e6)
    return 3.0 * fwd * (image_size / 224.0) ** 2


def vit_train_flops_per_image(backbone_params: int, num_layers: int,
                              embed_dim: int, num_patches: int,
                              patch_dim: int, num_classes: int) -> float:
    """fwd+bwd model FLOPs of one image through a ViT: every token
    (patches + cls) through the backbone at 6N + the non-causal
    attention term (`transformer_train_flops_per_token`), the patch
    embedding GEMM (6 x patch_dim x E a patch) and the head on the cls
    token (6 x E x classes). The reference's trainer reads XLA's
    compiled count instead, which the port cannot have."""
    tokens = num_patches + 1
    per_token = transformer_train_flops_per_token(
        backbone_params, num_layers, embed_dim, tokens, causal=False)
    return (tokens * per_token + 6.0 * num_patches * patch_dim * embed_dim
            + 6.0 * embed_dim * num_classes)


def param_count(params: Union[torch.nn.Module, Mapping, Iterable]) -> int:
    """Elements of every parameter: a module's parameters, a state
    dict's values, or an iterable of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    elif isinstance(params, Mapping):
        params = params.values()
    return sum(int(p.numel()) for p in params)


def mfu(flops_per_step: Optional[float], steps_per_sec: float,
        n_devices: int, device=None) -> Optional[float]:
    """Achieved fraction of peak, per device. `flops_per_step` is the
    GLOBAL model FLOPs of one step. None when either side of the ratio
    is unknown."""
    peak = device_peak_flops(device)
    if not flops_per_step or not peak or n_devices <= 0:
        return None
    return flops_per_step * steps_per_sec / (n_devices * peak)


def throughput_stats(flops_per_step: Optional[float], steps_per_sec: float,
                     n_devices: int, device=None) -> dict:
    """The metric triple the trainer reports: global flops_per_step,
    per-device TFLOP/s, and MFU (None-safe)."""
    tfl = (flops_per_step * steps_per_sec / n_devices / 1e12
           if flops_per_step and n_devices > 0 else None)
    return {
        "flops_per_step": flops_per_step,
        "tflops_per_sec_per_device": tfl,
        "mfu": mfu(flops_per_step, steps_per_sec, n_devices, device),
    }


__all__ = ["decode_bytes_per_step", "device_hbm_bandwidth",
           "device_peak_flops", "mbu", "transformer_train_flops_per_token",
           "param_count", "mfu", "resnet_train_flops_per_image",
           "throughput_stats", "vit_train_flops_per_image"]
