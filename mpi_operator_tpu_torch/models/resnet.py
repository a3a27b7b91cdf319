"""ResNet v1.5 in PyTorch: the counterpart of `mpi_operator_tpu/models/
resnet.py`, the image benchmark's model family (ResNet-18/34/50/101/152,
basic and bottleneck blocks, the stride on the bottleneck's 3x3).

Layout. The model takes NHWC images, as the reference does. The stem
permutes them to NCHW with `permute(0, 3, 1, 2)`, which is a view whose
memory is still NHWC: PyTorch's `channels_last` format, so cuDNN runs
every conv in NHWC; the conv weights are cast to the compute dtype in
the same format per use. Compute is in `dtype` (bf16) over f32
parameters, and the classifier head runs in f32 on the mean-pooled
features, as the reference's.

What the reference gets from flax and XLA is written out here:

- **`SAME` padding** (`same_pad`). flax pads a stride-2 window on an
  even input by (0, 1), not (1, 1): the strided 3x3 convs, the stem's
  3x3 max-pool (padded with -inf) and the s2d stem's 2x2 conv. Where
  the two sides differ, the input is padded with `F.pad` and the conv
  or pool runs unpadded; where they agree the conv pads itself.
- **BatchNorm** (`BatchNorm`, `_BatchNormTrain`). flax's `momentum=0.9`
  keeps 0.9 of the running value (torch's `momentum=0.1`). The batch
  statistics are f32 sums of x and x^2 under any compute dtype, the
  variance E[x^2] - E[x]^2 clipped at 0, and the running variance folds
  in that BIASED variance (`torch.nn.BatchNorm2d` folds in the unbiased
  one, n / (n - 1) larger). The normalisation runs in f32, the output
  is cast to the compute dtype. The last BN of each block starts with a
  zero scale.
- **BatchNorm across data-parallel ranks.** The reference shards the
  batch over a mesh, so its batch mean is a GLOBAL mean. When
  torch.distributed runs more than one rank, the training BN all-
  reduces its f32 [sum x, sum x^2, n] in the forward and the two sums
  of its backward ([sum dy, sum dy * x_hat]), so statistics and input
  gradients are those of the global batch on every rank (the
  parameter gradients stay local sums, which DistributedDataParallel
  averages). `torch.nn.SyncBatchNorm` does the same on the card only.

A train-mode forward leaves each BN's new running statistics pending
(`pending`) instead of writing them: the trainer folds them into its
state under the non-finite guard (`new_batch_stats`), a caller outside
the trainer with `commit_batch_stats()` — flax's
`mutable=["batch_stats"]`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, rank_and_world, resolve_device

#: flax BatchNorm(momentum=0.9): running <- 0.9 running + 0.1 batch
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over every rank, in place (itself with one rank)."""
    if rank_and_world()[1] > 1:
        dist.all_reduce(t)
    return t


def _same(n: int, k: int, s: int):
    """flax/XLA `SAME` padding of one spatial dim: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """(x, conv padding): x padded by F.pad where `SAME` is asymmetric
    (padding then 0), else x as it is and the symmetric padding for the
    conv to apply. x is [B, C, H, W]."""
    (t, b), (l, r) = _same(x.shape[2], k, s), _same(x.shape[3], k, s)
    if t == b and l == r:
        return x, (t, l)
    x = F.pad(x, (l, r, t, b), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


class Conv(nn.Module):
    """flax nn.Conv(use_bias=False, padding="SAME") in `dtype`: an f32
    OIHW weight cast per use."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, padding=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.k, self.stride, self.dtype = k, stride, dtype
        self.padding = padding          # explicit (h, w), else SAME

    def forward(self, x):
        pad = self.padding
        if pad is None:
            x, pad = same_pad(x, self.k, self.stride)
        w = self.weight.to(self.dtype)
        if self.k > 1:      # a 1x1 kernel's OIHW is already channels_last
            w = w.contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=pad)


def _c(t: torch.Tensor) -> torch.Tensor:
    """A per-channel [C] vector broadcast over [B, C, H, W]."""
    return t[:, None, None]


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BN over [B, C, H, W] with the reference's statistics:
    f32 sums of x and x^2 (all-reduced over ranks with n), the biased
    variance E[x^2] - E[x]^2 clipped at 0, then (x - mean) *
    (rsqrt(var + eps) * scale) + bias in f32, cast to `dtype`. Returns
    (y, mean, var); saves only x and per-channel vectors, and recomputes
    x_hat in the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        x32 = x.float()
        dims = (0, 2, 3)
        stats = torch.cat([x32.sum(dims), (x32 * x32).sum(dims),
                           x32.new_full((1,), x32.numel() / x32.shape[1])])
        all_reduce_sum(stats)
        C = x.shape[1]
        n = stats[2 * C]
        mean = stats[:C] / n
        var = torch.clamp(stats[C:2 * C] / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + BN_EPS)
        y = ((x32 - _c(mean)) * _c(rstd * weight) + _c(bias)).to(dtype)
        ctx.save_for_backward(x, weight, mean, rstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd, n = ctx.saved_tensors
        dims = (0, 2, 3)
        xhat = (x.float() - _c(mean)) * _c(rstd)
        dy32 = dy.float()
        dbias = dy32.sum(dims)
        dweight = (dy32 * xhat).sum(dims)
        glob = all_reduce_sum(torch.stack([dbias, dweight])) / n
        dx = _c(weight * rstd) * (dy32 - _c(glob[0]) - xhat * _c(glob[1]))
        return dx.to(x.dtype), dweight, dbias, None


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) with f32 scale,
    bias and running statistics over [B, C, H, W] (see the module
    docstring)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))
        self.dtype = dtype
        self.zero_scale = zero_scale
        self.pending: Optional[List[torch.Tensor]] = None

    def forward(self, x, train: bool):
        if not train:
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return ((x.float() - _c(self.running_mean)) * _c(mul)
                    + _c(self.bias)).to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                             self.dtype)
        with torch.no_grad():
            m = BN_MOMENTUM
            self.pending = [m * self.running_mean + (1 - m) * mean,
                            m * self.running_var + (1 - m) * var]
        return y


class ResNetBlock(nn.Module):
    """Basic block (ResNet-18/34): two 3x3 convs, the stride on the
    first; a 1x1 projection where the shape changes."""
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype):
        super().__init__()
        self.conv0 = Conv(cin, filters, 3, stride, dtype)
        self.bn0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, 1, dtype)
        self.bn1 = BatchNorm(filters, dtype, zero_scale=True)
        self._proj(cin, filters, stride, dtype)

    def _proj(self, cin, filters, stride, dtype):
        cout = filters * self.expansion
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            self.conv_proj = Conv(cin, cout, 1, stride, dtype)
            self.norm_proj = BatchNorm(cout, dtype)

    def _main(self, x, train):
        y = F.relu_(self.bn0(self.conv0(x), train))
        return self.bn1(self.conv1(y), train)

    def forward(self, x, train: bool):
        y = self._main(x, train)
        if self.has_proj:
            x = self.norm_proj(self.conv_proj(x), train)
        return F.relu_(x + y)


class BottleneckResNetBlock(ResNetBlock):
    """Bottleneck block (ResNet-50/101/152): 1x1, 3x3 with the stride
    (v1.5), 1x1 to 4 x filters."""
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype):
        nn.Module.__init__(self)
        self.conv0 = Conv(cin, filters, 1, 1, dtype)
        self.bn0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, stride, dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, filters * 4, 1, 1, dtype)
        self.bn2 = BatchNorm(filters * 4, dtype, zero_scale=True)
        self._proj(cin, filters, stride, dtype)

    def _main(self, x, train):
        y = F.relu_(self.bn0(self.conv0(x), train))
        y = F.relu_(self.bn1(self.conv1(y), train))
        return self.bn2(self.conv2(y), train)


class ResNet(nn.Module):
    """The reference's `ResNet`: stem ("conv7": 7x7/2 conv, BN, ReLU,
    3x3/2 max-pool; "s2d": 4x4 space-to-depth, then a 2x2 conv over 48
    channels, BN, ReLU), the stages (a stride of 2 on the first block
    of every stage but the first), mean pooling, and an f32 head.
    `forward(images [B, H, W, C], train)` returns f32 logits."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, arch: str = "",
                 stem: str = "conv7"):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"stem={stem!r}; expected 'conv7' or 's2d'")
        self.dtype, self.arch, self.stem = dtype, arch, stem
        if stem == "s2d":
            self.conv_init = Conv(16 * 3, num_filters, 2, 1, dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, dtype,
                                  padding=(3, 3))
        self.bn_init = BatchNorm(num_filters, dtype)
        blocks, cin = [], num_filters
        for i, n in enumerate(stage_sizes):
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2 ** i, stride,
                                        dtype))
                cin = num_filters * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, images: torch.Tensor, train: bool = True):
        x = images.to(self.dtype)
        if self.stem == "s2d":
            B, H, W, C = x.shape
            if H % 4 or W % 4:
                raise ValueError(f"s2d stem needs H/W divisible by 4; got "
                                 f"{H}x{W}")
            x = x.reshape(B, H // 4, 4, W // 4, 4, C).transpose(2, 3)
            x = x.reshape(B, H // 4, W // 4, 16 * C)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = F.relu_(self.bn_init(self.conv_init(x), train))
        if self.stem == "conv7":
            x, pad = same_pad(x, 3, 2, value=float("-inf"))
            x = F.max_pool2d(x, 3, 2, padding=pad)
        for block in self.blocks:
            x = block(x, train)
        x = x.float().mean((2, 3)).to(self.dtype).float()
        return F.linear(x, self.head.weight, self.head.bias)

    # -- batch statistics --------------------------------------------------

    def batch_norms(self) -> List[BatchNorm]:
        return [m for m in self.modules() if isinstance(m, BatchNorm)]

    def new_batch_stats(self) -> torch.Tensor:
        """The running statistics the last train-mode forward computed,
        flat in `named_buffers()` order (each BN's mean, then its var)."""
        return torch.cat([t for bn in self.batch_norms()
                          for t in bn.pending])

    @torch.no_grad()
    def commit_batch_stats(self) -> None:
        """Write the pending statistics into the running buffers."""
        for bn in self.batch_norms():
            bn.running_mean.copy_(bn.pending[0])
            bn.running_var.copy_(bn.pending[1])


_STAGES = {
    "resnet18": ([2, 2, 2, 2], ResNetBlock),
    "resnet34": ([3, 4, 6, 3], ResNetBlock),
    "resnet50": ([3, 4, 6, 3], BottleneckResNetBlock),
    "resnet101": ([3, 4, 23, 3], BottleneckResNetBlock),
    "resnet152": ([3, 8, 36, 3], BottleneckResNetBlock),
}
MODELS = tuple(_STAGES)


def init_resnet(model: ResNet, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """Random f32 parameters and statistics for `model`'s names, drawn
    as flax initialises them: conv and head kernels lecun_normal
    (truncated normal, variance 1 / fan_in), head bias 0, BN scale 1
    (0 for the last BN of a block), bias 0, running mean 0 and var 1."""
    dev = torch.device(device) if device is not None else generator.device
    zero = {n for n, m in model.named_modules()
            if isinstance(m, BatchNorm) and m.zero_scale}
    out = {}
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        owner, leaf = name.rsplit(".", 1)
        if t.dim() > 1:                                 # a kernel
            fan_in = t[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            out[name] = torch.nn.init.trunc_normal_(
                torch.empty(t.shape, device=dev), 0.0, std, -2 * std,
                2 * std, generator=generator)
        elif leaf in ("weight", "running_var"):
            fill = 0.0 if leaf == "weight" and owner in zero else 1.0
            out[name] = torch.full(t.shape, fill, device=dev)
        else:
            out[name] = torch.zeros(t.shape, device=dev)
    return out


def create_model(name: str, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, stem: str = "conv7",
                 device: DeviceLike = None, seed: int = 0,
                 **kw) -> ResNet:
    """The named ResNet ("resnet18" ... "resnet152") with random f32
    parameters drawn from `seed` on the device (`init_resnet`). Runs on
    the CUDA card unless `device="cpu"`."""
    if name not in _STAGES:
        raise ValueError(f"unknown resnet {name!r}; have {sorted(_STAGES)}")
    dev = resolve_device(device)
    stages, block = _STAGES[name]
    with torch.device("meta"):
        model = ResNet(stages, block, num_classes=num_classes, dtype=dtype,
                       arch=name, stem=stem, **kw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.load_state_dict(init_resnet(model, gen, device=dev), assign=True)
    return model


__all__ = ["BN_EPS", "BN_MOMENTUM", "BatchNorm", "BottleneckResNetBlock",
           "Conv", "MODELS", "ResNet", "ResNetBlock", "all_reduce_sum",
           "create_model", "init_resnet", "same_pad"]
