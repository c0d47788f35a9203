"""ResNet-50 in PyTorch, in the JAX package's parameter layout.

Port of ``tpu_cc_manager/models/resnet.py`` (the training smoke's model):
bottleneck blocks with stages 3-4-6-3 (``ResNet50``) or 1-1 (``ResNetTiny``),
f32 parameters, activations in ``dtype`` (bf16 by default), BatchNorm with
momentum 0.9 and eps 1e-5, the ``bn3`` scale initialised to zero.

The model takes NHWC images, as the JAX model does, and computes in NCHW
with ``torch.channels_last`` memory, which is the same bytes. Convolutions
are ``torch.nn.functional.conv2d`` (cuDNN on the card), each weight cast to
``dtype`` on the fly. The JAX package computes its convolutions in plain XLA,
outside any Pallas kernel, so no hand-written kernel stands in for them.
The classifier is f32; its product follows
``torch.backends.cuda.matmul.allow_tf32``, which is off unless a caller
turns it on (``chip_smoke.py`` keeps it off).

Parameters are named after the flax modules (``stem_conv.kernel``,
``stage1_block0.bn2.scale``, ``classifier.kernel``), conv kernels stored
OIHW and the classifier kernel ``(in, out)``, so
``models/convert.py::resnet_params_from_jax`` is a rename and a transpose.

Two traps the port must not fall into:

- **SAME padding.** Flax ``nn.Conv`` pads ``SAME``: on an even input a 3x3
  conv with stride 2 pads 0 rows before and 1 after, not 1 and 1, so
  ``conv2d(padding=1)`` would shift every window of every stride-2 block.
  :func:`same_padding` computes flax's split and uneven pads go through
  ``F.pad``. The stem's (3, 3) and the max pool's (1, 1) are explicit and
  symmetric on both sides.
- **BatchNorm is flax's, not ``nn.BatchNorm2d``'s.** :class:`BatchNorm`
  takes the batch mean and the *biased* variance in f32 and updates the
  running statistics as ``0.9 * running + 0.1 * batch``; torch's module
  folds the unbiased variance into its running variance, which differs by
  N / (N - 1). Under a process group the statistics are over the global
  batch (the JAX BatchNorm's mean reduces across the devices the batch is
  sharded over): the sums and sums of squares are all-reduced in f32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

MOMENTUM = 0.9
EPSILON = 1e-5


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA ``SAME`` padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group, differentiable: the gradient of each
    rank's contribution is the sum of every rank's gradient of the total."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class Conv(nn.Module):
    """Bias-free conv over NCHW (channels_last) activations, flax ``SAME``
    padding unless ``padding`` is given; the f32 kernel is cast to the
    activations' dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int | None = None, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((cout, cin, kernel, kernel), device=device))
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        padding = self.padding
        if padding is None:
            k = self.kernel.shape[-1]
            (top, bottom), (left, right) = (same_padding(n, k, self.stride) for n in x.shape[2:])
            if top == bottom and left == right:
                padding = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
                padding = 0
        return F.conv2d(x, self.kernel.to(x.dtype), stride=self.stride, padding=padding)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5) over NCHW: batch
    statistics in train mode, running ones in eval mode; f32 scale and bias;
    output cast to ``dtype``. With a ``group`` of more than one rank the
    statistics are those of the group's whole batch."""

    def __init__(self, features: int, dtype, zero_scale: bool = False, group=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter((torch.zeros if zero_scale else torch.ones)(features, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.register_buffer("mean", torch.zeros(features, **kw))
        self.register_buffer("var", torch.ones(features, **kw))
        self.dtype = dtype
        self.group = group

    def forward(self, x):
        x32 = x.float()
        if self.training:
            C = x.shape[1]
            n = x.numel() // C
            stats = torch.cat([x32.sum(dim=(0, 2, 3)), x32.square().sum(dim=(0, 2, 3))])
            if self.group is not None and dist.get_world_size(self.group) > 1:
                # Every rank holds the same number of rows (the callers
                # split the global batch evenly).
                stats = _AllReduceSum.apply(stats, self.group)
                n *= dist.get_world_size(self.group)
            mean = stats[:C] / n
            var = torch.clamp(stats[C:] / n - mean.square(), min=0.0)
            with torch.no_grad():
                self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean)
                self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + EPSILON) * self.scale
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int, dtype, group=None, device=None):
        super().__init__()
        bn = dict(dtype=dtype, group=group, device=device)
        self.conv1 = Conv(cin, filters, 1, device=device)
        self.bn1 = BatchNorm(filters, **bn)
        self.conv2 = Conv(filters, filters, 3, stride=strides, device=device)
        self.bn2 = BatchNorm(filters, **bn)
        self.conv3 = Conv(filters, filters * 4, 1, device=device)
        self.bn3 = BatchNorm(filters * 4, zero_scale=True, **bn)
        # The JAX block projects the residual where its shape differs from
        # the output's: a channel change, or a stride.
        if cin != filters * 4 or strides != 1:
            self.proj = Conv(cin, filters * 4, 1, stride=strides, device=device)
            self.proj_bn = BatchNorm(filters * 4, **bn)
        else:
            self.proj = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``forward(images NHWC) -> logits f32 (B, num_classes)``; train mode
    (``model.train()``) uses and updates batch statistics, eval mode the
    running ones. ``group``: the process group the batch is split over."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 dtype=torch.bfloat16, group=None, device="cuda", seed: int | None = 0):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes = num_classes
        self.dtype = dtype
        self.stem_conv = Conv(3, 64, 7, stride=2, padding=3, device=device)
        self.stem_bn = BatchNorm(64, dtype, group=group, device=device)
        cin = 64
        self.block_names = []
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                filters = 64 * 2**stage
                self.add_module(name, BottleneckBlock(cin, filters, strides, dtype, group,
                                                      device))
                self.block_names.append(name)
                cin = filters * 4
        self.classifier = nn.Module()
        self.classifier.kernel = nn.Parameter(torch.empty((cin, num_classes), device=device))
        self.classifier.bias = nn.Parameter(torch.zeros(num_classes, device=device))
        if seed is not None:
            self.reset_parameters(seed)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Flax's initializers from ``seed``: lecun-normal conv and dense
        kernels (fan-in = kh * kw * cin, or in), zero biases, unit norm
        scales except the zero ``bn3`` scale, zero / unit running stats."""
        gen = torch.Generator(device=self.classifier.kernel.device).manual_seed(seed)
        for module in self.modules():
            if isinstance(module, Conv):
                lecun_normal_(module.kernel, module.kernel[0].numel(), gen)
        lecun_normal_(self.classifier.kernel, self.classifier.kernel.shape[0], gen)
        self.classifier.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.dtype)  # NHWC bytes, channels_last
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # The JAX mean reduces bf16 in f32 and rounds the result to bf16.
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return x.float() @ self.classifier.kernel + self.classifier.bias

    def flops_per_image(self, image_size: int) -> float:
        """Forward FLOPs of one image, 2 per multiply-add, counted from the
        conv and dense shapes (norms, activations and pools not counted)."""
        h = (image_size + 2 * 3 - 7) // 2 + 1  # the stem conv
        macs = h * h * 7 * 7 * 3 * 64
        h = (h + 2 - 3) // 2 + 1  # the max pool
        for name in self.block_names:
            block = getattr(self, name)
            out = -(-h // block.conv2.stride)  # SAME: ceil(h / stride)
            convs = [(block.conv1, h), (block.conv2, out), (block.conv3, out)]
            if block.proj is not None:
                convs.append((block.proj, out))
            for conv, size in convs:
                cout, cin, k, _ = conv.kernel.shape
                macs += size * size * k * k * cin * cout
            h = out
        return 2.0 * (macs + self.classifier.kernel.numel())


def ResNet50(num_classes: int = 1000, dtype=torch.bfloat16, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes, dtype=dtype, **kw)


def ResNetTiny(num_classes: int = 10, dtype=torch.bfloat16, **kw) -> ResNet:
    """Test config: the same code paths, two stages of one block."""
    return ResNet((1, 1), num_classes=num_classes, dtype=dtype, **kw)
