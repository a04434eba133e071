"""ResNet for the ImageNet example (counterpart of
``apex_tpu/models/resnet.py``), with flax's module names, so that a
parameter's dotted name is its flax path: ``conv_init``, ``bn_init``,
``stage{i}_block{j}`` (``conv1``-``conv3``, ``bn1``-``bn3``,
``downsample_conv``, ``downsample_bn``), ``fc``.

Layout: the model takes NCHW images and keeps its activations in
``torch.channels_last`` memory, which is JAX's NHWC; the batch norms
(:class:`~apex_tpu_torch.parallel.SyncBatchNorm`, K17/K18 on the card)
read them as ``[N H W, C]`` rows. Convolution weights are OIHW (flax's
HWIO transposed by ``serving/weights.resnet_from_jax``), the ``fc``
weight ``[out, in]``.

Numerics, as flax computes them: a convolution with ``dtype`` casts its
input and its weight to ``dtype`` (under amp O1 the parameters are fp32
and the convolutions bf16); padding ``k // 2`` on each side, max pool
3x3 / 2 over -inf padding; batch norm over each channel with momentum 0.1
and eps 1e-5, its output in the activation's dtype, the ReLU after
``bn_init``, ``bn1`` and ``bn2`` fused into it (the same values: ReLU
commutes with the rounding); the mean over H and W accumulated in fp32
and returned in the activation's dtype; ``fc`` computed in fp32
(``nn.Dense(dtype=float32)``) from weights that amp O2 has rounded to
bf16. Initialization is flax's distributions from a seeded generator:
variance scaling 2.0 over ``fan_out``, truncated normal, for the
convolutions; LeCun's truncated normal and zeros for ``fc``. The weights
are drawn on the CPU and moved to ``device``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import default_device
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

# flax's truncated_normal stddev correction for the [-2, 2] cut
_TRUNC = 0.87962566103423978


def _trunc_normal(shape, variance, generator):
    std = math.sqrt(variance) / _TRUNC
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return t


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias, square kernel, padding ``k // 2``."""

    def __init__(self, cin, cout, kernel, stride, dtype, device, generator):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, kernel // 2, dtype
        self.weight = nn.Parameter(_trunc_normal(
            (cout, cin, kernel, kernel), 2.0 / (kernel * kernel * cout),
            generator).to(device))

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=float32)``: inputs and parameters in fp32."""

    def __init__(self, cin, cout, device, generator):
        super().__init__()
        self.weight = nn.Parameter(_trunc_normal((cout, cin), 1.0 / cin,
                                                 generator).to(device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        return F.linear(x.float(), self.weight.float(), self.bias.float())


def _norm(features, group, device, fuse_relu=False):
    return SyncBatchNorm(features, momentum=0.1, process_group=group,
                         channel_last=False, fuse_relu=fuse_relu,
                         device=device)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin, features, stride, group, dtype, device,
                 generator):
        super().__init__()
        out = features * self.expansion

        def conv(i, o, k, s):
            return Conv(i, o, k, s, dtype, device, generator)

        self.conv1 = conv(cin, features, 1, 1)
        self.bn1 = _norm(features, group, device, fuse_relu=True)
        self.conv2 = conv(features, features, 3, stride)
        self.bn2 = _norm(features, group, device, fuse_relu=True)
        self.conv3 = conv(features, out, 1, 1)
        self.bn3 = _norm(out, group, device)
        self.downsample = stride != 1 or cin != out
        if self.downsample:
            self.downsample_conv = conv(cin, out, 1, stride)
            self.downsample_bn = _norm(out, group, device)

    def forward(self, x, train=True):
        ura = not train
        y = self.bn1(self.conv1(x), ura)
        y = self.bn2(self.conv2(y), ura)
        y = self.bn3(self.conv3(y), ura)
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x), ura)
        return torch.relu(y + residual)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, features, stride, group, dtype, device,
                 generator):
        super().__init__()

        def conv(i, o, k, s):
            return Conv(i, o, k, s, dtype, device, generator)

        self.conv1 = conv(cin, features, 3, stride)
        self.bn1 = _norm(features, group, device, fuse_relu=True)
        self.conv2 = conv(features, features, 3, 1)
        self.bn2 = _norm(features, group, device)
        self.downsample = stride != 1 or cin != features
        if self.downsample:
            self.downsample_conv = conv(cin, features, 1, stride)
            self.downsample_bn = _norm(features, group, device)

    def forward(self, x, train=True):
        ura = not train
        y = self.bn1(self.conv1(x), ura)
        y = self.bn2(self.conv2(y), ura)
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x), ura)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """NCHW ResNet, activations in channels_last memory; ``norm_process_
    group`` is the group its batch norms sync over (None: local), JAX's
    ``norm_axis_name``; ``dtype`` the convolutions' compute dtype."""

    def __init__(self, stage_sizes, block_cls=BottleneckBlock,
                 num_classes=1000, num_filters=64, norm_process_group=None,
                 dtype=torch.float32, device=None, seed=0):
        super().__init__()
        device = default_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, dtype, device, gen)
        self.bn_init = _norm(num_filters, norm_process_group, device,
                             fuse_relu=True)
        cin = num_filters
        self.blocks = []
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(cin, num_filters * 2 ** i, stride,
                                  norm_process_group, dtype, device, gen)
                setattr(self, f"stage{i}_block{j}", block)
                self.blocks.append(f"stage{i}_block{j}")
                cin = num_filters * 2 ** i * block_cls.expansion
        self.fc = Dense(cin, num_classes, device, gen)

    def forward(self, x, train=True):
        """Logits (fp32) of NCHW images ``x``; ``train`` normalizes with
        batch statistics and updates the running stats, else uses them."""
        y = self.conv_init(x.contiguous(memory_format=torch.channels_last))
        y = self.bn_init(y, not train)
        y = F.max_pool2d(y, 3, 2, 1)
        for name in self.blocks:
            y = getattr(self, name)(y, train)
        y = torch.mean(y, dim=(2, 3), dtype=torch.float32).to(y.dtype)
        return self.fc(y)


def resnet50(num_classes=1000, norm_process_group=None, dtype=torch.float32,
             device=None, seed=0, num_filters=64):
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes, num_filters,
                  norm_process_group, dtype, device, seed)


def resnet18(num_classes=1000, norm_process_group=None, dtype=torch.float32,
             device=None, seed=0, num_filters=64):
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes, num_filters,
                  norm_process_group, dtype, device, seed)


def conv_linear_flops(model, image_size):
    """Forward FLOPs (2 x multiply-adds) of one image through the model's
    convolutions and ``fc``, from their shapes (the MFU numerator; batch
    norm, pooling and adds are not counted): 8.18 GFLOP for ResNet-50 at
    224^2."""
    def conv(m, h):
        o, i, k, _ = m.weight.shape
        h = (h + 2 * m.padding - k) // m.stride + 1
        return 2 * o * i * k * k * h * h, h

    flops, h = conv(model.conv_init, image_size)
    h = (h + 2 - 3) // 2 + 1                     # the max pool
    for name in model.blocks:
        block = getattr(model, name)
        h_in = h
        for c in ("conv1", "conv2", "conv3"):
            if hasattr(block, c):
                f, h = conv(getattr(block, c), h)
                flops += f
        if block.downsample:
            flops += conv(block.downsample_conv, h_in)[0]
    return flops + 2 * model.fc.weight.numel()
