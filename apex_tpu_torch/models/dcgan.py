"""DCGAN generator and discriminator (counterpart of
``apex_tpu/models/dcgan.py``: the amp multi-model / multi-loss example's
models, BASELINE config 5).

Layout: both models take and return JAX's NHWC tensors (``z`` ``[B, 1, 1,
nz]``, images ``[B, isize, isize, nc]``); inside, an activation is the
NCHW view of that memory, which is ``torch.channels_last``, and each
batch norm reads it as ``[N H W, C]`` rows with no copy. Parameter names
join to flax's paths (``up1``-``up5``, ``bn1``-``bn4`` in G;
``down1``-``down4``, ``bn2``-``bn4``, ``out`` in D), so that amp's cast
plan is JAX's; convolution weights are PyTorch's (``[out, in, kh, kw]``,
and ``[in, out, kh, kw]`` for a transposed one), batch norms' ``weight``
and ``bias`` are flax's ``scale`` and ``bias``, their buffers
``running_mean`` / ``running_var`` flax's ``mean`` / ``var``
(``serving/weights.load_dcgan_from_jax`` carries a flax tree over).

Numerics, as flax computes them with ``dtype=float32``: every
convolution casts its input and weight to fp32 (under amp O2 the weights
are bf16 and the arithmetic fp32); G's transposed convolutions are
PyTorch's ``conv_transpose2d`` with padding 0 at stride 1 (flax's
"VALID") and 1 at stride 2 (flax's "SAME" at k = 4), D's convolutions
padding 1 at stride 2 and 0 for ``out``; batch norm is flax's
``nn.BatchNorm`` (eps 1e-5, momentum 0.99, the running variance biased)
through ``ops/batch_norm.batch_norm_rows(..., flax_running=True)``: K17
and K18 on the card, G's ReLU fused into it (the same values); D's leaky
ReLU (0.2) and G's tanh are PyTorch's. ``train=False`` normalizes with the
running stats; ``update_stats=False`` normalizes with the batch's and
leaves the running stats as they are (JAX's ``mutable`` stats thrown
away). Initialization is flax's distributions from a seeded generator:
LeCun's truncated normal for every kernel (fan in: ``kh kw in``), scale 1
and bias 0 for the norms. The weights are drawn on the CPU and moved to
``device``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import default_device
from apex_tpu_torch.ops import batch_norm

# flax's truncated_normal stddev correction for the [-2, 2] cut
_TRUNC = 0.87962566103423978
FLAX_MOMENTUM = 0.99
FLAX_EPS = 1e-5


def _lecun(shape, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return t


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of an NCHW activation in
    channels_last memory (fp32 scale, bias and running stats)."""

    def __init__(self, features, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x, train=True, update_stats=True, fuse_relu=False):
        rows = x.permute(0, 2, 3, 1)
        if not rows.is_contiguous():
            if x.is_cuda:
                raise ValueError(
                    f"DCGAN batch norm reads channels_last activations; got "
                    f"{tuple(x.shape)} with strides {x.stride()}")
            rows = rows.contiguous()
        keep = train and not update_stats
        y = batch_norm.batch_norm_rows(
            rows.reshape(-1, x.shape[1]), self.weight, self.bias,
            None if keep else self.running_mean,
            None if keep else self.running_var, FLAX_EPS, FLAX_MOMENTUM,
            train, fuse_relu, flax_running=True)
        return y.view(rows.shape).permute(0, 3, 1, 2)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` (k = 4, no bias, fp32 arithmetic)."""

    def __init__(self, cin, cout, stride, device, generator):
        super().__init__()
        self.stride, self.padding = stride, 0 if stride == 1 else 1
        self.weight = nn.Parameter(_lecun((cin, cout, 4, 4), 16 * cin,
                                          generator).to(device))

    def forward(self, x):
        return F.conv_transpose2d(x.float(), self.weight.float(),
                                  stride=self.stride, padding=self.padding)


class Conv(nn.Module):
    """flax ``nn.Conv`` (k = 4, no bias, fp32 arithmetic)."""

    def __init__(self, cin, cout, stride, padding, device, generator):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(_lecun((cout, cin, 4, 4), 16 * cin,
                                          generator).to(device))

    def forward(self, x):
        return F.conv2d(x.float(), self.weight.float(), stride=self.stride,
                        padding=self.padding)


def _generator(seed):
    return torch.Generator().manual_seed(int(seed))


class Generator(nn.Module):
    """z ``[B, 1, 1, nz]`` -> image ``[B, isize, isize, nc]`` (NHWC), 4x4
    then four 2x upsamplings: isize 64."""

    def __init__(self, nz=100, ngf=64, nc=3, device=None, seed=0):
        super().__init__()
        device = default_device(device)
        g = _generator(seed)
        feats = (nz, ngf * 8, ngf * 4, ngf * 2, ngf, nc)
        for i in range(5):
            setattr(self, f"up{i + 1}", ConvTranspose(
                feats[i], feats[i + 1], 1 if i == 0 else 2, device, g))
        for i in range(4):
            setattr(self, f"bn{i + 1}", BatchNorm(feats[i + 1], device))

    def forward(self, z, train=True, update_stats=True):
        y = z.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for i in range(1, 5):
            y = getattr(self, f"bn{i}")(getattr(self, f"up{i}")(y), train,
                                        update_stats, fuse_relu=True)
        return torch.tanh(self.up5(y)).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """image ``[B, isize, isize, nc]`` (NHWC) -> logit ``[B]``."""

    def __init__(self, ndf=64, nc=3, device=None, seed=0):
        super().__init__()
        device = default_device(device)
        g = _generator(seed)
        feats = (nc, ndf, ndf * 2, ndf * 4, ndf * 8)
        for i in range(4):
            setattr(self, f"down{i + 1}", Conv(feats[i], feats[i + 1], 2, 1,
                                               device, g))
        for i in range(2, 5):
            setattr(self, f"bn{i}", BatchNorm(feats[i], device))
        self.out = Conv(feats[4], 1, 1, 0, device, g)

    def forward(self, x, train=True, update_stats=True):
        y = F.leaky_relu(self.down1(x.permute(0, 3, 1, 2)), 0.2)
        for i in range(2, 5):
            y = getattr(self, f"bn{i}")(getattr(self, f"down{i}")(y), train,
                                        update_stats)
            y = F.leaky_relu(y, 0.2)
        return self.out(y).reshape(x.shape[0])
