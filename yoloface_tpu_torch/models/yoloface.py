"""The float32 yoloface model as a torch ``nn.Module``: the trainable twin
of the int8 graph.

The counterpart of ``yoloface_tpu.models.yoloface``: a 56x56x3 -> 7x7x18
single-class YOLO backbone of depthwise-separable convolutions, two
maxpool-route branches and three residual adds; 10,214 trainable
parameters and 1,088 BatchNorm statistics.  Its arithmetic is Flax's:

  * the forward takes and returns NHWC (``[N,56,56,3]`` -> ``[N,7,7,18]``),
    as the JAX model does, so the loss and calibration keep JAX's layout;
    inside, the convolutions run NCHW;
  * the stride-2 convolutions take a top/left zero pad of one row and one
    column, then no padding (darknet's PAD ops of the int8 graph), never
    ``padding=1``; the others are SAME;
  * the SAME max-pools pad with -inf (8x8 at stride 2 on 28x28, 4x4 on
    14x14), as ``lax.reduce_window`` does;
  * BatchNorm is Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: in
    training the batch variance is the biased ``E[x^2] - E[x]^2`` (at least
    0), and the running statistics move by ``0.9 * old + 0.1 * batch``
    with that biased variance (``nn.BatchNorm2d`` would take the unbiased
    one); the normalisation is ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``;
  * the head ``conv17`` is conv + BN with no activation;
  * conv kernels start from Flax's ``lecun_normal`` (a normal truncated at
    two standard deviations, variance 1 / fan_in), BN scale 1 and bias 0,
    drawn from an explicit ``torch.Generator``.

``models/convert.py`` carries weights between this module's state dict and
the JAX model's variables.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yoloface_tpu_torch.ops.int8_ref import _same_pad_amounts

DARKNET_PAD = ((1, 0), (1, 0))  # top/left zero pad for stride-2 3x3 convs
# jax.nn.initializers.truncated_normal's correction: the standard deviation
# of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """Flax's BatchNorm over the channels of an NCHW tensor.

    ``sync`` (None, or a callable summing a tensor over the ranks of a
    data-parallel mesh with an autograd-aware all-reduce) makes training
    take the statistics of the global batch, as JAX's one jit over the
    mesh does: the per-channel sums of x and x^2 and the element count are
    summed over the ranks, then the biased ``E[x^2] - E[x]^2``."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.sync = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _batch_stats(self, x: torch.Tensor):
        if self.sync is None:
            mean = x.mean((0, 2, 3))
            return mean, (x * x).mean((0, 2, 3))
        c = x.shape[1]
        n = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
        s = self.sync(torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)),
                                 n]))
        return s[:c] / s[2 * c], s[c:2 * c] / s[2 * c]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, ex2 = self._batch_stats(x)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class ConvBNLeaky(nn.Module):
    """conv (no bias) + BN + optional LeakyReLU(0.1); JAX's ``ConvBNLeaky``."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, relu: bool = True,
                 darknet_pad: bool = False):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.relu, self.darknet_pad = relu, darknet_pad
        self.conv = nn.Conv2d(in_channels, features, kernel, stride,
                              groups=groups, bias=False)
        self.bn = BatchNorm(features)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        if self.darknet_pad:
            (top, bottom), (left, right) = DARKNET_PAD
        else:           # SAME, as lax.padtype_to_pads gives it
            top, bottom = _same_pad_amounts(x.shape[2], self.stride,
                                            self.kernel)
            left, right = _same_pad_amounts(x.shape[3], self.stride,
                                            self.kernel)
        if top == bottom and left == right:
            return x, (top, left)
        return F.pad(x, (left, right, top, bottom)), (0, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = self._pad(x)
        x = F.conv2d(x, self.conv.weight, None, self.stride, padding, 1,
                     self.conv.groups)
        x = self.bn(x)
        return F.leaky_relu(x, 0.1) if self.relu else x


class DepthwiseSeparable(nn.Module):
    """3x3 depthwise (+leaky) then 1x1 pointwise (leaky only if ``relu``)."""

    def __init__(self, hidden: int, features: int, stride1: int = 1,
                 relu: bool = False):
        super().__init__()
        self.dw = ConvBNLeaky(hidden, hidden, kernel=3, stride=stride1,
                              groups=hidden, relu=True,
                              darknet_pad=stride1 == 2)
        self.pw = ConvBNLeaky(hidden, features, kernel=1, relu=relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


def _max_pool_same(x: torch.Tensor, window: int, stride: int):
    """``nn.max_pool(padding="SAME")``: -inf pads, then the windows."""
    top, bottom = _same_pad_amounts(x.shape[2], stride, window)
    left, right = _same_pad_amounts(x.shape[3], stride, window)
    x = F.pad(x, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(x, window, stride)


class YoloFace(nn.Module):
    """The detector backbone; NHWC float ``[N,56,56,3]`` in, the raw head
    ``[N,7,7,18]`` (3 anchors x [tx ty tw th conf cls]) out."""

    anchors: Tuple[Tuple[float, float], ...] = ((9, 14), (12, 17), (22, 21))

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = ConvBNLeaky(3, 8, kernel=3, stride=2, darknet_pad=True)
        self.conv2 = DepthwiseSeparable(8, 4)
        self.conv3 = ConvBNLeaky(4, 18, kernel=1)
        self.conv4 = DepthwiseSeparable(18, 6, stride1=2)
        self.conv5 = ConvBNLeaky(6, 36, kernel=1)
        self.conv6 = DepthwiseSeparable(36, 6)
        self.conv7 = ConvBNLeaky(6, 18, kernel=1)
        self.conv8 = ConvBNLeaky(36, 24, kernel=1)
        self.conv9 = DepthwiseSeparable(24, 8, stride1=2)
        self.conv10 = ConvBNLeaky(8, 40, kernel=1)
        self.conv11 = DepthwiseSeparable(40, 8)
        self.conv12 = ConvBNLeaky(8, 40, kernel=1)
        self.conv13 = DepthwiseSeparable(40, 8)
        self.conv14 = ConvBNLeaky(8, 24, kernel=1)
        self.conv15 = ConvBNLeaky(48, 40, kernel=1)
        self.conv16 = DepthwiseSeparable(40, 32, relu=True)
        self.conv17 = ConvBNLeaky(32, 18, kernel=1, relu=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initial values: ``lecun_normal`` kernels, BN identity.
        Without a generator, one seeded with 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.weight.copy_(w)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        conv1 = self.conv1(x)
        conv2 = self.conv2(conv1)
        conv3 = self.conv3(conv2)

        conv4 = self.conv4(conv3)
        conv5 = self.conv5(conv4)
        conv6 = conv4 + self.conv6(conv5)                 # residual add
        conv7 = self.conv7(conv6)

        route1 = torch.cat([_max_pool_same(conv3, 8, 2), conv7], 1)
        conv8 = self.conv8(route1)

        conv9 = self.conv9(conv8)
        conv10 = self.conv10(conv9)
        conv11 = conv9 + self.conv11(conv10)              # residual add

        conv12 = self.conv12(conv11)
        conv13 = conv11 + self.conv13(conv12)             # residual add
        conv14 = self.conv14(conv13)

        route2 = torch.cat([_max_pool_same(conv8, 4, 2), conv14], 1)
        conv15 = self.conv15(route2)
        conv16 = self.conv16(conv15)
        return self.conv17(conv16).permute(0, 2, 3, 1)


def count_params(tree) -> int:
    """Elements of a module's parameters, or of every tensor or array in a
    (nested) dict such as ``dict(model.named_buffers())``."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel() if isinstance(tree, torch.Tensor) else tree.size)
