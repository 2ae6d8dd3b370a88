"""Layers and seeded initialisers shared by the backbone, neck and head."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` from N(0, std^2), drawn on the CPU from ``generator`` so the
    values do not depend on the device the module lives on."""
    t.copy_(torch.randn(t.shape, generator=generator) * std)


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    """Fill ``t`` from U(-bound, bound), drawn on the CPU from ``generator``."""
    t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` from N(0, std^2) truncated at +-2 std, drawn on the CPU
    from ``generator``."""
    t.copy_(nn.init.trunc_normal_(torch.empty(t.shape), 0.0, std, -2 * std, 2 * std, generator=generator))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in its input's dtype.

    Parameters stay float32; the weight (and bias) are cast to the
    activation dtype per call, so a bf16 input runs a bf16 convolution, as
    the JAX package's ``nn.Conv(dtype=compute_dtype, param_dtype=float32)``.
    """

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding, self.dilation, self.groups
        )


class ConvModule(nn.Module):
    """A bare conv under a ``.conv`` submodule: mmcv's ConvModule with no norm
    and no activation, which fixes the mmdet state-dict names of the FPN
    (``neck.lateral_convs.0.conv.weight``)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding)

    def forward(self, x):
        return self.conv(x)
