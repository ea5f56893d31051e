"""Attention modules of the multi-scale feature fusion, NHWC at their surface.

The JAX package's ``models/attention.py``.  State-dict names follow the
reference torch modules, so ``utils/torch_convert.py::convert_pixelnerf``
reads a port checkpoint: CBAM's channel gate is ``fc.0`` / ``fc.2`` (1 x 1
convolutions without bias, weights (O, I, 1, 1)), its spatial gate ``conv``
(7 x 7, no bias).  The two attention blocks over the H x W positions
(``MultiViewAttention``, ``CrossViewAttention``) keep the JAX names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dense_1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1 x 1 convolution applied as a product over the channels of NHWC ``x``."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


def nchw(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW module (a convolution, a BatchNorm) on NHWC ``x``, through its
    NCHW view -> NHWC."""
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MultiViewAttention(nn.Module):
    """Multi-head self-attention over the H*W positions of a feature map,
    with a residual and LayerNorm."""

    def __init__(self, channels: int, num_heads: int = 8):
        super().__init__()
        if channels % num_heads:
            raise ValueError("channels must divide num_heads")
        self.num_heads = num_heads
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj = nn.Linear(channels, channels)
        self.norm = nn.LayerNorm(channels, eps=1e-6)  # flax's epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:param x: (B, H, W, C)"""
        B, H, W, C = x.shape
        hd = C // self.num_heads
        q, k, v = (m(x).reshape(B, H * W, self.num_heads, hd)
                   for m in (self.query, self.key, self.value))
        attn = torch.softmax(torch.einsum("bihd,bjhd->bhij", q, k) / hd**0.5, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(B, H, W, C)
        return self.norm(self.proj(out) + x)


class CrossViewAttention(nn.Module):
    """Target-view queries over reference-view keys and values; a learned
    gamma, zero at init, gates the residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.query_conv = nn.Linear(channels, channels // 8)
        self.key_conv = nn.Linear(channels, channels // 8)
        self.value_conv = nn.Linear(channels, channels)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, target_feat: torch.Tensor, ref_feat: torch.Tensor) -> torch.Tensor:
        B, H, W, C = target_feat.shape
        q = self.query_conv(target_feat).reshape(B, H * W, -1)
        k = self.key_conv(ref_feat).reshape(B, H * W, -1)
        v = self.value_conv(ref_feat).reshape(B, H * W, C)
        attn = torch.softmax(torch.einsum("bik,bjk->bij", q, k), dim=-1)
        out = torch.einsum("bij,bjc->bic", attn, v).reshape(B, H, W, C)
        return self.gamma * out + target_feat


class SpatialAttention(nn.Module):
    """A k x k convolution over the channelwise [max, mean] -> sigmoid gate."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.cat([x.amax(dim=-1, keepdim=True), x.mean(dim=-1, keepdim=True)], dim=-1)
        return x * torch.sigmoid(nchw(self.conv, pooled))


class ChannelAttention(nn.Module):
    """An SE-style channel gate: global mean and max pooling through a shared
    bottleneck (no bias), summed, sigmoid."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc = nn.Sequential(nn.Conv2d(channels, hidden, 1, bias=False), nn.ReLU(),
                                nn.Conv2d(hidden, channels, 1, bias=False))

    def _mlp(self, v: torch.Tensor) -> torch.Tensor:
        return dense_1x1(self.fc[2], F.relu(dense_1x1(self.fc[0], v)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self._mlp(x.mean(dim=(1, 2))) + self._mlp(x.amax(dim=(1, 2))))
        return x * gate[:, None, None, :]


class CBAM(nn.Module):
    """Channel, then spatial attention."""

    def __init__(self, channels: int, reduction: int = 16, kernel_size: int = 7):
        super().__init__()
        self.channel_attn = ChannelAttention(channels, reduction)
        self.spatial_attn = SpatialAttention(kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial_attn(self.channel_attn(x))
