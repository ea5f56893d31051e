"""ResNet 18/34/50 trunks in plain PyTorch (no torchvision), NCHW inside.

Module names follow torchvision (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0/1``), so a torchvision state dict loads as it is and
``pixelnerf_tpu.utils.torch_convert.convert_resnet`` maps a state dict of this
module onto the JAX ``ResNetFeatures``.  Convolutions pad symmetrically by
``k // 2``; BatchNorm uses eps 1e-5 and, in eval mode, its running statistics; in train
mode it updates them as flax does (:class:`BatchNorm2d`).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _conv(cin: int, cout: int, k: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm as flax runs it: in train mode the batch is normalized with
    its biased variance (as torch does), and the running variance is updated
    with that same biased variance (torch's own layer takes the unbiased one).
    Momentum 0.1 here is flax's 0.9."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y


def _bn(c: int) -> nn.BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (resnet18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3, 1)
        self.bn2 = _bn(filters)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride), _bn(filters))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(y + x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) bottleneck block (resnet50)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        out_ch = filters * self.expansion
        self.conv1 = _conv(cin, filters, 1, 1)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = _bn(filters)
        self.conv3 = _conv(filters, out_ch, 1, 1)
        self.bn3 = _bn(out_ch)
        self.downsample = None
        if stride != 1 or cin != out_ch:
            self.downsample = nn.Sequential(_conv(cin, out_ch, 1, stride), _bn(out_ch))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(y + x)


_STAGE_SPECS = {
    # name -> (block, blocks-per-stage, per-stage latent channels incl. stem)
    "resnet18": (BasicBlock, (2, 2, 2, 2), (64, 64, 128, 256, 512)),
    "resnet34": (BasicBlock, (3, 4, 6, 3), (64, 64, 128, 256, 512)),
    "resnet50": (Bottleneck, (3, 4, 6, 3), (64, 256, 512, 1024, 2048)),
}


def stage_channels(backbone: str) -> Sequence[int]:
    """Per-stage output channels [stem, layer1..layer4]."""
    return _STAGE_SPECS[backbone][2]


def max_pool_torch(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=3, stride=2, padding=1) on NCHW input."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


class ResNetFeatures(nn.Module):
    """ResNet truncated to ``num_layers`` stages, one feature map per stage.
    Stage 0 is conv1+bn1+relu (optionally + maxpool); stages 1..4 are the
    residual layers."""

    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 use_first_pool: bool = True):
        super().__init__()
        block_cls, stage_blocks, _ = _STAGE_SPECS[backbone]
        self.num_layers = num_layers
        self.use_first_pool = use_first_pool
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _bn(64)
        cin = 64
        for stage in range(1, num_layers):
            width = (64, 128, 256, 512)[stage - 1]
            blocks = []
            for b in range(stage_blocks[stage - 1]):
                stride = 2 if (stage > 1 and b == 0) else 1
                blocks.append(block_cls(cin, width, stride))
                cin = width * block_cls.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """:param x: (B, 3, H, W) -> list of (B, C_i, H_i, W_i)"""
        x = F.relu(self.bn1(self.conv1(x)))
        if self.use_first_pool:
            x = max_pool_torch(x)
        feats = [x]
        for stage in range(1, self.num_layers):
            x = getattr(self, f"layer{stage}")(x)
            feats.append(x)
        return feats
