"""LPIPS, the VGG16 perceptual distance, as the JAX package's
``eval/lpips.py`` computes it, on the card.

The inputs, (B, H, W, 3) in [-1, 1], are shifted and scaled as the ``lpips``
package does; VGG16's features are tapped after the last relu of each of its
five blocks (relu1_2 ... relu5_3), unit-normalized over channels at each
location (with 1e-10 in the denominator), squared-differenced, weighted by
a 1 x 1 head ``lin{i}`` with no bias, averaged over the locations and summed
over the five taps: one distance an image pair.

The weights are a state dict of the ``lpips`` package's ``LPIPS(net="vgg")``,
read as it is: the convolutions under ``net.slice{k}.{idx}`` or torchvision's
``features.{idx}``, the heads under ``lin{i}.model.{j}`` or
``lins.{i}.model.{j}``.  :func:`lpips_fn` reads them from its argument or
``$LPIPS_WEIGHTS``; nothing is downloaded, and without a file it raises
``FileNotFoundError``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16's (filters, convolutions) a block; a 2 x 2 max pool between blocks
VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# the lpips package's input shift and scale of [-1, 1] images
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def _conv_positions():
    """torchvision ``features`` index of each of the 13 convolutions (each
    is followed by its relu; each block by a pool)."""
    pos, idx = [], 0
    for _, n_convs in VGG_BLOCKS:
        for _ in range(n_convs):
            pos.append(idx)
            idx += 2
        idx += 1
    return pos


CONV_POSITIONS = _conv_positions()


class LPIPS(nn.Module):
    """(pred, target) (B, H, W, 3) in [-1, 1] -> (B,) distances."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)
        convs, c_in = [], 3
        for filters, n_convs in VGG_BLOCKS:
            for _ in range(n_convs):
                convs.append(nn.Conv2d(c_in, filters, 3, padding=1))
                c_in = filters
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ModuleList(nn.Conv2d(f, 1, 1, bias=False) for f, _ in VGG_BLOCKS)

    def features(self, x: torch.Tensor):
        taps, k = [], 0
        for block, (_, n_convs) in enumerate(VGG_BLOCKS):
            for _ in range(n_convs):
                x = F.relu(self.convs[k](x))
                k += 1
            taps.append(x)
            if block < len(VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        B = pred.shape[0]
        x = torch.cat([pred, target]).permute(0, 3, 1, 2)
        total = 0.0
        for lin, f in zip(self.lins, self.features((x - self.shift) / self.scale)):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            total = total + lin((f[:B] - f[B:]) ** 2).mean(dim=(1, 2, 3))
        return total


def load_lpips_state(model: LPIPS, state: dict) -> LPIPS:
    """Load an ``lpips``-package state dict (either key form of each part;
    other keys are ignored) into ``model``; raises on a missing weight."""
    conv_of = {pos: n for n, pos in enumerate(CONV_POSITIONS)}
    mapped = {}
    for k, v in state.items():
        m = (re.match(r"^(?:net\.)?features\.(\d+)\.(weight|bias)$", k)
             or re.match(r"^net\.slice\d\.(\d+)\.(weight|bias)$", k))
        if m and int(m.group(1)) in conv_of:
            mapped[f"convs.{conv_of[int(m.group(1))]}.{m.group(2)}"] = v
            continue
        m = re.match(r"^lins?\.?(\d)\.model\.\d+\.weight$", k)
        if m:
            mapped[f"lins.{m.group(1)}.weight"] = v
    model.load_state_dict(mapped, strict=True)
    return model


_CACHE: dict = {}


def lpips_fn(weights_path: Optional[str] = None, device=None):
    """A function (pred, target) -> (B,) float32 numpy LPIPS distances of
    (B, H, W, 3) images in [-1, 1], with the weights of ``weights_path`` or
    ``$LPIPS_WEIGHTS``, on ``device`` (the card when None).  Raises
    ``FileNotFoundError`` when neither names a file.  Cached by the resolved
    path and the device."""
    from ..device import resolve_device

    path = weights_path or os.environ.get("LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "LPIPS weights not available; set LPIPS_WEIGHTS to a torch lpips VGG checkpoint "
            "to enable perceptual metrics")
    device = resolve_device(device)
    key = (os.path.realpath(path), str(device))
    if key not in _CACHE:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        model = load_lpips_state(LPIPS(), obj).to(device).eval()

        @torch.no_grad()
        def fn(pred, target) -> np.ndarray:
            p = torch.as_tensor(np.asarray(pred, np.float32), device=device)
            t = torch.as_tensor(np.asarray(target, np.float32), device=device)
            return model(p, t).cpu().numpy()

        fn.model = model
        _CACHE[key] = fn
    return _CACHE[key]


def seeded_state(seed: int, features_keys: bool = False) -> dict:
    """A seeded state dict in the ``lpips`` package's layout (He-scaled
    convolutions, small biases, non-negative heads), for runs with no
    released weights: ``net.slice{k}.{idx}`` and ``lin{i}.model.1`` keys, or
    ``features.{idx}`` and ``lins.{i}.model.1`` with ``features_keys``."""
    g = torch.Generator().manual_seed(seed)
    bounds = (4, 9, 16, 23, 30)  # the lpips package's slices of torchvision's features
    state, c_in, n = {}, 3, 0
    for filters, n_convs in VGG_BLOCKS:
        for _ in range(n_convs):
            pos = CONV_POSITIONS[n]
            key = (f"features.{pos}" if features_keys else
                   f"net.slice{1 + sum(pos >= b for b in bounds)}.{pos}")
            state[key + ".weight"] = (torch.randn(filters, c_in, 3, 3, generator=g)
                                      * (2.0 / (9 * c_in)) ** 0.5)
            state[key + ".bias"] = 0.01 * torch.randn(filters, generator=g)
            c_in, n = filters, n + 1
    for i, (filters, _) in enumerate(VGG_BLOCKS):
        key = f"lins.{i}" if features_keys else f"lin{i}"
        state[key + ".model.1.weight"] = torch.rand(1, filters, 1, 1, generator=g)
    return state
