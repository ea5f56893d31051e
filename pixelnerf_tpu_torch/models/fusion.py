"""Multi-scale feature fusion, NHWC at the surface: the JAX package's
``models/fusion.py``.

* :class:`SmartFeatureFusion`: a 1 x 1 projection of each scale to
  ``output_dim // n`` (+ BatchNorm, ReLU, dropout), a bilinear upsample to the
  finest map, a channel softmax times a 7 x 7 spatial softmax over the
  scales, a 3 x 3 fusion convolution (+ BatchNorm, ReLU, dropout), CBAM and a
  1 x 1 enhancement.  State-dict names are the reference torch module's
  (``projections.<i>.{0,1}``, ``channel_attention.1``, ``spatial_attention.0``,
  ``fusion.{0,1}``, ``cbam.*``, ``enhancement.0``; 1 x 1 weights (O, I, 1, 1)),
  so ``utils/torch_convert.py::convert_pixelnerf`` reads a port checkpoint.
  The convolutions run on NCHW views of the NHWC maps (channels-last memory).
* :class:`AdaptiveFeatureSampler`: per-scale quality scores; ``forward``
  soft-gates each scale by ``quality * (quality >= threshold)`` (the best
  scale always kept, renormalized), :meth:`~AdaptiveFeatureSampler.select`
  is the reference's host-side hard selection.  Its layers are
  ``quality_fc1.<i>`` / ``quality_fc2.<i>`` (the JAX ``quality_fc{1,2}_<i>``).
* :class:`MultiScaleFusionModule`: 1 x 1 unification (``unify.<i>``), an
  antialiased resize to the coarsest map and a softmax-weighted sum.

Every BatchNorm runs as flax's (:class:`.resnet.BatchNorm2d`).  Dropout in
train mode draws its masks from the ``torch.Generator`` the caller passes,
never from the global generator.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grid_sample import resize_bilinear
from .attention import CBAM, dense_1x1, nchw
from .resnet import BatchNorm2d


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator], shard=None) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep with probability 1 - rate and scale the
    kept values by 1 / (1 - rate); the identity outside training.

    :param shard: a data-parallel rank's share of the batch
        (``parallel.mesh.DataShard``): the mask is drawn for the whole batch
        and this rank keeps its rows, so the draws are one device's"""
    if not training or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit torch.Generator: "
                         "pass generator=")
    if shard is not None and shard.count > 1:
        n = x.shape[0]
        u = torch.rand((n * shard.count,) + tuple(x.shape[1:]), generator=generator,
                       device=x.device)[shard.index * n:(shard.index + 1) * n]
    else:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)  # flax's momentum 0.9


class SmartFeatureFusion(nn.Module):
    """:param layer_dims: channels of each scale, finest first
    :param num_heads: taken and unused, as in the JAX module"""

    data_shard = None  # a data-parallel rank's share (``dropout``'s ``shard``)

    def __init__(self, layer_dims: Sequence[int], output_dim: int = 512,
                 use_attention: bool = True, dropout: float = 0.0, num_heads: int = 8,
                 use_cbam: bool = True):
        super().__init__()
        n = len(layer_dims)
        proj_dim = output_dim // n
        cat = n * proj_dim
        self.dropout, self.use_attention, self.use_cbam = dropout, use_attention, use_cbam
        self.projections = nn.ModuleList(
            nn.Sequential(nn.Conv2d(d, proj_dim, 1), _bn(proj_dim)) for d in layer_dims)
        if use_attention:
            self.channel_attention = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(cat, n, 1))
            self.spatial_attention = nn.Sequential(nn.Conv2d(cat, n, 7, padding=3))
        self.fusion = nn.Sequential(nn.Conv2d(cat, output_dim, 3, padding=1), _bn(output_dim))
        if use_cbam:
            self.cbam = CBAM(output_dim)
        self.enhancement = nn.Sequential(nn.Conv2d(output_dim, output_dim, 1))

    def forward(self, features: List[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:param features: per-scale NHWC maps [(B, H_i, W_i, C_i), ...], finest first
        :param generator: the dropout masks' draws (train mode, dropout > 0)
        :return: (B, H_0, W_0, output_dim)
        """
        if not features:
            raise ValueError("features list is empty")
        th, tw = features[0].shape[1], features[0].shape[2]
        projected = []
        for proj, feat in zip(self.projections, features):
            y = F.relu(nchw(proj[1], dense_1x1(proj[0], feat)))
            y = dropout(y, self.dropout, self.training, generator, self.data_shard)
            if y.shape[1:3] != (th, tw):
                y = resize_bilinear(y, th, tw)
            projected.append(y)
        concat = torch.cat(projected, dim=-1)

        if self.use_attention:
            # channel attention: global pool -> per-scale softmax weights;
            # spatial attention: 7x7 conv -> per-scale per-pixel softmax
            cw = torch.softmax(dense_1x1(self.channel_attention[1], concat.mean(dim=(1, 2))), -1)
            sw = torch.softmax(nchw(self.spatial_attention[0], concat), dim=-1)
            weights = cw[:, None, None, :] * sw
            concat = torch.cat([p * weights[..., i:i + 1] for i, p in enumerate(projected)],
                               dim=-1)

        fused = F.relu(nchw(self.fusion[1], nchw(self.fusion[0], concat)))
        fused = dropout(fused, self.dropout, self.training, generator, self.data_shard)
        if self.use_cbam:
            fused = self.cbam(fused)
        return F.relu(dense_1x1(self.enhancement[0], fused)).contiguous()


class AdaptiveFeatureSampler(nn.Module):
    """Quality-gated scale weighting.

    :param feature_dim: the quality MLP's width is ``feature_dim // 4``
    :param layer_dims: channels of each scale (the JAX layers infer them
        from the input); one scale of ``feature_dim`` when not given
    """

    def __init__(self, feature_dim: int, quality_threshold: float = 0.3,
                 layer_dims: Optional[Sequence[int]] = None):
        super().__init__()
        dims = list(layer_dims) if layer_dims is not None else [feature_dim]
        hidden = max(feature_dim // 4, 1)
        self.quality_threshold = quality_threshold
        self.quality_fc1 = nn.ModuleList(nn.Linear(d, hidden) for d in dims)
        self.quality_fc2 = nn.ModuleList(nn.Linear(hidden, 1) for _ in dims)

    def forward(self, features: List[torch.Tensor], return_q: bool = False):
        """:return: the features, each scaled by its gate; or the (B, n)
        qualities when ``return_q``"""
        q = torch.cat([
            torch.sigmoid(fc2(F.relu(fc1(feat.mean(dim=(1, 2))))))
            for fc1, fc2, feat in zip(self.quality_fc1, self.quality_fc2, features)], dim=-1)
        if return_q:
            return q
        keep = (q >= self.quality_threshold).to(q.dtype)
        # the best scale is always kept
        best = F.one_hot(torch.argmax(q, dim=-1), q.shape[-1]).to(q.dtype)
        keep = torch.maximum(keep, best)
        gate = q * keep
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-8) * keep.sum(-1, keepdim=True)
        return [feat * gate[:, i, None, None, None] for i, feat in enumerate(features)]

    @staticmethod
    def select(features: List, qualities, top_k: Optional[int] = None,
               quality_threshold: float = 0.3):
        """The reference's hard selection, on the host: scales by descending
        quality of batch element 0, at most ``top_k``, those at or above the
        threshold, at least the best one.

        :param qualities: (B, n) scores from ``forward(..., return_q=True)``
        :return: (selected features, their indices), by descending quality
        """
        q = (qualities.detach().cpu().numpy() if torch.is_tensor(qualities)
             else np.asarray(qualities))
        order = np.argsort(-q[0], kind="stable")
        sel_feats, sel_idx = [], []
        for idx in order:
            if top_k is not None and len(sel_feats) >= top_k:
                break
            if q[0, idx] >= quality_threshold:
                sel_feats.append(features[idx])
                sel_idx.append(int(idx))
        if not sel_feats:
            sel_feats.append(features[order[0]])
            sel_idx.append(int(order[0]))
        return sel_feats, sel_idx


class MultiScaleFusionModule(nn.Module):
    """Unify the channels with 1 x 1 layers, resize every scale to the
    coarsest map (antialiased), and sum them under softmax weights."""

    def __init__(self, layer_dims: Sequence[int], output_dim: int = 256):
        super().__init__()
        self.unify = nn.ModuleList(nn.Linear(d, output_dim) for d in layer_dims)
        self.scale_logits = nn.Parameter(torch.zeros(len(layer_dims)))

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        th, tw = features[-1].shape[1], features[-1].shape[2]
        unified = []
        for unify, feat in zip(self.unify, features):
            y = unify(feat)
            if y.shape[1:3] != (th, tw):
                y = resize_bilinear(y, th, tw)
            unified.append(y)
        return torch.einsum("nbhwc,n->bhwc", torch.stack(unified),
                            torch.softmax(self.scale_logits, dim=0))


def create_feature_fusion(feature_dim: Optional[int] = None,
                          layer_dims: Optional[Sequence[int]] = None,
                          fusion_type: str = "smart", **kwargs):
    """Convenience constructor, as the JAX package's."""
    if fusion_type == "smart":
        if layer_dims is not None:
            return SmartFeatureFusion(layer_dims=tuple(layer_dims), **kwargs)
        if feature_dim is not None:
            return SmartFeatureFusion(layer_dims=(feature_dim,), **kwargs)
        raise ValueError("Must provide either feature_dim or layer_dims")
    if fusion_type == "adaptive":
        if feature_dim is None:
            raise ValueError("feature_dim is required for adaptive fusion")
        return AdaptiveFeatureSampler(feature_dim, layer_dims=layer_dims)
    raise ValueError(f"Unknown fusion type: {fusion_type}")


@torch.no_grad()
def reset_fusion_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of the model's fusion stage (``SmartFeatureFusion`` or
    ``AdaptiveFeatureSampler``): LeCun-normal weights (flax's default fan-in
    scale), zero biases, unit / zero BatchNorm with fresh running statistics."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / fan_in**0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
