"""Spatial (pixel-aligned) and global image encoders on a ResNet trunk.

Images and feature maps are NHWC at this module's surface, as in the JAX
package; the trunk runs NCHW inside.  ``use_multi_scale`` returns the
per-stage maps (finest first) for the fusion stack; otherwise they are
upsampled to the stage-0 resolution and concatenated.  The lookup is
bilinear (4 taps) or ``index_interp = "nearest"`` (``grid_sample``, which
never rides the fused gather).  Two uv normalizations:

* ``index_normalize="image"`` (default): uv pixel coordinates are normalized
  against the input image extent, ``g = u * (W_l / W_img) * 2/(W_l - 1) - 1``;
* ``index_normalize="feature"``: normalized against the feature map's own
  (W_l - 1, H_l - 1), exact only when feature res == image res.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.grid_sample import (
    bilinear_taps,
    gather_taps,
    grid_sample,
    resize_bilinear_align_corners,
    resize_nearest,
)
from . import resnet


class SpatialEncoder(nn.Module):
    """2D pixel-aligned feature extractor: the per-stage maps, or (single
    scale) those maps upsampled to the stage-0 resolution and
    channel-concatenated (512 channels for resnet34 / num_layers=4)."""

    def __init__(
        self,
        backbone: str = "resnet34",
        num_layers: int = 4,
        index_interp: str = "bilinear",
        index_padding: str = "border",
        upsample_interp: str = "bilinear",
        feature_scale: float = 1.0,
        use_first_pool: bool = True,
        use_multi_scale: bool = False,
        index_normalize: str = "image",
    ):
        super().__init__()
        if index_interp not in ("bilinear", "nearest"):
            raise NotImplementedError(f"index_interp {index_interp!r}")
        if upsample_interp not in ("bilinear", "nearest"):
            raise NotImplementedError(f"upsample_interp {upsample_interp!r}")
        self.backbone = backbone
        self.num_layers = num_layers
        self.index_interp = index_interp
        self.index_padding = index_padding
        self.upsample_interp = upsample_interp
        self.feature_scale = feature_scale
        self.use_multi_scale = use_multi_scale
        self.index_normalize = index_normalize
        self.model = resnet.ResNetFeatures(backbone, num_layers, use_first_pool)

    @property
    def latent_sizes(self) -> List[int]:
        return list(resnet.stage_channels(self.backbone)[: self.num_layers])

    @property
    def latent_size(self) -> Union[int, List[int]]:
        """Multi-scale: the per-scale channels; else the unified map's total."""
        return self.latent_sizes if self.use_multi_scale else sum(self.latent_sizes)

    def forward(self, x: torch.Tensor):
        """:param x: (B, H, W, 3) images in [-1, 1]
        :return: [(B, H_i, W_i, C_i), ...] if multi-scale, else (B, H0, W0, sum C_i)
        """
        if self.feature_scale != 1.0:
            x = x * self.feature_scale
        feats = [f.permute(0, 2, 3, 1) for f in self.model(x.permute(0, 3, 1, 2))]
        if self.use_multi_scale:
            return feats
        h0, w0 = feats[0].shape[1], feats[0].shape[2]
        up = (
            resize_bilinear_align_corners
            if self.upsample_interp == "bilinear"
            else resize_nearest
        )
        unified = [f if f.shape[1:3] == (h0, w0) else up(f, h0, w0) for f in feats]
        return torch.cat(unified, dim=-1)

    def _grid(self, lat: torch.Tensor, uv: torch.Tensor, image_shape) -> torch.Tensor:
        w_img, h_img = image_shape
        h_l, w_l = lat.shape[1], lat.shape[2]
        if self.index_normalize == "feature":
            gx = uv[..., 0] / (w_l - 1) * 2.0 - 1.0
            gy = uv[..., 1] / (h_l - 1) * 2.0 - 1.0
        else:
            gx = uv[..., 0] * (w_l / w_img) * (2.0 / max(w_l - 1, 1)) - 1.0
            gy = uv[..., 1] * (h_l / h_img) * (2.0 / max(h_l - 1, 1)) - 1.0
        return torch.stack([gx, gy], dim=-1)

    def index(self, latents: Union[torch.Tensor, Sequence[torch.Tensor]], uv: torch.Tensor,
              image_shape: Tuple[float, float]) -> torch.Tensor:
        """Sample pixel-aligned features at image-space points.

        :param latents: the output of ``forward``: one (B, H_l, W_l, C) map or
            a list of per-scale maps, each normalized by its own (H_l, W_l)
        :param uv: (B, N, 2) points in input-image pixel coordinates
        :param image_shape: (W_img, H_img) of the encoded images
        :return: (B, N, sum C) -- the per-scale samples concatenated
        """
        if torch.is_tensor(latents):
            latents = [latents]
        samples = []
        for lat in latents:
            h_l, w_l = lat.shape[1], lat.shape[2]
            if self.index_interp != "bilinear":
                samples.append(grid_sample(lat, self._grid(lat, uv, image_shape), align_corners=True,
                                           padding_mode=self.index_padding,
                                           mode=self.index_interp))
                continue
            t_idx, t_w = bilinear_taps(
                self._grid(lat, uv, image_shape), h_l, w_l,
                align_corners=True, padding_mode=self.index_padding,
            )
            samples.append(gather_taps(lat.reshape(lat.shape[0], h_l * w_l, -1), t_idx, t_w))
        return samples[0] if len(samples) == 1 else torch.cat(samples, dim=-1)

    def index_taps(self, lat: torch.Tensor, uv: torch.Tensor,
                   image_shape: Tuple[float, float]):
        """Bilinear taps into ``lat.reshape(B, H_l*W_l, C)`` for the fused
        lookup (``ops.resnetfc_fused.LatentGather``).

        :return: (idx (B, N, 8) int32, w (B, N, 8) f32), taps 4..7 zero
        """
        h_l, w_l = lat.shape[1], lat.shape[2]
        return bilinear_taps(
            self._grid(lat, uv, image_shape), h_l, w_l,
            align_corners=True, padding_mode=self.index_padding, pad_taps_to=8,
        )

    @classmethod
    def from_conf(cls, conf) -> "SpatialEncoder":
        return cls(
            backbone=conf.get_string("backbone", "resnet34"),
            num_layers=conf.get_int("num_layers", 4),
            index_interp=conf.get_string("index_interp", "bilinear"),
            index_padding=conf.get_string("index_padding", "border"),
            upsample_interp=conf.get_string("upsample_interp", "bilinear"),
            feature_scale=conf.get_float("feature_scale", 1.0),
            use_first_pool=conf.get_bool("use_first_pool", True),
            use_multi_scale=conf.get_bool("use_multi_scale", False),
            index_normalize=conf.get_string("index_normalize", "image"),
        )


class GlobalEncoder(nn.Module):
    """Global image code: a ResNet trunk of all five stages (first pool on),
    the spatial mean of its last map, then the ``fc`` Linear when that width
    is not ``latent_size`` (the JAX ``GlobalEncoder``).

    :return from forward: (B, latent_size)
    """

    def __init__(self, backbone: str = "resnet34", latent_size: int = 128):
        super().__init__()
        self.backbone = backbone
        self.latent_size = latent_size
        self.model = resnet.ResNetFeatures(backbone, num_layers=5, use_first_pool=True)
        width = resnet.stage_channels(backbone)[-1]
        self.fc = nn.Linear(width, latent_size) if width != latent_size else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:param x: (B, H, W, 3) images in [-1, 1]"""
        pooled = self.model(x.permute(0, 3, 1, 2))[-1].mean(dim=(2, 3))
        return pooled if self.fc is None else self.fc(pooled)

    @classmethod
    def from_conf(cls, conf) -> "GlobalEncoder":
        return cls(backbone=conf.get_string("backbone", "resnet34"),
                   latent_size=conf.get_int("latent_size", 128))
