"""Depth-based view warping and consistency utilities: the port of the JAX
package's ``utils/warping.py``.

Image warping between views from per-pixel depth with a validity mask,
occlusion masks from depth consistency, the reprojection error, plane-depth
maps and random source-view sampling.  No render path calls them.  The
inverse intrinsics and the 3x3 contractions stay f32 (products and sums,
never a TF32 matmul).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.grid_sample import grid_sample


def _apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) matrices applied to (B or 1, H, W, 3) vectors -> (B, H, W, 3)."""
    return (m[:, None, None] * v[..., None, :]).sum(-1)


def warp_image(img: torch.Tensor, depth: torch.Tensor, K: torch.Tensor, pose: torch.Tensor,
               target_K: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp ``img`` into another view given its per-pixel depth and the
    relative pose; pixels that land outside the frame sample zeros.

    :param img: (B, H, W, C) source images
    :param depth: (B, H, W) or (B, H, W, 1) source-view depth
    :param K: (B, 3, 3) source intrinsics (CV convention, pixel units)
    :param pose: (B, 4, 4) source -> target transform
    :param target_K: (B, 3, 3) target intrinsics (default ``K``)
    :return: (warped (B, H, W, C), valid (B, H, W, 1) f32)
    """
    B, H, W, C = img.shape
    dev = img.device
    if depth.ndim == 4:
        depth = depth[..., 0]
    K = K.float()
    target_K = K if target_K is None else target_K.float()
    pose = pose.float()

    ii, jj = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([jj, ii, torch.ones_like(jj)], dim=-1)[None]  # (1, H, W, 3)

    cam = _apply(torch.linalg.inv(K), pix) * depth[..., None].float()
    tgt = _apply(pose[:, :3, :3], cam) + pose[:, None, None, :3, 3]
    proj = _apply(target_K, tgt)
    Z = torch.clamp(proj[..., 2:3], min=1e-3)
    uv = proj[..., :2] / Z

    gx = 2.0 * uv[..., 0] / (W - 1) - 1.0
    gy = 2.0 * uv[..., 1] / (H - 1) - 1.0
    grid = torch.stack([gx, gy], dim=-1).reshape(B, H * W, 2)
    warped = grid_sample(img, grid, padding_mode="zeros").reshape(B, H, W, C)
    valid = (gx >= -1) & (gx <= 1) & (gy >= -1) & (gy <= 1) & (tgt[..., 2] > 0)
    return warped, valid.float()[..., None]


def compute_occlusion_mask(depth_src: torch.Tensor, depth_warped: torch.Tensor,
                           threshold: float = 0.01) -> torch.Tensor:
    """1 where the warped depth agrees with the source depth within
    ``threshold`` (relative), 0 where it is occluded."""
    rel = torch.abs(depth_src - depth_warped) / torch.clamp(depth_src, min=1e-6)
    return (rel < threshold).float()


def compute_reprojection_error(img_target: torch.Tensor, img_warped: torch.Tensor,
                               valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute photometric error, over the valid pixels when a mask is
    given."""
    err = torch.abs(img_target - img_warped)
    if valid_mask is not None:
        denom = torch.clamp(valid_mask.sum(), min=1.0) * img_target.shape[-1]
        return (err * valid_mask).sum() / denom
    return err.mean()


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) at normalized coords (B, N, 2) in [-1, 1], zeros
    outside."""
    return grid_sample(img, coords, padding_mode="zeros")


def generate_depth_map(plane_depth: float, height: int, width: int, batch: int = 1,
                       device=None) -> torch.Tensor:
    """A constant-plane depth map (batch, height, width)."""
    return torch.full((batch, height, width), plane_depth, dtype=torch.float32, device=device)


def sample_random_views(n_views: int, n_sample: int, rng: np.random.Generator,
                        exclude=()) -> np.ndarray:
    """Distinct view indices drawn without replacement, ``exclude`` left out
    (host-side)."""
    pool = np.array([i for i in range(n_views) if i not in set(exclude)])
    n_sample = min(n_sample, len(pool))
    return rng.choice(pool, size=n_sample, replace=False)
