"""Camera / ray geometry: the parts of the JAX package's ``utils/geometry.py``
that the single-view render needs.

Tensor functions take and return ``torch`` tensors on the caller's device;
the host-side constructors (rays, poses) stay numpy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def _intrinsics_np(focal, c, width: int, height: int):
    """(fx, fy, cx, cy) from a scalar or [fx, fy] focal and an optional
    principal point (default: the image center)."""
    f = np.atleast_1d(np.asarray(focal, np.float32).squeeze())
    fx, fy = (f[0], f[0]) if f.size == 1 else (f[0], f[1])
    if c is None:
        cx, cy = width * 0.5, height * 0.5
    else:
        cc = np.asarray(c, np.float32).reshape(-1)
        cx, cy = cc[0], cc[1]
    return fx, fy, cx, cy


def gen_rays_np(
    poses: np.ndarray,
    width: int,
    height: int,
    focal,
    z_near: float,
    z_far: float,
    c=None,
) -> np.ndarray:
    """Camera rays for every pixel of every view (OpenGL camera: +x right,
    +y up, looking down -z).

    :param poses: (B, 4, 4) camera-to-world
    :return: (B, height, width, 8) = [origin(3), direction(3), near, far]
    """
    poses = np.asarray(poses, np.float32)
    fx, fy, cx, cy = _intrinsics_np(focal, c, width, height)
    xs = (np.arange(width, dtype=np.float32) - cx) / fx
    ys = (np.arange(height, dtype=np.float32) - cy) / fy
    X, Y = np.meshgrid(xs, ys)
    dirs = np.stack([X, -Y, -np.ones_like(X)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    world_dirs = np.einsum("bij,hwj->bhwi", poses[:, :3, :3], dirs)
    centers = np.broadcast_to(poses[:, None, None, :3, 3], world_dirs.shape)
    nears = np.full(world_dirs.shape[:-1] + (1,), z_near, np.float32)
    fars = np.full(world_dirs.shape[:-1] + (1,), z_far, np.float32)
    return np.concatenate([centers, world_dirs, nears, fars], axis=-1).astype(np.float32)


def trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def rot_theta(th: float) -> np.ndarray:
    # -sin in row 0: the sign layout of the NeRF pose_spherical helpers
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


_POSE_SPHERICAL_FLIP = np.array(
    [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Spherical camera-to-world pose (angles in degrees)."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * math.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * math.pi) @ c2w
    return _POSE_SPHERICAL_FLIP @ c2w


def invert_poses(poses: torch.Tensor) -> torch.Tensor:
    """Camera-to-world (NS, 4, 4) -> compact world-to-camera (NS, 3, 4):
    ``rot = R^T; trans = -R^T t``."""
    poses = poses.float()
    rot = poses[:, :3, :3].transpose(1, 2)
    trans = -torch.einsum("nij,nj->ni", rot, poses[:, :3, 3])
    return torch.cat([rot, trans[..., None]], dim=-1)


def repeat_interleave(x: torch.Tensor, repeats: int) -> torch.Tensor:
    """Repeat-interleave along axis 0: [a, b] -> [a, a, b, b] for repeats=2."""
    if repeats == 1:
        return x
    return torch.repeat_interleave(x, repeats, dim=0)


def combine_interleaved(
    t: torch.Tensor, inner_dims: Sequence[int] = (1,), agg_type: str = "average"
) -> torch.Tensor:
    """Reduce over the interleaved multi-view dimension: ``t`` of shape
    (NS*B_outer, ...) is viewed as (-1, *inner_dims, ...) and reduced over
    dim 1 with mean or max."""
    if len(inner_dims) == 1 and inner_dims[0] == 1:
        return t
    t = t.reshape((-1,) + tuple(inner_dims) + tuple(t.shape[1:]))
    if agg_type == "average":
        return t.mean(dim=1)
    if agg_type == "max":
        return t.amax(dim=1)
    raise NotImplementedError(f"Unsupported combine type {agg_type}")


def gen_rays_at_np(poses: np.ndarray, width: int, height: int, focal, z_near: float,
                   z_far: float, pix: np.ndarray, c=None) -> np.ndarray:
    """Rays for a sparse set of pixels only, with the per-pixel math of
    :func:`gen_rays_np`: the training path's ray builder.

    :param pix: (R, 3) int [view, row, col]
    :return: (R, 8) rays [origin, dir, near, far]
    """
    poses = np.asarray(poses, np.float32)
    fx, fy, cx, cy = _intrinsics_np(focal, c, width, height)
    v = pix[:, 0]
    dx = (pix[:, 2].astype(np.float32) - cx) / fx
    dy = (pix[:, 1].astype(np.float32) - cy) / fy
    dirs = np.stack([dx, -dy, -np.ones_like(dx)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    world_dirs = np.einsum("rij,rj->ri", poses[v, :3, :3], dirs)
    centers = poses[v, :3, 3]
    R = pix.shape[0]
    nears = np.full((R, 1), z_near, np.float32)
    fars = np.full((R, 1), z_far, np.float32)
    return np.concatenate([centers, world_dirs, nears, fars], axis=-1).astype(np.float32)


def bbox_sample_np(bboxes: np.ndarray, num_pix: int, rng: np.random.Generator) -> np.ndarray:
    """Pixel indices drawn inside per-view foreground bboxes.

    :param bboxes: (NV, 4) [cmin, rmin, cmax, rmax]
    :return: (num_pix, 3) [view, y, x]
    """
    image_ids = rng.integers(0, bboxes.shape[0], (num_pix,))
    pb = bboxes[image_ids]
    x = (rng.random(num_pix) * (pb[:, 2] + 1 - pb[:, 0]) + pb[:, 0]).astype(np.int64)
    y = (rng.random(num_pix) * (pb[:, 3] + 1 - pb[:, 1]) + pb[:, 1]).astype(np.int64)
    return np.stack([image_ids, y, x], axis=-1)
