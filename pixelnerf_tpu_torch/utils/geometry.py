"""Camera / ray geometry: the port of the JAX package's ``utils/geometry.py``.

Tensor functions take and return ``torch`` tensors on the caller's device;
the host-side constructors (``*_np`` rays and samplers, poses) stay numpy,
as in the JAX package.  The 3x3 contractions are written as f32 products
and sums, so that no TF32 matmul can round them on the card.
"""

from __future__ import annotations

import math
import warnings
from typing import Sequence, Tuple

import numpy as np
import torch


def _per_view(x) -> bool:
    """Whether a focal or principal point holds one [x, y] row per view
    (NV, 2) with NV > 1, as the DVR adapter returns when views differ."""
    return x is not None and np.ndim(x) == 2 and np.shape(x)[0] > 1


def view_rows(x, views):
    """The rows of ``views`` (an index, list or mask) of a per-view focal or
    principal point; one shared by every view is returned as it is."""
    return np.asarray(x)[views] if _per_view(x) else x


def _focal_np(focal):
    """(fx, fy) from a scalar or [fx, fy] focal."""
    f = np.atleast_1d(np.asarray(focal, np.float32).squeeze())
    return (f[0], f[0]) if f.size == 1 else (f[0], f[1])


def _center_np(c, width: int, height: int):
    """(cx, cy) from an optional principal point (default: the image center)."""
    if c is None:
        return width * 0.5, height * 0.5
    cc = np.asarray(c, np.float32).reshape(-1)
    return cc[0], cc[1]


def _intrinsics_np(focal, c, width: int, height: int):
    """(fx, fy, cx, cy) from a scalar or [fx, fy] focal and an optional
    principal point (default: the image center)."""
    return _focal_np(focal) + _center_np(c, width, height)


def _as_f32(x, device=None) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


def _focal_to_2d(f: torch.Tensor) -> torch.Tensor:
    """A scalar or [fx, fy] focal -> (2,) [fx, fy]."""
    f = f.reshape(-1)
    return torch.cat([f, f]) if f.shape[0] == 1 else f[:2]


def _rotate(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` over the last axis in f32 products and sums:
    m (..., 3, 3), v (..., 3) broadcast against each other."""
    return (m * v[..., None, :]).sum(-1)


def unproj_map(width: int, height: int, f, c=None, device=None) -> torch.Tensor:
    """Per-pixel unit camera-ray directions of an OpenGL camera (+x right,
    +y up, looking down -z): ``normalize([(x - cx)/fx, -(y - cy)/fy, -1])``.

    :param f: focal, scalar or [fx, fy]
    :param c: principal point, None (the image center) or [cx, cy]
    :return: (height, width, 3) f32 on ``f``'s device (or ``device``)
    """
    f2 = _focal_to_2d(_as_f32(f, device))
    dev = f2.device
    if c is None:
        c = torch.tensor([width * 0.5, height * 0.5], dtype=torch.float32, device=dev)
    else:
        c = _as_f32(c, dev).reshape(-1)[:2]
    xs = (torch.arange(width, dtype=torch.float32, device=dev) - c[0]) / f2[0]
    ys = (torch.arange(height, dtype=torch.float32, device=dev) - c[1]) / f2[1]
    Y, X = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    unproj = torch.stack([X, -Y, -torch.ones_like(X)], dim=-1)
    return unproj / torch.linalg.norm(unproj, dim=-1, keepdim=True)


def gen_rays(poses, width: int, height: int, focal, z_near: float, z_far: float, c=None,
             ndc: bool = False) -> torch.Tensor:
    """Camera rays for every pixel of every view, on the poses' device: the
    tensor twin of :func:`gen_rays_np`, with the forward-facing NDC branch.

    :param poses: (B, 4, 4) camera-to-world
    :param ndc: map the rays to NDC space (near 0, far 1; other values warn)
    :return: (B, height, width, 8) = [origin(3), direction(3), near, far]
    """
    poses = _as_f32(poses)
    dev = poses.device
    B = poses.shape[0]
    cam_unproj = unproj_map(width, height, _as_f32(focal, dev).squeeze(), c=c)
    cam_raydir = _rotate(poses[:, None, None, :3, :3], cam_unproj[None])
    cam_centers = poses[:, None, None, :3, 3].expand(B, height, width, 3)
    if ndc:
        if not (z_near == 0 and z_far == 1):
            warnings.warn("dataset z near and z_far not compatible with NDC, "
                          "setting them to 0, 1 NOW")
        z_near, z_far = 0.0, 1.0
        cam_centers, cam_raydir = ndc_rays(width, height, focal, 1.0, cam_centers, cam_raydir)
    nears = torch.full((B, height, width, 1), z_near, dtype=torch.float32, device=dev)
    fars = torch.full((B, height, width, 1), z_far, dtype=torch.float32, device=dev)
    return torch.cat([cam_centers, cam_raydir, nears, fars], dim=-1)


def ndc_rays(width: int, height: int, focal, near: float, rays_o: torch.Tensor,
             rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift ray origins to the near plane and map them to NDC space (the
    NeRF forward-facing transform).  A focal of [fx, fy] gives x fx, y fy."""
    f = _as_f32(focal, rays_o.device).reshape(-1)
    fx, fy = f[0], f[-1]
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]
    sx, sy = -1.0 / (width / (2.0 * fx)), -1.0 / (height / (2.0 * fy))
    o = torch.stack([sx * ox / oz, sy * oy / oz, 1.0 + 2.0 * near / oz], -1)
    d = torch.stack([sx * (dx / dz - ox / oz), sy * (dy / dz - oy / oz), -2.0 * near / oz], -1)
    return o, d


def batched_index_select_nd(t: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Index dim 1 of a batched tensor: t (B, n, ...), inds (B, k) -> (B, k, ...)."""
    idx = inds.reshape(tuple(inds.shape) + (1,) * (t.ndim - 2))
    return torch.gather(t, 1, idx.expand(tuple(inds.shape) + tuple(t.shape[2:])))


def batched_index_select_nd_last(t: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Index the last dim: t (..., n, m), inds (..., k) -> (..., n, k)."""
    return torch.gather(t, -1, inds[..., None, :].expand(tuple(t.shape[:-1]) + (inds.shape[-1],)))


def masked_sample_np(masks: np.ndarray, num_pix: int, prop_inside: float,
                     rng: np.random.Generator, thresh: float = 0.5) -> np.ndarray:
    """Pixel indices with a target in/out-of-mask proportion.

    :param masks: (NV, H, W[, 1])
    :return: (num_pix, 3) [view, y, x]
    """
    m = masks[..., 0] if masks.ndim == 4 else masks
    num_inside = int(num_pix * prop_inside + 0.5)
    inside = np.argwhere(m >= thresh)
    outside = np.argwhere(m < thresh)
    pix_inside = inside[rng.integers(0, len(inside), num_inside)]
    pix_outside = outside[rng.integers(0, len(outside), num_pix - num_inside)]
    return np.concatenate([pix_inside, pix_outside], axis=0)


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
    :param focal: scalar, [fx, fy], or (B, 2) with one row per view
    :param c: None (the image center), [cx, cy], or (B, 2) one row per view
    :return: (B, height, width, 8) = [origin(3), direction(3), near, far]
    """
    poses = np.asarray(poses, np.float32)
    if _per_view(focal) or _per_view(c):
        return np.concatenate([
            gen_rays_np(poses[i:i + 1], width, height, view_rows(focal, i), z_near, z_far,
                        c=view_rows(c, i)) for i in range(poses.shape[0])])
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


def coord_from_blender(dtype=np.float32) -> np.ndarray:
    """Blender -> standard (x right, y up, z out) coordinate transform, 4x4."""
    return np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], dtype=dtype)


def coord_to_blender(dtype=np.float32) -> np.ndarray:
    """Standard -> Blender coordinate transform, 4x4 (the inverse of
    :func:`coord_from_blender`)."""
    return np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=dtype)


def look_at(origin: np.ndarray, target: np.ndarray,
            world_up: np.ndarray = np.array([0, 1.0, 0], dtype=np.float32)) -> np.ndarray:
    """4x4 camera-to-world of a camera at ``origin`` looking at ``target``."""
    back = np.asarray(origin, np.float32) - np.asarray(target, np.float32)
    back = back / np.linalg.norm(back)
    right = np.cross(world_up, back)
    right = right / np.linalg.norm(right)
    up = np.cross(back, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = up
    m[:3, 2] = back
    m[:3, 3] = origin
    return m


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """Unit-normalized quaternions (B, 4) [r, i, j, k] -> rotation matrices
    (B, 3, 3), float32 (the DTU spline camera path of ``gen_video``)."""
    q = np.asarray(q, np.float32)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    qr, qi, qj, qk = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack([
        1 - 2 * (qj**2 + qk**2), 2 * (qj * qi - qk * qr), 2 * (qi * qk + qr * qj),
        2 * (qj * qi + qk * qr), 1 - 2 * (qi**2 + qk**2), 2 * (qj * qk - qi * qr),
        2 * (qk * qi - qj * qr), 2 * (qj * qk + qi * qr), 1 - 2 * (qi**2 + qj**2),
    ], axis=-1)
    return R.reshape(-1, 3, 3).astype(np.float32)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (B, 3, 3) -> quaternions (B, 4) [r, i, j, k]."""
    R = _as_f32(R)
    qr = torch.sqrt(1.0 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]) / 2
    qi = (R[:, 2, 1] - R[:, 1, 2]) / (4 * qr)
    qj = (R[:, 0, 2] - R[:, 2, 0]) / (4 * qr)
    qk = (R[:, 1, 0] - R[:, 0, 1]) / (4 * qr)
    return torch.stack([qr, qi, qj, qk], dim=-1)


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
    :param focal, c: as :func:`gen_rays_np`'s; a row per view is read at
        each pixel's view
    :return: (R, 8) rays [origin, dir, near, far]
    """
    poses = np.asarray(poses, np.float32)
    v = pix[:, 0]
    fx, fy = np.asarray(focal, np.float32)[v].T if _per_view(focal) else _focal_np(focal)
    cx, cy = np.asarray(c, np.float32)[v].T if _per_view(c) else _center_np(c, width, height)
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


def homogeneous(points: torch.Tensor) -> torch.Tensor:
    """Append 1 to the last dim."""
    return torch.cat([points, points.new_ones(tuple(points.shape[:-1]) + (1,))], dim=-1)
