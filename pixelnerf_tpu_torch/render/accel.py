"""Per-scene occupancy grid for the eval render (the JAX package's
``render/accel.py``).

1. **Build** (once per encoded scene): the field's sigma is probed at every
   voxel centre of a ``resolution``^3 grid over the box of the rays to be
   rendered, under a few view-direction probes and both heads, max-reduced,
   dilated by a 3x3x3 max pool and thresholded.
2. **Lookup**: each ray sample is tested against its nearest voxel.  Points
   outside the box are conservatively occupied; the grid only ever skips
   space it has verified empty.

The renderer (``renderer.py``) uses the grid to compact away dead rays or
samples, or as the importance proposal in place of the coarse field pass.
Every step is a torch op; the field evaluations of the build run through
the model's own route (the field kernels on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class OccupancyGrid:
    """Occupancy over an axis-aligned box, stored flat for gathers.

    ``sig`` keeps the dilated max-sigma field the occupancy was thresholded
    from; the proposal render composites it into its importance pdf.  A
    grid without ``sig`` falls back to the binary-mask pdf."""

    occ: torch.Tensor  # (R^3,) float32 in {0, 1}
    lo: torch.Tensor  # (3,) world-space box min corner
    inv_cell: torch.Tensor  # (3,) R / (hi - lo)
    sig: Optional[torch.Tensor] = None  # (R^3,) float32 dilated max sigma
    thresh: Optional[torch.Tensor] = None  # () the build's sigma threshold
    resolution: int = 64


def aabb_from_rays(rays: np.ndarray, pad_frac: float = 0.01):
    """World box of all ray segments (host numpy): the box of every ray's
    near and far endpoints, padded by ``pad_frac`` of its extent.

    :param rays: (..., 8) [o, d, near, far]
    :return: (lo (3,), hi (3,)) float32 numpy
    """
    rays = np.asarray(rays, np.float32).reshape(-1, 8)
    o, d = rays[:, :3], rays[:, 3:6]
    pts = np.concatenate([o + rays[:, 6:7] * d, o + rays[:, 7:8] * d], axis=0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    pad = (hi - lo) * pad_frac + 1e-6
    return (lo - pad).astype(np.float32), (hi + pad).astype(np.float32)


def probe_dirs(n_dir_probes: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(max(n, 1), 3) unit view directions: normals from ``generator`` (a
    fresh one seeded 0 when None), normalized."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dirs = torch.randn(max(n_dir_probes, 1), 3, generator=generator, device=generator.device)
    return dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8)


@torch.no_grad()
def build_occupancy_grid(field_fn: Callable, lo, hi, resolution: int = 64,
                         sigma_thresh: float = 1e-2, dilate: int = 1, n_dir_probes: int = 4,
                         generator: Optional[torch.Generator] = None,
                         dirs: Optional[torch.Tensor] = None, chunk: int = 1 << 18,
                         use_fine: bool = True, use_viewdirs: bool = False,
                         device=None) -> OccupancyGrid:
    """Probe the field's sigma at the voxel centres and threshold it.

    :param field_fn: ``(points (1, P, 3), viewdirs | None, coarse) -> (1, 4, P)``
        channel-major rgb + sigma, the renderer's model contract
    :param sigma_thresh: keep voxels whose dilated max sigma exceeds this
    :param dilate: rounds of 3x3x3 max-pool dilation
    :param n_dir_probes: view directions max-reduced when ``use_viewdirs``
        (drawn by :func:`probe_dirs` from ``generator``, or ``dirs`` (n, 3)
        as given)
    :param chunk: field points per call (the voxel list is padded to whole
        chunks, so every call has the same shape)
    """
    R = int(resolution)
    device = torch.device(device) if device is not None else torch.device("cpu")
    lo = torch.as_tensor(np.asarray(lo, np.float32), device=device)
    hi = torch.as_tensor(np.asarray(hi, np.float32), device=device)
    extent = hi - lo
    idx = (torch.arange(R, dtype=torch.float32, device=device) + 0.5) / R
    gx, gy, gz = torch.meshgrid(idx, idx, idx, indexing="ij")
    centers = lo + torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3) * extent
    P = centers.shape[0]

    if use_viewdirs:
        if dirs is None:
            dirs = probe_dirs(n_dir_probes, generator)
        dirs = torch.as_tensor(dirs, dtype=torch.float32).to(device)
    else:
        dirs = torch.zeros(1, 3, device=device)

    n_chunks = -(-P // chunk)
    pts = F.pad(centers, (0, 0, 0, n_chunks * chunk - P)).reshape(n_chunks, chunk, 3)
    sigma_max = torch.zeros(P, device=device)
    for coarse in ((True, False) if use_fine else (True,)):
        for di in range(dirs.shape[0]):
            vd = dirs[di].expand(1, chunk, 3) if use_viewdirs else None
            sig = torch.cat([field_fn(p[None], vd, coarse)[0, 3] for p in pts])[:P]
            sigma_max = torch.maximum(sigma_max, sig.float())

    # the max pool commutes with the threshold: occ = dilated sigma > thresh
    sig = torch.relu(sigma_max).reshape(1, 1, R, R, R)
    for _ in range(max(dilate, 0)):
        sig = F.max_pool3d(sig, kernel_size=3, stride=1, padding=1)
    sig = sig.reshape(-1)
    return OccupancyGrid(
        occ=(sig > sigma_thresh).float(), lo=lo, inv_cell=R / torch.clamp(extent, min=1e-8),
        sig=sig, thresh=torch.tensor(float(sigma_thresh), dtype=torch.float32, device=device),
        resolution=R,
    )


def _voxel(grid: OccupancyGrid, points: torch.Tensor):
    """(flat voxel index, inside-the-box mask) of each point's voxel."""
    R = grid.resolution
    idx = torch.floor((points - grid.lo) * grid.inv_cell).to(torch.int64)
    inside = ((idx >= 0) & (idx < R)).all(dim=-1)
    idx = idx.clamp(0, R - 1)
    return (idx[..., 0] * R + idx[..., 1]) * R + idx[..., 2], inside


def occupancy_lookup(grid: OccupancyGrid, points: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel occupancy of ``points`` (..., 3): True where the field
    must be evaluated, and outside the box."""
    flat, inside = _voxel(grid, points)
    return torch.where(inside, grid.occ[flat] > 0.5, torch.ones_like(inside))


def sigma_lookup(grid: OccupancyGrid, points: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel dilated sigma; ``grid.thresh`` outside the box (unknown
    space stays sampleable without outweighing surface voxels)."""
    flat, inside = _voxel(grid, points)
    return torch.where(inside, grid.sig[flat], grid.thresh)


def probe_lookup(grid: OccupancyGrid,
                 points: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Occupancy and sigma from one gather a point: equal to
    ``(occupancy_lookup, sigma_lookup)``, since the occupancy is the dilated
    sigma over the threshold; sigma is None for a grid without ``sig``."""
    flat, inside = _voxel(grid, points)
    if grid.sig is None:
        return torch.where(inside, grid.occ[flat] > 0.5, torch.ones_like(inside)), None
    sig = grid.sig[flat]
    return (torch.where(inside, sig > grid.thresh, torch.ones_like(inside)),
            torch.where(inside, sig, grid.thresh))


def occupancy_fraction(grid: OccupancyGrid) -> float:
    """Fraction of occupied voxels (a host read)."""
    return float(grid.occ.mean())
