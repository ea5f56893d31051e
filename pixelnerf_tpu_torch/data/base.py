"""Dataset protocol and the adapters' shared helpers (numpy only): image and
mask loading, bbox from a mask, camera decomposition.

Sample contract: images (NV, H, W, 3) float32 in [-1, 1] (NHWC), poses
(NV, 4, 4) camera-to-world (x right, y up, z out), masks (NV, H, W, 1), bbox
(NV, 4) as [cmin, rmin, cmax, rmax].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.png import read_png
from .resize import resize_area, resize_nearest

# CV camera (x right, y down, z forward) <-> GL camera (x right, y up, z back)
CV_TO_GL = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


def load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Load an image -> (H, W, 3) float32 in [-1, 1]; gray is repeated to RGB,
    RGBA is composited over white, and ``size`` (H, W) resizes by area."""
    img = read_png(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        # composite alpha over white (NMR renders white-background RGBA)
        alpha = img[..., 3:4].astype(np.float32) / 255.0
        rgb = img[..., :3].astype(np.float32) / 255.0
        img = rgb * alpha + (1.0 - alpha)
    else:
        img = img[..., :3].astype(np.float32) / 255.0
    if size is not None and img.shape[:2] != size:
        img = resize_area(img, size)
    return img * 2.0 - 1.0


def load_mask(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Load a binary mask -> (H, W, 1) float32 in [0, 1]: the alpha of an
    RGBA file, else its first channel; ``size`` resizes to the nearest pixel."""
    m = read_png(path)
    if m.ndim == 3:
        m = m[..., -1] if m.shape[-1] == 4 else m[..., 0]
    m = m.astype(np.float32) / 255.0
    if size is not None and m.shape[:2] != size:
        m = resize_nearest(m, size)
    return m[..., None]


def mask_to_bbox(mask: np.ndarray, thresh: float = 0.5) -> np.ndarray:
    """Tight foreground bbox [cmin, rmin, cmax, rmax]."""
    m = mask[..., 0] if mask.ndim == 3 else mask
    rows = np.any(m > thresh, axis=1)
    cols = np.any(m > thresh, axis=0)
    if not rows.any():
        h, w = m.shape
        return np.array([0, 0, w - 1, h - 1], dtype=np.float32)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return np.array([cmin, rmin, cmax, rmax], dtype=np.float32)


def mask_from_white_background(img: np.ndarray, thresh: float = 0.996) -> np.ndarray:
    """Foreground mask of a white-background render; img in [-1, 1]."""
    white = np.all(img > (thresh * 2.0 - 1.0), axis=-1)
    return (~white).astype(np.float32)[..., None]


def _rq3(M: np.ndarray):
    """RQ decomposition of a 3x3 matrix, M = K R, K upper triangular with a
    positive diagonal and R orthogonal (QR of the row-reversed transpose)."""
    J = np.eye(3)[::-1]
    Q, U = np.linalg.qr((J @ M).T)
    K, R = J @ U.T @ J, J @ Q.T
    S = np.diag(np.sign(np.diag(K)))
    return K @ S, S @ R


def decompose_projection(P: np.ndarray):
    """Decompose a 3x4 CV projection matrix P = s K [R|t] into (K, c2w_gl).

    Returns the intrinsics K (3, 3, normalized so K[2, 2] = 1) and the 4x4
    camera-to-world matrix in the GL convention.  The projective scale s may
    be negative (real DTU world_mats have arbitrary projective scale): K keeps
    a positive diagonal and R is made a proper rotation; the camera centre,
    P's null space, does not depend on s."""
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    K, R = _rq3(P[:, :3])
    if np.linalg.det(R) < 0:
        R = -R
    K = (K / K[2, 2]).astype(np.float32)
    t_h = np.linalg.svd(np.vstack([P, np.zeros((1, 4))]))[2][3]
    center = (t_h[:3] / t_h[3]).astype(np.float32)
    # R is the world->camera rotation of the CV camera
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R.astype(np.float32)
    w2c[:3, 3] = -R.astype(np.float32) @ center
    c2w_cv = np.linalg.inv(w2c)
    return K, (c2w_cv @ CV_TO_GL).astype(np.float32)


class BaseDataset:
    """Minimal dataset protocol: __len__, __getitem__ -> dict of numpy arrays,
    plus the attributes the renderer reads: z_near, z_far, lindisp."""

    z_near: float = 0.8
    z_far: float = 1.8
    lindisp: bool = False

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> dict:
        raise NotImplementedError
