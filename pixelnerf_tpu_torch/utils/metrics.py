"""Image quality metrics, as the JAX package computes them (numpy and scipy).

PSNR matches the reference ``util.psnr``.  SSIM follows
``skimage.metrics.structural_similarity``'s defaults (7x7 uniform window,
K1 = 0.01, K2 = 0.03, sample covariance), averaged over channels, which is
what the eval CLI reports.  ``cmap`` is OpenCV's HOT colormap as a numpy
table.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def psnr(pred: np.ndarray, target: np.ndarray) -> float:
    """PSNR in dB of arrays in [0, 1]."""
    mse = float(np.mean((np.asarray(pred) - np.asarray(target)) ** 2))
    if mse == 0:
        return float("inf")
    return -10.0 * math.log10(mse)


def ssim(img0: np.ndarray, img1: np.ndarray, data_range: float = 1.0, win_size: int = 7,
         K1: float = 0.01, K2: float = 0.03, channel_axis: Optional[int] = -1) -> float:
    """Structural similarity; a multichannel image is the mean over its
    channels.  The local means are scipy's reflecting uniform filter, and
    the border of half a window is cropped, as skimage does."""
    from scipy.ndimage import uniform_filter

    img0 = np.asarray(img0, dtype=np.float64)
    img1 = np.asarray(img1, dtype=np.float64)
    if channel_axis is not None and img0.ndim == 3:
        return float(np.mean([
            ssim(np.take(img0, c, axis=channel_axis), np.take(img1, c, axis=channel_axis),
                 data_range=data_range, win_size=win_size, K1=K1, K2=K2, channel_axis=None)
            for c in range(img0.shape[channel_axis])
        ]))

    def mean(a):
        return uniform_filter(a, size=win_size, mode="reflect")

    n = win_size ** img0.ndim
    cov_norm = n / (n - 1)  # sample covariance
    ux, uy = mean(img0), mean(img1)
    vx = cov_norm * (mean(img0 * img0) - ux * ux)
    vy = cov_norm * (mean(img1 * img1) - uy * uy)
    vxy = cov_norm * (mean(img0 * img1) - ux * uy)
    C1, C2 = (K1 * data_range) ** 2, (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    return float(S[tuple(slice(pad, s - pad) for s in S.shape)].mean())


def image_float_to_uint8(img: np.ndarray) -> np.ndarray:
    """Min-max normalize a float image to uint8."""
    img = np.asarray(img, dtype=np.float32)
    vmin, vmax = float(np.min(img)), float(np.max(img))
    if vmax - vmin < 1e-10:
        vmax += 1e-10
    return ((img - vmin) / (vmax - vmin) * 255.0).astype(np.uint8)


def _hot_table() -> np.ndarray:
    """OpenCV's ``COLORMAP_HOT`` as a (256, 3) uint8 RGB table, built as
    OpenCV builds it: 64 control points at ``linspace(0, 1, 64)`` (red
    ``2.5x``, green ``2.5x - 1``, blue ``5x - 4``, each clipped to [0, 1]),
    linearly interpolated in float32 to 256 levels and rounded half to
    even after the scale by 255."""
    def linspace(n):  # OpenCV's float32 x0 + i * step
        return np.arange(n, dtype=np.float32) * np.float32(np.float32(1.0) / np.float32(n - 1))

    X, xi = linspace(64), linspace(256)
    x = np.arange(64, dtype=np.float64) / 63
    ctrl = np.clip(np.stack([2.5 * x, 2.5 * x - 1, 5 * x - 4], axis=1), 0, 1).astype(np.float32)
    hi = np.clip(np.searchsorted(X, xi, side="left"), 1, 63)
    lo = hi - 1
    y0, y1 = ctrl[lo], ctrl[hi]
    num = ((xi - X[lo])[:, None] * (y1 - y0)).astype(np.float32)
    out = y0 + num / (X[hi] - X[lo])[:, None]
    return np.clip(np.rint(out * np.float32(255.0)), 0, 255).astype(np.uint8)


HOT = _hot_table()
HOT.flags.writeable = False


def cmap(img: np.ndarray) -> np.ndarray:
    """The HOT colormap of a float image -> (H, W, 3) uint8 RGB: what
    ``cv2.applyColorMap(image_float_to_uint8(img), cv2.COLORMAP_HOT)`` gives,
    with its channels flipped to RGB (for depth images).  A 3-channel image
    is first taken to gray as OpenCV takes BGR to gray (15-bit fixed point,
    channel 0 as blue)."""
    u8 = image_float_to_uint8(img)
    if u8.ndim == 3 and u8.shape[-1] == 3:
        b, g, r = (u8[..., i].astype(np.int64) for i in range(3))
        u8 = (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15
    elif u8.ndim == 3 and u8.shape[-1] == 1:
        u8 = u8[..., 0]
    return HOT[u8]
