"""Image resizing as OpenCV's ``cv2.resize`` computes it, in numpy.

``resize_area`` is ``INTER_AREA`` and ``resize_nearest`` is
``INTER_NEAREST`` on float32 (H, W) and (H, W, C) arrays; ``size`` is the
output's (H, W).  ``INTER_AREA`` is two different maps:

- shrinking on both axes averages each output pixel's footprint, a cell
  of in/out input pixels with fractional weights at its ends;
- otherwise (enlarging on either axis) each output pixel is a 2-tap
  interpolation whose weight is the part of the output pixel past the
  last input edge it crosses: at an integer factor that weight is 0 and the
  map replicates pixels, as nearest does.

Both are separable: a weight matrix for the rows and one for the columns.

``resize_bilinear_pil`` is Pillow's ``Image.resize(..., BILINEAR)`` on
uint8 RGB, bit for bit: its triangle filter, its fixed-point weights and
its u8 rounding after each of its two passes."""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=64)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) footprint weights of a shrink (n_out <= n_in); cached,
    and read-only for that."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += np.float32((s1 - f1) / cell)
        w[d, s1:s2] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] += np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    w.flags.writeable = False
    return w


def _linear_taps(n_in: int, n_out: int):
    """First tap and the second tap's weight (float32) of each output pixel
    of the non-shrinking map."""
    inv_scale = n_out / n_in
    scale = 1.0 / inv_scale
    sx = np.empty(n_out, np.int64)
    fx = np.empty(n_out, np.float32)
    for d in range(n_out):
        s = math.floor(d * scale)
        f = float(np.float32((d + 1) - (s + 1) * inv_scale))
        f = 0.0 if f <= 0 else f - math.floor(f)
        if s < 0:
            s, f = 0, 0.0
        if s >= n_in - 1:
            s, f = n_in - 1, 0.0
        sx[d], fx[d] = s, f
    return sx, fx


def _check(img: np.ndarray, size) -> Tuple[np.ndarray, int, int]:
    img = np.asarray(img)
    if img.ndim not in (2, 3) or 0 in img.shape[:2]:
        raise ValueError(f"resize takes an (H, W) or (H, W, C) image, got {img.shape}")
    Ho, Wo = int(size[0]), int(size[1])
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"resize to a size with no pixels: {size}")
    return img.astype(np.float32, copy=False), Ho, Wo


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (size[1], size[0]), interpolation=cv2.INTER_AREA)``
    on a float32 (H, W) or (H, W, C) array -> float32 (size[0], size[1], ...)."""
    img, Ho, Wo = _check(img, size)
    H, W = img.shape[:2]
    if (Ho, Wo) == (H, W):
        return img.copy()
    if Ho <= H and Wo <= W:
        wy, wx = _area_weights(H, Ho), _area_weights(W, Wo)
        out = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))
        out = np.moveaxis(np.tensordot(wx, out, axes=(1, 1)), 0, 1)
        return out.astype(np.float32)
    sx, fx = _linear_taps(W, Wo)
    sy, fy = _linear_taps(H, Ho)
    sx1, sy1 = np.minimum(sx + 1, W - 1), np.minimum(sy + 1, H - 1)
    fx = fx.reshape((-1,) + (1,) * (img.ndim - 2))  # broadcast over channels
    fy = fy.reshape((-1,) + (1,) * (img.ndim - 1))
    rows = img[:, sx] * (1 - fx) + img[:, sx1] * fx
    return rows[sy] * (1 - fy) + rows[sy1] * fy


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (size[1], size[0]), interpolation=cv2.INTER_NEAREST)``:
    output pixel d takes input pixel floor(d * in / out)."""
    img, Ho, Wo = _check(img, size)
    H, W = img.shape[:2]
    iy = np.minimum(np.floor(np.arange(Ho) * (1.0 / (Ho / H))).astype(np.int64), H - 1)
    ix = np.minimum(np.floor(np.arange(Wo) * (1.0 / (Wo / W))).astype(np.int64), W - 1)
    return img[iy][:, ix].copy()


# Pillow's fixed-point resampling of 8-bit images: each coefficient is
# scaled by 2^22 and rounded, sums start at half a unit, results clip to u8
_PIL_PRECISION_BITS = 22


@functools.lru_cache(maxsize=64)
def _pil_bilinear_coeffs(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) int64 fixed-point weights of Pillow's BILINEAR filter:
    a triangle whose support widens by the ratio when shrinking, over the
    input pixels that Pillow's rounded bounds admit, renormalized a pixel."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support is 1
    w = np.zeros((n_out, n_in), np.int64)
    for d in range(n_out):
        center = (d + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        x = np.arange(lo, hi, dtype=np.float64)
        k = np.maximum(0.0, 1.0 - np.abs((x - center + 0.5) / filterscale))
        if k.sum() != 0.0:
            k = k / k.sum()
        w[d, lo:hi] = np.floor(0.5 + k * (1 << _PIL_PRECISION_BITS)).astype(np.int64)
    w.flags.writeable = False
    return w


def _pil_pass(img: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """One separable pass along ``axis`` of an int64 (H, W, C) image, rounded
    and clipped to u8 as Pillow does between and after its passes."""
    out = np.moveaxis(np.tensordot(w, img, axes=(1, axis)), 0, axis)
    return np.clip((out + (1 << (_PIL_PRECISION_BITS - 1))) >> _PIL_PRECISION_BITS, 0, 255)


def resize_bilinear_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((size[1], size[0]), Image.BILINEAR)``
    on a uint8 (H, W, 3) RGB image -> uint8 (size[0], size[1], 3): the
    horizontal pass first, each pass in Pillow's fixed point."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or 0 in img.shape[:2]:
        raise ValueError(f"resize_bilinear_pil takes an (H, W, C) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    Ho, Wo = int(size[0]), int(size[1])
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"resize to a size with no pixels: {size}")
    H, W = img.shape[:2]
    out = img.astype(np.int64)
    if Wo != W:
        out = _pil_pass(out, _pil_bilinear_coeffs(W, Wo), 1)
    if Ho != H:
        out = _pil_pass(out, _pil_bilinear_coeffs(H, Ho), 0)
    return out.astype(np.uint8)
