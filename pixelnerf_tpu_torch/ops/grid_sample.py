"""Pixel-aligned feature sampling: bilinear taps, the plain 4-tap gather and
the resizes the encoder uses.  Feature maps are NHWC, as in the JAX package.

Semantics follow ``torch.nn.functional.grid_sample`` with
``align_corners=True`` and padding border / zeros / reflection.
"""

from __future__ import annotations

import numpy as np
import torch


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """[-1, 1] -> pixel coordinates."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Reflect coordinates into [lo, hi] (torch 'reflection', align_corners=True)."""
    if lo == hi:
        return torch.zeros_like(x)
    span = hi - lo
    x = torch.remainder(torch.abs(x - lo), 2 * span)
    return hi - torch.abs(x - span)


def bilinear_taps(
    uv: torch.Tensor,
    height: int,
    width: int,
    align_corners: bool = True,
    padding_mode: str = "border",
    pad_taps_to: int = 0,
):
    """Decompose a bilinear grid_sample into its 4 (index, weight) taps:
    ``sample = sum_j w[..., j] * flat_feat[idx[..., j]]`` with
    ``flat_feat = feat.reshape(H*W, C)``.

    :param uv: (..., 2) sample points in [-1, 1]
    :return: (idx (..., 4 or pad_taps_to) int32, w (..., same) f32)
    """
    H, W = height, width
    x = _unnormalize(uv[..., 0].float(), W, align_corners)
    y = _unnormalize(uv[..., 1].float(), H, align_corners)
    # points projected from near a source camera's z=0 plane give uv -> inf
    x = torch.nan_to_num(x, nan=-2.0, posinf=1e7, neginf=-1e7)
    y = torch.nan_to_num(y, nan=-2.0, posinf=1e7, neginf=-1e7)

    if padding_mode == "reflection":
        x = _reflect(x, 0.0, float(W - 1))
        y = _reflect(y, 0.0, float(H - 1))
    else:
        # clamp just outside the valid range: keeps border-clamp and
        # zeros-mask semantics, and floor()/wx exact for huge coordinates
        x = torch.clamp(x, -2.0, W + 1.0)
        y = torch.clamp(y, -2.0, H + 1.0)

    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    x1 = x0 + 1
    y1 = y0 + 1

    x0c = x0.clamp(0, W - 1)
    x1c = x1.clamp(0, W - 1)
    y0c = y0.clamp(0, H - 1)
    y1c = y1.clamp(0, H - 1)

    w00 = (1 - wx) * (1 - wy)
    w01 = wx * (1 - wy)
    w10 = (1 - wx) * wy
    w11 = wx * wy
    if padding_mode == "zeros":
        in_x0 = ((x0 >= 0) & (x0 <= W - 1)).float()
        in_x1 = ((x1 >= 0) & (x1 <= W - 1)).float()
        in_y0 = ((y0 >= 0) & (y0 <= H - 1)).float()
        in_y1 = ((y1 >= 0) & (y1 <= H - 1)).float()
        w00 = w00 * in_x0 * in_y0
        w01 = w01 * in_x1 * in_y0
        w10 = w10 * in_x0 * in_y1
        w11 = w11 * in_x1 * in_y1

    idx_list = [y0c * W + x0c, y0c * W + x1c, y1c * W + x0c, y1c * W + x1c]
    w_list = [w00, w01, w10, w11]
    if pad_taps_to > 4:
        # zero-weight padding taps contribute nothing
        idx_list += [torch.zeros_like(idx_list[0])] * (pad_taps_to - 4)
        w_list += [torch.zeros_like(w_list[0])] * (pad_taps_to - 4)
    return torch.stack(idx_list, dim=-1).to(torch.int32), torch.stack(w_list, dim=-1)


def _gather_taps_plain(flat: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    out = None
    for j in range(idx.shape[-1]):
        ij = idx[..., j].long()
        v = torch.gather(flat, 1, ij[..., None].expand(-1, -1, flat.shape[-1]))
        v = v * w[..., j][..., None].to(flat.dtype)
        out = v if out is None else out + v
    return out


class _GatherTaps(torch.autograd.Function):
    """The JAX package's ``gather_taps`` custom VJP: the tap weights get a
    zero cotangent (uv is a camera projection of data in every recipe), and
    the table gradient is a scatter-add accumulated in f32, cast to the
    table's dtype at the end (under AMP a bf16 table would otherwise sum many
    thousands of contributions per row in bf16)."""

    @staticmethod
    def forward(ctx, flat, idx, w):
        ctx.save_for_backward(idx, w)
        ctx.table = (flat.shape, flat.dtype)
        return _gather_taps_plain(flat, idx, w)

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        (B, T, C), dtype = ctx.table
        g = g.float()
        d_flat = torch.zeros(B * T, C, device=g.device, dtype=torch.float32)
        base = (torch.arange(B, device=g.device) * T)[:, None]
        for j in range(idx.shape[-1]):
            rows = (idx[..., j].long() + base).reshape(-1)
            d_flat.index_add_(0, rows, (g * w[..., j : j + 1].float()).reshape(-1, C))
        return d_flat.reshape(B, T, C).to(dtype), None, torch.zeros_like(w)


def gather_taps(flat: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted tap gather ``out[b,n] = sum_j w[b,n,j] * flat[b, idx[b,n,j]]``
    in ``flat``'s dtype (a bf16 table gives a bf16 sample stream); its
    backward is :class:`_GatherTaps`.

    :param flat: (B, T, C); idx, w: (B, N, taps) -> (B, N, C)
    """
    return _GatherTaps.apply(flat, idx, w)


def resize_nearest(feat: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize with ``F.interpolate(mode="nearest")`` semantics:
    ``src = floor(dst * in / out)`` per axis.  feat: (B, H, W, C)."""
    B, H, W, C = feat.shape
    rows = np.minimum((np.arange(out_h) * H) // out_h, H - 1)
    cols = np.minimum((np.arange(out_w) * W) // out_w, W - 1)
    rows = torch.from_numpy(rows).to(feat.device)
    cols = torch.from_numpy(cols).to(feat.device)
    return feat[:, rows][:, :, cols]


def _align_corners_interp_matrix(out_n: int, in_n: int) -> np.ndarray:
    M = np.zeros((out_n, in_n), np.float32)
    if in_n == 1 or out_n == 1:
        M[:, 0] = 1.0
        return M
    pos = np.arange(out_n, dtype=np.float64) * (in_n - 1) / (out_n - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, in_n - 1)
    hi = np.minimum(lo + 1, in_n - 1)
    w = (pos - lo).astype(np.float32)
    M[np.arange(out_n), lo] += 1.0 - w
    M[np.arange(out_n), hi] += w
    return M


def resize_bilinear_align_corners(feat: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True (= ``F.interpolate``
    ``align_corners=True``), in the separable form of two small
    interpolation-matrix products.  feat: (B, H, W, C)."""
    B, H, W, C = feat.shape
    R = torch.from_numpy(_align_corners_interp_matrix(out_h, H)).to(feat.device, feat.dtype)
    Cm = torch.from_numpy(_align_corners_interp_matrix(out_w, W)).to(feat.device, feat.dtype)
    out = torch.einsum("hH,bHWc->bhWc", R, feat)
    return torch.einsum("wW,bhWc->bhwc", Cm, out)
