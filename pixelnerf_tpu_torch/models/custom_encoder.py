"""ConvEncoder: the small U-Net-style convolutional encoder (``encoder.type =
conv``), the JAX package's ``models/custom_encoder.py``.

A 7x7/2 stem, ``n_down_layers`` stride-2 3x3 convolutions doubling the
channels, a 4x4/4 bottleneck whose output is flattened and broadcast back
over the deepest grid, then transposed 3x3/2 convolutions with skip
connections, and a last transposed convolution to ``last_layer_chnls``
channels at 16 * ceil(H / 16) x 16 * ceil(W / 16).  GroupNorm
(``min(32, C)`` groups, flax's eps 1e-6) and LeakyReLU (slope 0.01).  Maps
are NHWC at the surface, NCHW inside.

Flax pads ``"SAME"`` as XLA does, which is not PyTorch's ``k // 2``:

* a convolution of stride s pads ``max((ceil(n / s) - 1) s + k - n, 0)``
  in all, the smaller half first (:func:`same_pad`);
* a transposed convolution (``lax.conv_transpose``, kernel not flipped)
  dilates its input by s and pads ``(pad_a, pad_b)`` before a plain
  correlation with the kernel (:func:`conv_transpose_same`: here
  ``F.conv_transpose2d`` with the kernel flipped and its channels swapped,
  cropped to that padding).

Every kernel is stored in the ``Conv2d`` layout ``(out, in, kh, kw)``,
transposed convolutions included, so JAX kernels ``(kh, kw, in, out)`` cross
by one rule (:func:`..utils.jax_convert.from_jax_variables`).

The bottleneck flattens (h, w, C) in NHWC order, so ``deconv{n-1}`` takes
one ``mid_layer_chnls`` a bottleneck cell, ceil(H / 64) * ceil(W / 64)
cells: one up to 64 px images, as built.  Loading a state dict whose
``deconv{n-1}`` is wider takes its width, as the JAX module takes the width
of the images it was built on.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grid_sample import grid_sample


def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (before, after) of one axis of n for a k-wide
    window at stride s."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_transpose_pad(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s (before, after) padding of the dilated input
    for ``"SAME"``."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return pad_a, pad_len - pad_a


def conv_same(x: torch.Tensor, weight: torch.Tensor, stride: int, bias=None) -> torch.Tensor:
    """Flax ``Conv(padding="SAME")`` on NCHW ``x``, weight (O, I, kh, kw)."""
    kh, kw = weight.shape[2:]
    ph, pw = same_pad(x.shape[2], kh, stride), same_pad(x.shape[3], kw, stride)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), weight, bias, stride=stride)


def conv_transpose_same(x: torch.Tensor, weight: torch.Tensor, stride: int,
                        bias=None) -> torch.Tensor:
    """Flax ``ConvTranspose(padding="SAME")`` on NCHW ``x``, weight (O, I,
    kh, kw): the correlation of the kernel with the stride-dilated input
    padded by :func:`conv_transpose_pad`.  ``F.conv_transpose2d`` pads k - 1
    on each side and flips its kernel, so it gets the kernel flipped with in
    and out swapped, and its output is cropped to the padding wanted."""
    kh, kw = weight.shape[2:]
    wt = torch.flip(weight, dims=(2, 3)).transpose(0, 1)
    y = F.conv_transpose2d(x, wt, bias, stride=stride)
    (ah, bh), (aw, bw) = conv_transpose_pad(kh, stride), conv_transpose_pad(kw, stride)
    return y[:, :, kh - 1 - ah: y.shape[2] - (kh - 1 - bh), kw - 1 - aw: y.shape[3] - (kw - 1 - bw)]


class _Conv(nn.Module):
    """A kernel (and bias) in the Conv2d layout, applied with flax's SAME
    padding as a convolution or a transposed convolution."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, transpose: bool = False,
                 bias: bool = False):
        super().__init__()
        self.stride, self.transpose = stride, transpose
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        fn = conv_transpose_same if self.transpose else conv_same
        return fn(x, self.weight, self.stride, self.bias)


class ConvEncoder(nn.Module):
    def __init__(self, dim_in: int = 3, use_leaky_relu: bool = True, use_skip_conn: bool = True,
                 first_layer_chnls: int = 64, mid_layer_chnls: int = 128,
                 last_layer_chnls: int = 128, n_down_layers: int = 3):
        super().__init__()
        self.use_leaky_relu, self.use_skip_conn = use_leaky_relu, use_skip_conn
        self.first_layer_chnls, self.mid_layer_chnls = first_layer_chnls, mid_layer_chnls
        self.last_layer_chnls, self.n_down_layers = last_layer_chnls, n_down_layers
        self.use_multi_scale = False  # SpatialEncoder's interface
        self.conv_in = _Conv(dim_in, first_layer_chnls, 7, 2)
        self.norm_in = self._gn(first_layer_chnls)
        ch = first_layer_chnls
        for i in range(n_down_layers):
            setattr(self, f"conv{i}", _Conv(ch, 2 * ch, 3, 2))
            setattr(self, f"norm{i}", self._gn(2 * ch))
            ch *= 2
        self.conv_mid = _Conv(ch, mid_layer_chnls, 4, 4)
        self.norm_mid = self._gn(mid_layer_chnls)
        cin = mid_layer_chnls  # one bottleneck cell
        for i in reversed(range(n_down_layers)):
            skip = first_layer_chnls * 2 ** (i + 1) if use_skip_conn else 0
            out_ch = first_layer_chnls * 2 ** i
            setattr(self, f"deconv{i}", _Conv(cin + skip, out_ch, 3, 2, transpose=True))
            setattr(self, f"denorm{i}", self._gn(out_ch))
            cin = out_ch
        self.deconv_last = _Conv(cin, last_layer_chnls, 3, 2, transpose=True, bias=True)

    @staticmethod
    def _gn(ch: int) -> nn.GroupNorm:
        return nn.GroupNorm(min(32, ch), ch, eps=1e-6)

    @property
    def latent_size(self) -> int:
        return self.last_layer_chnls

    @property
    def latent_sizes(self) -> List[int]:
        return [self.last_layer_chnls]

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the bottleneck's width follows the images the weights were made
        # for (the JAX module's follows the images it was built on)
        key = f"{prefix}deconv{self.n_down_layers - 1}.weight"
        layer = getattr(self, f"deconv{self.n_down_layers - 1}")
        if key in state_dict and state_dict[key].shape[1] != layer.weight.shape[1]:
            w = state_dict[key]
            layer.weight = nn.Parameter(torch.empty(w.shape, device=layer.weight.device,
                                                    dtype=layer.weight.dtype))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:param x: (B, H, W, 3) -> (B, 16 ceil(H/16), 16 ceil(W/16), last_layer_chnls)"""
        act = F.leaky_relu if self.use_leaky_relu else F.relu
        x = act(self.norm_in(self.conv_in(x.permute(0, 3, 1, 2))))
        inters = []
        for i in range(self.n_down_layers):
            x = act(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x)))
            inters.append(x)
        x = act(self.norm_mid(self.conv_mid(x)))
        # the bottleneck flattened in (h, w, C) order, broadcast over the deepest grid
        B = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(B, -1, 1, 1)
        x = x.expand(B, x.shape[1], inters[-1].shape[2], inters[-1].shape[3])
        for i in reversed(range(self.n_down_layers)):
            if self.use_skip_conn:
                x = torch.cat([x, inters[i]], dim=1)
            x = act(getattr(self, f"denorm{i}")(getattr(self, f"deconv{i}")(x)))
        return self.deconv_last(x).permute(0, 2, 3, 1)

    def index(self, latents: torch.Tensor, uv: torch.Tensor, image_shape) -> torch.Tensor:
        """Pixel-aligned bilinear sampling with border padding, uv
        normalized against the input image (SpatialEncoder.index's
        contract)."""
        w_img, h_img = image_shape
        h_l, w_l = latents.shape[1], latents.shape[2]
        gx = uv[..., 0] * (w_l / w_img) * (2.0 / max(w_l - 1, 1)) - 1.0
        gy = uv[..., 1] * (h_l / h_img) * (2.0 / max(h_l - 1, 1)) - 1.0
        return grid_sample(latents, torch.stack([gx, gy], dim=-1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: LeCun-normal kernels (fan-in), zero bias, unit /
        zero GroupNorm."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, _Conv):
                    fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                    m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                                   * (1.0 / fan_in) ** 0.5)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    @classmethod
    def from_conf(cls, conf) -> "ConvEncoder":
        return cls(dim_in=conf.get_int("dim_in", 3),
                   use_leaky_relu=conf.get_bool("use_leaky_relu", True),
                   use_skip_conn=conf.get_bool("use_skip_conn", True))
