"""ImplicitNet (``type = mlp``), the IGR-style field MLP: the JAX package's
``models/mlp.py``.

Configurable hidden widths, the input re-injected at the ``skip_in`` layers
below ``combine_layer`` (concatenated, then scaled by 1/sqrt(2)), the
multi-view combination at ``combine_layer``, ReLU or softplus(beta), and
the geometric SDF init: the last layer's first output column at
-sqrt(pi / fan_in) * sdf_scale with bias ``radius_init``, and the
positional-code input columns zeroed at layer 0 and at the skip layers.
Its layers are ``lin{i}`` (``nn.Linear``).  It has no kernel: it runs as
PyTorch ops on every device, in its parameters' dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resnetfc_fused import materialize_parts
from ..utils.geometry import combine_interleaved


class ImplicitNet(nn.Module):
    def __init__(self, d_in: int, dims: Sequence[int], skip_in: Sequence[int] = (),
                 d_out: int = 4, geometric_init: bool = True, radius_init: float = 0.3,
                 beta: float = 0.0, output_init_gain: float = 2.0, num_position_inputs: int = 3,
                 sdf_scale: float = 1.0, dim_excludes_skip: bool = False,
                 combine_layer: int = 1000, combine_type: str = "average"):
        super().__init__()
        self.d_in, self.d_out, self.skip_in = d_in, d_out, tuple(skip_in)
        self.geometric_init, self.radius_init, self.beta = geometric_init, radius_init, beta
        self.output_init_gain, self.num_position_inputs = output_init_gain, num_position_inputs
        self.sdf_scale = sdf_scale
        self.combine_layer, self.combine_type = combine_layer, combine_type
        dims = [d_in] + list(dims) + [d_out]
        if dim_excludes_skip:
            for i in range(1, len(dims) - 1):
                if i in self.skip_in:
                    dims[i] += d_in
        self.n_layers = len(dims) - 1
        width = d_in
        for layer in range(self.n_layers):
            if layer < combine_layer and layer in self.skip_in:
                width += d_in
            out = dims[layer + 1] - d_in if layer + 1 in self.skip_in else dims[layer + 1]
            setattr(self, f"lin{layer}", nn.Linear(width, out))
            width = out

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init from ``generator``: geometric (or Kaiming fan-in
        normal with zero bias when ``geometric_init`` is off)."""
        with torch.no_grad():
            for layer in range(self.n_layers):
                lin = getattr(self, f"lin{layer}")
                out_dim, in_dim = lin.weight.shape
                lin.bias.zero_()
                if not self.geometric_init:
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator)
                                     * (2.0 / in_dim) ** 0.5)
                elif layer == self.n_layers - 1:
                    mean0 = -math.sqrt(math.pi) / math.sqrt(in_dim) * self.sdf_scale
                    w = self.output_init_gain * torch.randn(lin.weight.shape, generator=generator)
                    w[0] = mean0 + 1e-5 * torch.randn(in_dim, generator=generator)
                    lin.weight.copy_(w)
                    lin.bias[0] = self.radius_init
                else:
                    w = math.sqrt(2.0) / math.sqrt(out_dim) * torch.randn(
                        lin.weight.shape, generator=generator)
                    if self.d_in > self.num_position_inputs and (layer == 0 or layer in self.skip_in):
                        w[:, in_dim - (self.d_in - self.num_position_inputs):] = 0.0
                    lin.weight.copy_(w)

    def forward(self, x, combine_inner_dims: Sequence[int] = (1,), planar_out: bool = False):
        """:param x: (..., d_in), or a tuple ``(z, x)`` (the latent first; either
            may be deferred, as ResnetFC takes them)
        :return: (..., d_out), or (..., d_out, N) when ``planar_out``"""
        if type(x) is tuple:
            z, x = materialize_parts(*x)
            if z is not None:
                x = torch.cat([z, x], dim=-1)
        x = x.to(self.lin0.weight.dtype)  # inputs promote to the parameters' dtype, as flax Dense's
        act = (lambda v: F.softplus(v * self.beta) / self.beta) if self.beta > 0 else F.relu
        x_init = x
        for layer in range(self.n_layers):
            if layer == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims, self.combine_type)
                x_init = combine_interleaved(x_init, combine_inner_dims, self.combine_type)
            if layer < self.combine_layer and layer in self.skip_in:
                x = torch.cat([x, x_init], dim=-1) / math.sqrt(2.0)
            x = getattr(self, f"lin{layer}")(x)
            if layer < self.n_layers - 1:
                x = act(x)
        return x.transpose(-1, -2) if planar_out else x

    @classmethod
    def from_conf(cls, conf, d_in: int, **kwargs) -> "ImplicitNet":
        return cls(d_in, conf.get_list("dims"), skip_in=tuple(conf.get_list("skip_in", [])),
                   beta=conf.get_float("beta", 0.0),
                   dim_excludes_skip=conf.get_bool("dim_excludes_skip", False),
                   combine_layer=conf.get_int("combine_layer", 1000),
                   combine_type=conf.get_string("combine_type", "average"), **kwargs)
