"""Ray samplers: stratified coarse, inverse-CDF importance, depth-centered.

Rays are (B, 8) = [origin(3), direction(3), near(1), far(1)].  Every random
draw can be passed in (``u``, ``jitter``, ``noise``) so a test can feed the
same numbers the JAX package drew; otherwise it comes from ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _uniform(shape, generator, device, given: Optional[torch.Tensor]) -> torch.Tensor:
    if given is not None:
        return given.to(device=device, dtype=torch.float32)
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def _normal(shape, generator, device, given: Optional[torch.Tensor]) -> torch.Tensor:
    if given is not None:
        return given.to(device=device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def sample_coarse(rays: torch.Tensor, n_coarse: int, generator=None, lindisp: bool = False,
                  jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One uniform jitter inside each of ``n_coarse`` equal bins of
    [near, far] (or of [1/near, 1/far] if lindisp).

    :param jitter: (B, n_coarse) uniforms in [0, 1), drawn when None
    :return: (B, n_coarse) z values
    """
    B = rays.shape[0]
    near, far = rays[:, -2:-1], rays[:, -1:]
    step = 1.0 / n_coarse
    z_steps = torch.linspace(0.0, 1.0 - step, n_coarse, device=rays.device)[None]
    z_steps = z_steps + _uniform((B, n_coarse), generator, rays.device, jitter) * step
    if not lindisp:
        return near * (1.0 - z_steps) + far * z_steps
    return 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)


def sample_fine(rays: torch.Tensor, weights: torch.Tensor, n_fine: int, n_coarse: int,
                generator=None, lindisp: bool = False, u: Optional[torch.Tensor] = None,
                jitter: Optional[torch.Tensor] = None, stratified: bool = False) -> torch.Tensor:
    """Importance samples by inverting the CDF of the coarse weights.

    :param weights: (B, Kc) coarse compositing weights (no gradient)
    :param u, jitter: (B, n_fine) uniforms (the CDF level, then the jitter
        inside the chosen bin), drawn in that order when None
    :param stratified: the CDF levels are one jittered point per 1/n_fine
        quantile, ``(k + u) / n_fine``, instead of the iid ``u`` (the
        grid-proposal render's draw); ``u`` is then the raw jitter
    :return: (B, n_fine) z values
    """
    B = rays.shape[0]
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)  # (B, Kc): the bin upper edges
    u = _uniform((B, n_fine), generator, rays.device, u)
    if stratified:
        u = (torch.arange(n_fine, dtype=torch.float32, device=rays.device)[None] + u) / n_fine
    # count of bins whose upper CDF edge is <= u: searchsorted(side="right"),
    # the index the JAX package's compare-and-sum gives
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True).float()
    z_steps = (inds + _uniform((B, n_fine), generator, rays.device, jitter)) / n_coarse
    near, far = rays[:, -2:-1], rays[:, -1:]
    if not lindisp:
        return near * (1.0 - z_steps) + far * z_steps
    return 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)


def sample_fine_depth(rays: torch.Tensor, depth: torch.Tensor, n_fine_depth: int,
                      depth_std: float, generator=None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian samples around the expected depth, clamped to [near, far].

    :param depth: (B,) expected depth from the coarse pass
    :param noise: (B, n_fine_depth) standard normals, drawn when None
    """
    B = rays.shape[0]
    z = depth[:, None].expand(B, n_fine_depth)
    z = z + _normal((B, n_fine_depth), generator, rays.device, noise) * depth_std
    return torch.minimum(torch.maximum(z, rays[:, -2:-1]), rays[:, -1:])
