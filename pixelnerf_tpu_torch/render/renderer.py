"""NeRF volume renderer, dense path: coarse stratified samples, then the
sorted union of coarse, importance and depth-centered samples, composited
with ``alpha = 1 - exp(-delta * relu(sigma))``, the exclusive transmittance
cumprod with its 1e-10 guard and white-background completion.

Random draws come from a ``torch.Generator`` in the order the JAX
``render_rays`` splits its key: coarse jitter, coarse sigma noise, importance
(u, then jitter), depth noise, fine sigma noise.  Any of them can be passed in
through :class:`RayDraws` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from . import rays as ray_sampling

# model_fn(points (SB, P, 3), viewdirs (SB, P, 3) | None, coarse: bool)
#   -> (SB, 4, P) channel-major [r, g, b, sigma]
ModelFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_coarse: int = 128
    n_fine: int = 0
    n_fine_depth: int = 0
    noise_std: float = 0.0
    depth_std: float = 0.01
    eval_batch_size: int = 100000
    white_bkgd: bool = False
    lindisp: bool = False
    sched: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0

    @classmethod
    def from_conf(cls, conf, white_bkgd: bool = False, lindisp: bool = False,
                  eval_batch_size: int = 100000) -> "RenderConfig":
        sched = conf.get_list("sched", None)
        if sched is not None and len(sched) == 0:
            sched = None
        if sched is not None:
            sched = tuple(tuple(s) for s in sched)
        return cls(
            n_coarse=conf.get_int("n_coarse", 128),
            n_fine=conf.get_int("n_fine", 0),
            n_fine_depth=conf.get_int("n_fine_depth", 0),
            noise_std=conf.get_float("noise_std", 0.0),
            depth_std=conf.get_float("depth_std", 0.01),
            white_bkgd=bool(conf.get_float("white_bkgd", white_bkgd)),
            lindisp=conf.get_bool("lindisp", lindisp),
            eval_batch_size=conf.get_int("eval_batch_size", eval_batch_size),
            sched=sched,
        )


@dataclasses.dataclass
class RayDraws:
    """Random numbers for one :func:`render_rays` call over (SB * B) rays;
    a field left None is drawn from the generator."""

    coarse: Optional[torch.Tensor] = None  # (SB*B, n_coarse) uniform
    noise_coarse: Optional[torch.Tensor] = None  # (SB, B, n_coarse) normal, training only
    fine_u: Optional[torch.Tensor] = None  # (SB*B, n_importance) uniform
    fine_jitter: Optional[torch.Tensor] = None  # (SB*B, n_importance) uniform
    depth: Optional[torch.Tensor] = None  # (SB*B, n_fine_depth) normal
    noise_fine: Optional[torch.Tensor] = None  # (SB, B, K_fine) normal, training only


def _eval_model_chunked(model_fn: ModelFn, points, viewdirs, coarse: bool, chunk: int):
    """The field at P points per object, ``chunk`` points at a time."""
    SB, P, _ = points.shape
    if chunk <= 0 or P <= chunk:
        return model_fn(points, viewdirs, coarse)
    outs = [
        model_fn(points[:, s : s + chunk],
                 None if viewdirs is None else viewdirs[:, s : s + chunk], coarse)
        for s in range(0, P, chunk)
    ]
    return torch.cat(outs, dim=-1)


def composite(model_fn: ModelFn, rays: torch.Tensor, z_samp: torch.Tensor, cfg: RenderConfig,
              coarse: bool, generator=None, training: bool = False, use_viewdirs: bool = True,
              noise: Optional[torch.Tensor] = None, noise_scale=None):
    """Alpha-composite rgb/sigma along rays.

    :param rays: (SB, B, 8); z_samp: (SB, B, K)
    :param noise: (SB, B, K) sigma noise (training with noise_std > 0), drawn when None
    :param noise_scale: optional multiplier of the noise (a schedule's anneal)
    :return: (weights (SB, B, K), rgb (SB, B, 3), depth (SB, B))
    """
    SB, B, K = z_samp.shape
    deltas = z_samp[..., 1:] - z_samp[..., :-1]
    delta_inf = rays[..., -1:] - z_samp[..., -1:]
    deltas = torch.cat([deltas, delta_inf], dim=-1)

    points = rays[..., None, :3] + z_samp[..., None] * rays[..., None, 3:6]
    points = points.reshape(SB, B * K, 3)
    viewdirs = None
    if use_viewdirs:
        viewdirs = rays[..., None, 3:6].expand(SB, B, K, 3).reshape(SB, B * K, 3)

    chunk = cfg.eval_batch_size if not training else 0
    out = _eval_model_chunked(model_fn, points, viewdirs, coarse, chunk)
    out = out.reshape(SB, 4, B, K)

    rgbs = out[:, :3]
    sigmas = out[:, 3]
    if training and cfg.noise_std > 0.0:
        if noise is None:
            noise = torch.randn(sigmas.shape, generator=generator,
                                device=generator.device).to(sigmas.device)
        noise = noise * cfg.noise_std
        if noise_scale is not None:
            noise = noise * noise_scale
        sigmas = sigmas + noise

    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    alphas_shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-10], dim=-1
    )
    T = torch.cumprod(alphas_shifted, dim=-1)
    weights = alphas * T[..., :-1]

    rgb_final = torch.sum(weights[:, None] * rgbs, dim=-1).transpose(1, 2)  # (SB, B, 3)
    depth_final = torch.sum(weights * z_samp, dim=-1)
    if cfg.white_bkgd:
        pix_alpha = torch.sum(weights, dim=-1)
        rgb_final = rgb_final + (1.0 - pix_alpha[..., None])
    return weights, rgb_final, depth_final


def render_rays(model_fn: ModelFn, rays: torch.Tensor, cfg: RenderConfig, generator=None,
                draws: Optional[RayDraws] = None, want_weights: bool = False,
                training: bool = False, use_viewdirs: bool = True,
                noise_scale=None) -> Dict[str, dict]:
    """Full coarse + fine render of ``rays`` (SB, B, 8).  ``noise_scale``
    multiplies the training sigma noise of both passes.

    :return: {"coarse": {rgb, depth[, weights]}, "fine": {...}} ("fine" only
        when cfg.using_fine)
    """
    assert rays.ndim == 3
    SB, B, _ = rays.shape
    d = draws if draws is not None else RayDraws()
    flat_rays = rays.reshape(SB * B, 8)

    z_coarse = ray_sampling.sample_coarse(
        flat_rays, cfg.n_coarse, generator, lindisp=cfg.lindisp, jitter=d.coarse
    ).reshape(SB, B, cfg.n_coarse)
    weights_c, rgb_c, depth_c = composite(
        model_fn, rays, z_coarse, cfg, coarse=True, generator=generator,
        training=training, use_viewdirs=use_viewdirs, noise=d.noise_coarse,
        noise_scale=noise_scale,
    )

    def pack(weights, rgb, depth):
        out = {"rgb": rgb, "depth": depth}
        if want_weights:
            out["weights"] = weights
        return out

    outputs = {"coarse": pack(weights_c, rgb_c, depth_c)}
    if cfg.using_fine:
        all_samps = [z_coarse]
        n_importance = cfg.n_fine - cfg.n_fine_depth
        if n_importance > 0:
            z_fine = ray_sampling.sample_fine(
                flat_rays, weights_c.reshape(SB * B, cfg.n_coarse), n_importance,
                cfg.n_coarse, generator, lindisp=cfg.lindisp, u=d.fine_u, jitter=d.fine_jitter,
            ).reshape(SB, B, -1)
            all_samps.append(z_fine)
        if cfg.n_fine_depth > 0:
            z_depth = ray_sampling.sample_fine_depth(
                flat_rays, depth_c.detach().reshape(SB * B), cfg.n_fine_depth,
                cfg.depth_std, generator, noise=d.depth,
            ).reshape(SB, B, cfg.n_fine_depth)
            all_samps.append(z_depth)
        z_combine = torch.sort(torch.cat(all_samps, dim=-1), dim=-1).values
        weights_f, rgb_f, depth_f = composite(
            model_fn, rays, z_combine, cfg, coarse=False, generator=generator,
            training=training, use_viewdirs=use_viewdirs, noise=d.noise_fine,
            noise_scale=noise_scale,
        )
        outputs["fine"] = pack(weights_f, rgb_f, depth_f)
    return outputs


class NeRFRenderer:
    """Renderer wrapper carrying the sample-count schedule state."""

    def __init__(self, cfg: RenderConfig):
        self.base_cfg = cfg
        self.n_coarse = cfg.n_coarse
        self.n_fine = cfg.n_fine
        self.iter_idx = 0
        self.last_sched = 0

    @classmethod
    def from_conf(cls, conf, **kwargs) -> "NeRFRenderer":
        return cls(RenderConfig.from_conf(conf, **kwargs))

    @property
    def cfg(self) -> RenderConfig:
        return dataclasses.replace(self.base_cfg, n_coarse=self.n_coarse, n_fine=self.n_fine)

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0

    def sched_step(self, steps: int = 1) -> None:
        """Advance the sampling schedule ``[iters, n_coarse, n_fine]``."""
        sched = self.base_cfg.sched
        if sched is None:
            return
        self.iter_idx += steps
        while self.last_sched < len(sched[0]) and self.iter_idx >= sched[0][self.last_sched]:
            self.n_coarse = sched[1][self.last_sched]
            self.n_fine = sched[2][self.last_sched]
            print("INFO: NeRF sampling resolution changed on schedule ==> c",
                  self.n_coarse, "f", self.n_fine)
            self.last_sched += 1

    def state_dict(self) -> dict:
        return {"iter_idx": self.iter_idx, "last_sched": self.last_sched,
                "n_coarse": self.n_coarse, "n_fine": self.n_fine}

    def load_state_dict(self, state: dict) -> None:
        self.iter_idx = int(state["iter_idx"])
        self.last_sched = int(state["last_sched"])
        self.n_coarse = int(state.get("n_coarse", self.n_coarse))
        self.n_fine = int(state.get("n_fine", self.n_fine))
