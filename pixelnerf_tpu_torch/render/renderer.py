"""NeRF volume renderer: coarse stratified samples, then the sorted union
of coarse, importance and depth-centered samples, composited with
``alpha = 1 - exp(-delta * relu(sigma))``, the exclusive transmittance
cumprod with its 1e-10 guard and white-background completion.

With an occupancy grid (``accel``, :mod:`.accel`; eval only, one object a
call) the render prunes as the JAX package's does, by ``accel_mode``:
``"rays"`` compacts away rays whose every coarse sample lies in verified-
empty space, ``"proposal"`` does that and replaces the coarse field pass by
grid lookups as the importance proposal, ``"samples"`` compacts single
samples.  Compaction gathers the live rays or points into a buffer of a
fixed capacity, so the field always sees the same point count; a pass with
more live elements than the capacity renders dense instead, from the same
coarse draw.  Deciding that is one host read of the live count a pass
(``ACCEL_COUNTS``).

Random draws come from a ``torch.Generator`` in the order the JAX
``render_rays`` splits its key: coarse jitter, coarse sigma noise, importance
(u, then jitter), depth noise, fine sigma noise.  The ray-compacted render
draws its coarse z (the probe ladder) first, then the fine draws of the
branch it takes, shaped by the capacity when it compacts.  Any of them can
be passed in through :class:`RayDraws` instead, and :func:`complete_draws`
makes them all up front, in that order.

With a :class:`RowSplit` (several ranks, eval at SB 1) each rank renders a
contiguous share of the rays from the whole pass's draws and the shares are
gathered, so the result is the one-device render.  Every rank probes the
whole pass against a grid, so the capacity, the fallback and the compacted
row of each ray are decided as one device decides them; under ``"samples"``
the live-point count that picks compaction or fallback is summed over the
ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import rays as ray_sampling
from .accel import OccupancyGrid, occupancy_lookup, probe_lookup

# model_fn(points (SB, P, 3), viewdirs (SB, P, 3) | None, coarse: bool)
#   -> (SB, 4, P) channel-major [r, g, b, sigma]
ModelFn = Callable[..., torch.Tensor]

# host reads of a live count (one per compacted pass) and the passes that
# compacted or fell back to the dense render
ACCEL_COUNTS = {"n_live_reads": 0, "compacted": 0, "fallbacks": 0}

ACCEL_MODES = ("rays", "proposal", "samples")


def reset_accel_counts() -> None:
    for k in ACCEL_COUNTS:
        ACCEL_COUNTS[k] = 0


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
    # --- occupancy-grid pruning (accel.py; eval only), the JAX defaults ---
    # "rays" | "proposal" | "samples" (module docstring); under "proposal"
    # the coarse head holds the proposal (rgb = background), not a render
    accel_mode: str = "rays"
    # proposal: stratified importance draws from the grid pdf (the fine
    # union is these + accel_depth_samples depth draws)
    accel_proposal_samples: int = 16
    # share of the proposal pdf taken from the occupied-uniform mask
    accel_proposal_uniform: float = 0.15
    # per-bin alpha ceiling of the grid-sigma pdf (<= 0 or >= 1: none)
    accel_proposal_alpha_cap: float = 0.15
    # grid-probe z's per ray in proposal mode (0: n_coarse)
    accel_probe_samples: int = 32
    # proposal-mode depth draws (None: n_fine_depth)
    accel_depth_samples: Optional[int] = 8
    # compaction capacities as fractions of the pass (rays; coarse samples;
    # fine samples, None: accel_capacity)
    accel_capacity_rays: float = 0.5
    accel_capacity: float = 0.5
    accel_capacity_fine: Optional[float] = None
    # samples mode: fine samples entered with coarse transmittance below
    # this are occluded and pruned
    accel_t_eps: float = 1e-4

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
        accel_mode = conf.get_string("accel_mode", "rays")
        if accel_mode not in ACCEL_MODES:
            raise ValueError(
                f"renderer.accel_mode must be one of 'rays', 'proposal', 'samples' (got "
                f"{accel_mode!r}); disable pruning with --no_accel or PIXELNERF_ACCEL=0 instead")
        depth_samples = conf.get_int("accel_depth_samples", 8)
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
            accel_mode=accel_mode,
            accel_proposal_samples=conf.get_int("accel_proposal_samples", 16),
            accel_proposal_uniform=conf.get_float("accel_proposal_uniform", 0.15),
            accel_proposal_alpha_cap=conf.get_float("accel_proposal_alpha_cap", 0.15),
            accel_probe_samples=conf.get_int("accel_probe_samples", 32),
            accel_depth_samples=None if depth_samples < 0 else depth_samples,
            accel_capacity_rays=conf.get_float("accel_capacity_rays", 0.5),
            accel_capacity=conf.get_float("accel_capacity", 0.5),
            accel_capacity_fine=conf.get_float("accel_capacity_fine", 0.0) or None,
            accel_t_eps=conf.get_float("accel_t_eps", 1e-4),
        )


@dataclasses.dataclass
class RayDraws:
    """Random numbers for one :func:`render_rays` call over (SB * B) rays;
    a field left None is drawn from the generator."""

    coarse: Optional[torch.Tensor] = None  # (SB*B, n_coarse | probe count) uniform
    noise_coarse: Optional[torch.Tensor] = None  # (SB, B, n_coarse) normal, training only
    # (SB*B, n_importance) uniform; the proposal's stratified draw takes it as
    # the jitter inside each quantile
    fine_u: Optional[torch.Tensor] = None
    fine_jitter: Optional[torch.Tensor] = None  # (SB*B, n_importance) uniform
    depth: Optional[torch.Tensor] = None  # (SB*B, n_fine_depth) normal
    noise_fine: Optional[torch.Tensor] = None  # (SB, B, K_fine) normal, training only
    # the fine draws of the ray-compacted branch, (capacity, ...) rows; the
    # fields above serve the dense render and its fallback
    compacted: Optional["RayDraws"] = None


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """This rank's share of a render's rays: rank ``rank`` of ``world``
    renders rows ``[rank * per, (rank + 1) * per)`` of the pass padded to
    ``world * per`` rows.  ``gather`` joins every rank's tensor along dim 0
    in rank order; ``total`` sums a tensor over the ranks."""

    world: int
    rank: int
    gather: Callable[[torch.Tensor], torch.Tensor]
    total: Callable[[torch.Tensor], torch.Tensor]


def complete_draws(cfg: RenderConfig, SB: int, B: int, generator, given: Optional[RayDraws],
                   training: bool = False, proposal: bool = False,
                   z_given: bool = False) -> RayDraws:
    """Every draw :func:`render_rays` makes for (SB, B) rays without a
    ray-compacted pass, in its order and shapes: the fields of ``given``
    kept, the rest drawn from ``generator``.  ``z_given``: the coarse z is
    passed in (no coarse draw); ``proposal``: the grid-proposal render's
    draws."""
    d = dataclasses.replace(given) if given is not None else RayDraws()
    N = SB * B

    def draw(cur, shape, normal=False):
        if cur is not None:
            return cur
        fn = torch.randn if normal else torch.rand
        return fn(shape, generator=generator, device=generator.device)

    n_draw = (cfg.accel_probe_samples or cfg.n_coarse) if proposal else cfg.n_coarse
    noise = training and cfg.noise_std > 0.0
    if not z_given:
        d.coarse = draw(d.coarse, (N, n_draw))
    if noise and not proposal:
        d.noise_coarse = draw(d.noise_coarse, (SB, B, n_draw), normal=True)
    if cfg.using_fine:
        n_imp = cfg.accel_proposal_samples if proposal else cfg.n_fine - cfg.n_fine_depth
        n_depth = (cfg.accel_depth_samples
                   if proposal and cfg.accel_depth_samples is not None else cfg.n_fine_depth)
        if n_imp > 0:
            d.fine_u = draw(d.fine_u, (N, n_imp))
            d.fine_jitter = draw(d.fine_jitter, (N, n_imp))
        if n_depth > 0:
            d.depth = draw(d.depth, (N, n_depth), normal=True)
        if noise:
            k_fine = (0 if proposal else n_draw) + max(n_imp, 0) + max(n_depth, 0)
            d.noise_fine = draw(d.noise_fine, (SB, B, k_fine), normal=True)
    return d


def draw_rows(d: RayDraws, SB: int, B: int, obj: slice, ray: slice) -> RayDraws:
    """The draws of objects ``obj`` and their rays ``ray`` of (SB, B) rays."""
    def take(x):
        if x is None:
            return None
        if x.shape[0] == SB * B and x.ndim == 2:
            return x.reshape(SB, B, -1)[obj, ray].reshape(-1, x.shape[-1])
        return x[obj, ray]

    return RayDraws(**{f.name: take(getattr(d, f.name)) for f in dataclasses.fields(d)
                       if f.name != "compacted"})


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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _eval_model_masked(model_fn: ModelFn, points, viewdirs, coarse: bool, mask: torch.Tensor,
                       cap_frac: float, live_total=None):
    """The field at the points of ``mask`` (1, P) only, through a buffer of
    ``max(round_up(cap_frac * P, 512), 512)`` points (padded with the last
    point; its outputs dropped); pruned points read rgb = sigma = 0.  More
    live points than the capacity evaluate every point instead.

    :param live_total: ``mask -> (live points, points)`` of the whole pass
        when this call holds one rank's share of it; the share's live
        points are then evaluated as they are, without a buffer"""
    SB, P, _ = points.shape
    assert SB == 1, "masked compaction takes one object (the eval path)"
    idx = torch.nonzero(mask[0]).squeeze(1)  # the host read of the live count
    ACCEL_COUNTS["n_live_reads"] += 1
    n_act = idx.numel()
    n_tot, p_tot = (n_act, P) if live_total is None else live_total(mask)
    capacity = max(_round_up(int(cap_frac * p_tot), 512), 512)
    if n_tot > capacity:
        ACCEL_COUNTS["fallbacks"] += 1
        return model_fn(points, viewdirs, coarse)
    ACCEL_COUNTS["compacted"] += 1
    if live_total is not None:
        if not n_act:
            return points.new_zeros((1, 4, P))
        out = model_fn(points[:, idx], None if viewdirs is None else viewdirs[:, idx], coarse)
        full = out.new_zeros((1, out.shape[1], P))
        full[0, :, idx] = out[0]
        return full
    src = F.pad(idx, (0, capacity - n_act), value=P - 1)
    out = model_fn(points[:, src], None if viewdirs is None else viewdirs[:, src], coarse)
    full = out.new_zeros((1, out.shape[1], P))
    full[0, :, idx] = out[0, :, :n_act]
    return full


def composite(model_fn: ModelFn, rays: torch.Tensor, z_samp: torch.Tensor, cfg: RenderConfig,
              coarse: bool, generator=None, training: bool = False, use_viewdirs: bool = True,
              noise: Optional[torch.Tensor] = None, noise_scale=None,
              point_mask: Optional[torch.Tensor] = None, live_total=None):
    """Alpha-composite rgb/sigma along rays.

    :param rays: (SB, B, 8); z_samp: (SB, B, K)
    :param noise: (SB, B, K) sigma noise (training with noise_std > 0), drawn when None
    :param noise_scale: optional multiplier of the noise (a schedule's anneal)
    :param point_mask: (SB, B, K) live samples (occupancy pruning, eval at
        SB 1 only): the rest read zero weight
    :param live_total: as :func:`_eval_model_masked`'s
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

    if point_mask is not None and SB == 1 and not training:
        cap_frac = cfg.accel_capacity if coarse else (cfg.accel_capacity_fine or cfg.accel_capacity)
        out = _eval_model_masked(model_fn, points, viewdirs, coarse,
                                 point_mask.reshape(SB, B * K), cap_frac, live_total)
    else:
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


def _sample_points(rays: torch.Tensor, z_samp: torch.Tensor) -> torch.Tensor:
    """(SB, B, K, 3) world points at the sample depths."""
    return rays[..., None, :3] + z_samp[..., None] * rays[..., None, 3:6]


def _render_rays_ray_compacted(model_fn: ModelFn, rays: torch.Tensor, cfg: RenderConfig,
                               generator, d: RayDraws, want_weights: bool, use_viewdirs: bool,
                               accel: OccupancyGrid, proposal: bool,
                               split: Optional[RowSplit] = None) -> Dict[str, dict]:
    """Ray-level pruning: rays whose every coarse sample lies in verified-
    empty space render to background without touching the field.

    The coarse z (the probe ladder under ``proposal``) is drawn once and
    probed against the grid.  When the live rays fit the capacity
    ``min(max(round_up(accel_capacity_rays * B, 256), 256), B)`` they are
    gathered into a buffer of that many rays (padded with the last ray),
    rendered with their coarse z and scattered back; the fine draws are then
    shaped by the capacity (``d.compacted``).  Otherwise the whole pass
    renders dense from the same coarse z, so it equals a plain dense render
    on the same draws bit for bit.  With ``proposal`` both branches sample
    the grid proposal and forward the probe results.  Under ``split`` every
    rank takes these decisions on the whole pass and the branch's render is
    split.
    """
    _, B, _ = rays.shape
    capacity = min(max(_round_up(int(cfg.accel_capacity_rays * B), 256), 256), B)
    inner_accel = accel if proposal else None
    kw = dict(want_weights=want_weights, use_viewdirs=use_viewdirs, accel=inner_accel,
              proposal=proposal, split=split)
    if capacity >= B:
        return render_rays(model_fn, rays, cfg, generator, d, **kw)

    flat = rays[0]
    n_draw = (cfg.accel_probe_samples or cfg.n_coarse) if proposal else cfg.n_coarse
    z_full = ray_sampling.sample_coarse(flat, n_draw, generator, lindisp=cfg.lindisp,
                                        jitter=d.coarse)
    # one grid gather serves the liveness test and the inner proposal pdf
    mask_full, sig_full = probe_lookup(accel, _sample_points(rays, z_full[None]))
    idx = torch.nonzero(mask_full.any(dim=-1)[0]).squeeze(1)  # the host read of n_live
    ACCEL_COUNTS["n_live_reads"] += 1
    n_live = idx.numel()
    if n_live > capacity:
        ACCEL_COUNTS["fallbacks"] += 1
        return render_rays(model_fn, rays, cfg, generator,
                           dataclasses.replace(d, coarse=None, compacted=None),
                           z_coarse=z_full[None], probe_mask=mask_full if proposal else None,
                           probe_sig=sig_full if proposal else None, **kw)

    ACCEL_COUNTS["compacted"] += 1
    src = F.pad(idx, (0, capacity - n_live), value=B - 1)
    cmask = csig = None
    if proposal:
        cmask = mask_full[0][src][None]
        csig = None if sig_full is None else sig_full[0][src][None]
    out = render_rays(model_fn, flat[src][None], cfg, generator,
                      d.compacted if d.compacted is not None else RayDraws(),
                      z_coarse=z_full[src][None], probe_mask=cmask, probe_sig=csig, **kw)
    fills = {"rgb": 1.0 if cfg.white_bkgd else 0.0, "depth": 0.0, "weights": 0.0}

    def scatter(k, v):
        full = torch.full((1, B) + tuple(v.shape[2:]), fills[k], dtype=v.dtype, device=v.device)
        full[0, idx] = v[0, :n_live]
        return full

    return {h: {k: scatter(k, v) for k, v in head.items()} for h, head in out.items()}


def render_rays(model_fn: ModelFn, rays: torch.Tensor, cfg: RenderConfig, generator=None,
                draws: Optional[RayDraws] = None, want_weights: bool = False,
                training: bool = False, use_viewdirs: bool = True,
                noise_scale=None, accel: Optional[OccupancyGrid] = None,
                proposal: bool = False, z_coarse: Optional[torch.Tensor] = None,
                probe_mask: Optional[torch.Tensor] = None,
                probe_sig: Optional[torch.Tensor] = None, split: Optional[RowSplit] = None,
                live_total=None) -> Dict[str, dict]:
    """Full coarse + fine render of ``rays`` (SB, B, 8).  ``noise_scale``
    multiplies the training sigma noise of both passes.

    :param accel: an occupancy grid: prune by ``cfg.accel_mode`` (eval at
        SB 1 only; training and SB > 1 ignore it)
    :param proposal: the grid-proposal coarse (set by the ray-compacted
        render under ``accel_mode="proposal"``)
    :param z_coarse: (SB, B, Kc) a coarse draw made already, with the probe
        results ``probe_mask`` / ``probe_sig`` at it under ``proposal``
    :param split: render this rank's share of the rays (SB 1) and gather
        the shares (:class:`RowSplit`)
    :param live_total: set by the split render on each share
    :return: {"coarse": {rgb, depth[, weights]}, "fine": {...}} ("fine" only
        when cfg.using_fine)
    """
    assert rays.ndim == 3
    SB, B, _ = rays.shape
    d = draws if draws is not None else RayDraws()
    use_accel = accel is not None and not training and SB == 1
    if use_accel and not proposal and cfg.accel_mode in ("rays", "proposal"):
        return _render_rays_ray_compacted(
            model_fn, rays, cfg, generator, d, want_weights, use_viewdirs, accel,
            proposal=cfg.accel_mode == "proposal" and cfg.using_fine, split=split)
    if split is not None and split.world > 1:
        return _render_split(model_fn, rays, cfg, generator, d, split, want_weights, training,
                             use_viewdirs, noise_scale, accel, proposal, z_coarse, probe_mask,
                             probe_sig)
    samples_mode = use_accel and not proposal  # accel_mode == "samples"
    flat_rays = rays.reshape(SB * B, 8)

    if z_coarse is None:
        n_draw = (cfg.accel_probe_samples or cfg.n_coarse) if proposal else cfg.n_coarse
        z_coarse = ray_sampling.sample_coarse(
            flat_rays, n_draw, generator, lindisp=cfg.lindisp, jitter=d.coarse
        ).reshape(SB, B, n_draw)

    if proposal:
        # grid-proposal coarse: no field pass.  The pdf is the compositing
        # weight of the grid's sigma (alpha capped), mixed with the occupied-
        # uniform mask; the coarse head reports background rgb and the
        # pdf's depth, 0.0 on an empty ray as the compacted branch's fill
        if probe_mask is None:
            probe_mask, probe_sig = probe_lookup(accel, _sample_points(rays, z_coarse))
        wmask = probe_mask.float()
        msum = wmask.sum(dim=-1)
        if probe_sig is not None:
            # gated by the mask: sub-threshold sigma carries no weight
            sig = probe_sig * wmask
            deltas = torch.cat([z_coarse[..., 1:] - z_coarse[..., :-1],
                                rays[..., -1:] - z_coarse[..., -1:]], dim=-1)
            alpha = 1.0 - torch.exp(-deltas * sig)
            if 0.0 < cfg.accel_proposal_alpha_cap < 1.0:
                alpha = torch.clamp(alpha, max=cfg.accel_proposal_alpha_cap)
            ashift = torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1)
            w = alpha * torch.cumprod(ashift, dim=-1)[..., :-1]
            wsum = w.sum(dim=-1)
            u = cfg.accel_proposal_uniform
            weights_c = ((1.0 - u) * w / torch.clamp(wsum, min=1e-9)[..., None]
                         + u * wmask / torch.clamp(msum, min=1.0)[..., None])
            depth_src, dsum = w, wsum
        else:
            weights_c = wmask / torch.clamp(msum, min=1.0)[..., None]
            depth_src, dsum = wmask, msum
        depth_c = torch.where(
            dsum > 0.0,
            torch.sum(depth_src * z_coarse, dim=-1) / torch.clamp(dsum, min=1e-9),
            torch.zeros_like(dsum))
        rgb_c = torch.full((SB, B, 3), 1.0 if cfg.white_bkgd else 0.0, device=rays.device)
    else:
        mask_c = occupancy_lookup(accel, _sample_points(rays, z_coarse)) if samples_mode else None
        weights_c, rgb_c, depth_c = composite(
            model_fn, rays, z_coarse, cfg, coarse=True, generator=generator,
            training=training, use_viewdirs=use_viewdirs, noise=d.noise_coarse,
            noise_scale=noise_scale, point_mask=mask_c, live_total=live_total,
        )

    def pack(weights, rgb, depth):
        out = {"rgb": rgb, "depth": depth}
        if want_weights:
            out["weights"] = weights
        return out

    outputs = {"coarse": pack(weights_c, rgb_c, depth_c)}
    if cfg.using_fine:
        # proposal: the union drops the probe z's (never evaluated) for
        # accel_proposal_samples stratified grid draws + its depth draws
        all_samps = [] if proposal else [z_coarse]
        n_importance = cfg.accel_proposal_samples if proposal else cfg.n_fine - cfg.n_fine_depth
        n_depth = (cfg.accel_depth_samples
                   if proposal and cfg.accel_depth_samples is not None else cfg.n_fine_depth)
        if n_importance > 0:
            Kc = z_coarse.shape[-1]  # n_coarse, or the probe count under proposal
            z_fine = ray_sampling.sample_fine(
                flat_rays, weights_c.reshape(SB * B, Kc), n_importance, Kc, generator,
                lindisp=cfg.lindisp, u=d.fine_u, jitter=d.fine_jitter, stratified=proposal,
            ).reshape(SB, B, -1)
            all_samps.append(z_fine)
        if n_depth > 0:
            z_depth = ray_sampling.sample_fine_depth(
                flat_rays, depth_c.detach().reshape(SB * B), n_depth,
                cfg.depth_std, generator, noise=d.depth,
            ).reshape(SB, B, n_depth)
            all_samps.append(z_depth)
        z_combine = torch.sort(torch.cat(all_samps, dim=-1), dim=-1).values

        mask_f = None
        if samples_mode:
            # empty space, and occlusion: the coarse transmittance entering
            # the coarse bin of each union sample (1 - the weights before it,
            # an upper bound of its true T) below accel_t_eps
            mask_f = occupancy_lookup(accel, _sample_points(rays, z_combine))
            t_after = 1.0 - torch.cumsum(weights_c, dim=-1)
            t_entry = torch.cat([torch.ones_like(t_after[..., :1]), t_after[..., :-1]], dim=-1)
            binm1 = (z_coarse[..., None, :] <= z_combine[..., :, None]).sum(dim=-1)
            bin_idx = torch.clamp(binm1 - 1, 0, cfg.n_coarse - 1)
            mask_f = mask_f & (torch.gather(t_entry, -1, bin_idx) > cfg.accel_t_eps)

        weights_f, rgb_f, depth_f = composite(
            model_fn, rays, z_combine, cfg, coarse=False, generator=generator,
            training=training, use_viewdirs=use_viewdirs, noise=d.noise_fine,
            noise_scale=noise_scale, point_mask=mask_f, live_total=live_total,
        )
        outputs["fine"] = pack(weights_f, rgb_f, depth_f)
    return outputs


def _render_split(model_fn: ModelFn, rays: torch.Tensor, cfg: RenderConfig, generator,
                  d: RayDraws, split: RowSplit, want_weights: bool, training: bool,
                  use_viewdirs: bool, noise_scale, accel, proposal: bool, z_coarse, probe_mask,
                  probe_sig) -> Dict[str, dict]:
    """:func:`render_rays` of one object's B rays as rank ``split.rank`` of
    ``split.world``: the pass's draws made whole (:func:`complete_draws`),
    the rows padded with the last ray to a multiple of the ranks, this
    rank's share rendered, and the shares gathered."""
    SB, B, _ = rays.shape
    assert SB == 1, "the split render takes one object (the eval path)"
    d = complete_draws(cfg, 1, B, generator, d, training=training, proposal=proposal,
                       z_given=z_coarse is not None)
    per = -(-B // split.world)
    lo = split.rank * per
    n_valid = min(max(B - lo, 0), per)

    def share(x, rows_dim):
        """Rows [lo, lo + per) of ``x`` padded with its last row."""
        if x is None:
            return None
        x = x.movedim(rows_dim, 0)
        pad = per * split.world - x.shape[0]
        if pad:
            x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
        return x[lo:lo + per].movedim(0, rows_dim)

    mine = RayDraws(**{f.name: share(getattr(d, f.name), 0 if getattr(d, f.name) is None
                                     or getattr(d, f.name).ndim == 2 else 1)
                       for f in dataclasses.fields(d) if f.name != "compacted"})

    def live_total(mask: torch.Tensor):
        """(live points, points) of the whole pass from this share's mask
        (1, per * K), its padded rows left out."""
        k = mask.shape[1] // per
        n = mask[:, :n_valid * k].sum().reshape(1).to(torch.int64)
        return int(split.total(n)), B * k

    out = render_rays(model_fn, share(rays, 1), cfg, generator, mine, want_weights, training,
                      use_viewdirs, noise_scale, accel, proposal, share(z_coarse, 1),
                      share(probe_mask, 1), share(probe_sig, 1), live_total=live_total)
    return {h: {k: split.gather(v[0])[:B][None] for k, v in head.items()}
            for h, head in out.items()}


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
