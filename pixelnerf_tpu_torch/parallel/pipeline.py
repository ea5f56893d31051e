"""Render of many rays: rays in chunks of ``device_chunk``, every head's
rgb, depth and weights (``render``), or the fine (else coarse) rgb and depth
in the JAX package's wire formats (``render_simple``), and the per-scene
occupancy accel (``build_accel``: the grid, the capacity probe that sizes
the compaction buffers and the ray chunk, and the quality gate that settles
the pruning mode).  The JAX ``RenderPipeline``.

With a ray mesh of several ranks (``parallel.mesh.make_ray_mesh``) each
chunk is rounded up to a multiple of the rank count and every rank renders
a contiguous share of it from the whole chunk's draws
(``render.renderer.RowSplit``); the shares are gathered on every rank, so
each holds the one-device result and the callers run alike on all of them.
The grid build, the capacity probe and the gate run identically on every
rank (the same field, draws and renders); the build checks that the grids
agree."""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.pixelnerf import EncodedScene, PixelNeRFNet
from ..render.accel import (
    OccupancyGrid,
    aabb_from_rays,
    build_occupancy_grid,
    occupancy_fraction,
    occupancy_lookup,
)
from ..render.renderer import ACCEL_MODES, NeRFRenderer, RayDraws, RowSplit, render_rays
from . import launch
from .mesh import Mesh


def unpack_simple(pieces):
    """Fetched ``render_simple`` pieces -> (rgb (NR, 3), depth (NR,)) float32
    numpy.  Both wire formats: (n, 4) f32 [rgb | depth], and the (n, 5) uint8
    video-frame format [rgb u8 | depth f16 as 2 u8 lanes].

    :param pieces: [(packed array or tensor, true row count), ...]
    """
    packed = np.concatenate(
        [(p.cpu().numpy() if torch.is_tensor(p) else np.asarray(p))[:n] for p, n in pieces],
        axis=0)
    if packed.dtype == np.uint8:
        rgb = packed[:, :3].astype(np.float32) / 255.0
        depth = np.ascontiguousarray(packed[:, 3:5]).view(np.float16)[:, 0].astype(np.float32)
        return rgb, depth
    return packed[:, :3], packed[:, 3]


def pack_simple(rgb: torch.Tensor, depth: torch.Tensor, pack: str) -> torch.Tensor:
    """One chunk's (rgb (n, 3), depth (n,)) in a wire format: ``"f32"`` (n, 4)
    f32; ``"u8"`` (n, 5) uint8 -- rgb quantized as the video writer does it,
    depth as f16 in two byte lanes (5 bytes a ray instead of 16)."""
    if pack == "f32":
        return torch.cat([rgb, depth[:, None]], dim=-1)
    if pack == "u8":
        rgb_u8 = torch.round(rgb.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        d_u8 = depth.to(torch.float16)[:, None].contiguous().view(torch.uint8)
        return torch.cat([rgb_u8, d_u8], dim=-1)
    raise ValueError(f"pack must be 'f32' or 'u8', got {pack!r}")


def _live_point_evals(cfg, chunk: int, cap_r: float, cap_c: float,
                      cap_f: Optional[float]) -> float:
    """Estimated live field evaluations a ray chunk under pruning, by the
    render's mode dispatch: "proposal" (with a fine pass) evaluates only its
    proposal + depth union on the ``cap_r`` buffer, "rays" (and proposal
    without a fine pass) the dense ladder there, "samples" compacts per
    sample at ``cap_c`` / ``cap_f``."""
    union = cfg.n_coarse + cfg.n_fine  # n_fine includes the depth draws
    if cfg.accel_mode == "samples":
        per = cfg.n_coarse * cap_c
        if cfg.using_fine:
            per += union * (cap_f if cap_f is not None else cap_c)
        return chunk * per
    if cfg.accel_mode == "proposal" and cfg.using_fine:
        n_depth = (cfg.accel_depth_samples if cfg.accel_depth_samples is not None
                   else cfg.n_fine_depth)
        per = cfg.accel_proposal_samples + n_depth
    else:
        per = cfg.n_coarse + (union if cfg.using_fine else 0)
    return chunk * cap_r * per


@torch.no_grad()
def _capacity_probe(grid: OccupancyGrid, rays: torch.Tensor, kc: int, n_draws: int,
                    jitter: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Liveness of ``rays`` (n, 8) against ``grid`` under ``n_draws`` z
    ladders of ``kc`` bins: draw 0 probes the bin midpoints, draws 1.. one
    stratified z a bin (the render's coarse distribution), from ``jitter``
    (n_draws - 1, n, kc) or ``generator``.  The (n_draws, n, kc) point cloud
    stays on the rays' device; only the liveness comes back.

    :return: (ray_live (D, n) bool: any probe sample occupied,
              samp_live (D,) float32: live samples a draw)
    """
    n = rays.shape[0]
    dev = rays.device
    base = (torch.arange(kc, dtype=torch.float32, device=dev) / kc)[None, None]
    if jitter is None:
        jitter = torch.rand((n_draws - 1, n, kc), generator=generator, device=generator.device)
    u = torch.cat([torch.full((1, n, kc), 0.5, device=dev), jitter.to(dev, torch.float32)])
    t = base + u / kc  # (D, n, kc)
    z = rays[None, :, 6:7] + t * (rays[None, :, 7:8] - rays[None, :, 6:7])
    pts = rays[None, :, None, :3] + z[..., None] * rays[None, :, None, 3:6]
    live = occupancy_lookup(grid, pts)
    return live.any(dim=-1), live.sum(dim=(1, 2), dtype=torch.float32)


class RenderPipeline:
    # the live-point budget that bounds the ray chunk chosen under pruning,
    # and the largest such chunk (the JAX package's values; class attributes
    # so a pipeline built without a model keeps them)
    point_budget: int = 3_000_000
    accel_chunk_max: int = 65536
    accel_chunk: Optional[int] = None  # set by _autoselect_capacity
    accel: Optional[OccupancyGrid] = None
    # the last build's and capacity probe's numbers (replaced, never mutated)
    accel_stats: dict = {}

    def __init__(self, net: PixelNeRFNet, renderer: NeRFRenderer, mesh: Optional[Mesh] = None,
                 device_chunk: int = 8192):
        """:param mesh: a ray mesh: render each chunk split over its ranks
        :param device_chunk: rays rendered per step (bounds activation memory)"""
        self.net = net
        self.renderer = renderer
        self.mesh = mesh
        self.split = None
        if mesh is not None and mesh.size > 1:
            group = mesh.group(mesh.axis_names[-1])
            self.split = RowSplit(
                world=mesh.size, rank=mesh.rank,
                gather=lambda t: launch.all_gather_rows(t, group),
                total=lambda t: launch.all_reduce_sum_(t.clone(), group))
        self.device_chunk = device_chunk
        self.use_viewdirs = net.use_viewdirs
        self.accel = None  # the per-scene grid (build_accel)
        self.accel_chunk = None
        self.field_points = 0  # field evaluations made, in points

    def _kernel_mlp(self, scene: EncodedScene) -> bool:
        impl = self.net.mlp_impl
        return impl == "cuda" or (impl == "auto" and scene.device.type == "cuda")

    def _table_scene(self, scene: EncodedScene) -> EncodedScene:
        if self._kernel_mlp(scene):
            # the kernels read bf16 features; storing the table in bf16 halves
            # its reads without changing the kernels' numerics
            return scene.cast(torch.bfloat16)
        return scene

    def _field(self, scene: EncodedScene):
        def field(points, viewdirs, coarse):
            self.field_points += points.shape[0] * points.shape[1]
            return self.net.query(
                scene, points, viewdirs=viewdirs if self.use_viewdirs else None,
                coarse=coarse, planar_out=True,
            )

        return field

    @torch.no_grad()
    def build_accel(self, scene: EncodedScene, rays, resolution: int = 96,
                    eps_alpha: float = 1e-3, dilate: int = 1, n_dir_probes: int = 4,
                    ray_batch_size: Optional[int] = None,
                    dirs: Optional[torch.Tensor] = None,
                    jitter: Optional[Callable] = None) -> Optional[OccupancyGrid]:
        """Build the scene's occupancy grid over the box of ``rays`` (the
        union of every ray later rendered) and prune subsequent renders.
        ``PIXELNERF_ACCEL=0`` disables it.  Returns the grid, or None.

        :param ray_batch_size: the ``-R`` of the later renders, so that the
            capacity windows match their chunk
        :param dirs: (n_dir_probes, 3) probe directions (drawn from a
            generator seeded 0 when None)
        :param jitter: the capacity probe's draws, for this build and the
            gate's re-selections (:meth:`_autoselect_capacity`)
        """
        if os.environ.get("PIXELNERF_ACCEL", "1") == "0":
            self.accel = None
            self.accel_chunk = None
            return None
        rays_np = (rays.cpu().numpy() if torch.is_tensor(rays) else np.asarray(rays, np.float32))
        rays_np = rays_np.astype(np.float32).reshape(-1, 8)
        lo, hi = aabb_from_rays(rays_np)
        # a conservative alpha threshold at the coarse step
        delta = float(np.mean(rays_np[:, 7] - rays_np[:, 6])) / max(self.renderer.cfg.n_coarse, 1)
        thresh = float(np.float32(eps_alpha / max(delta, 1e-6)))
        device = scene.device
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        self.accel = build_occupancy_grid(
            self._field(self._table_scene(scene)), lo, hi, resolution=resolution,
            sigma_thresh=thresh, dilate=dilate, n_dir_probes=n_dir_probes, dirs=dirs,
            generator=torch.Generator(device=device).manual_seed(0),
            use_fine=self.renderer.using_fine, use_viewdirs=self.use_viewdirs, device=device)
        sync()
        t1 = time.perf_counter()
        grid = self.accel
        if self.split is not None:
            launch.check_replicas([grid.occ], "the occupancy grid")
        # kept for the gate: a re-selection sees the rays the build sized for
        self._build_rays_np = rays_np
        self._build_ray_batch_size = ray_batch_size
        self._build_jitter = jitter
        self._autoselect_capacity(rays_np, ray_batch_size=ray_batch_size, jitter=jitter)
        t2 = time.perf_counter()
        self.accel_stats = dict(self.accel_stats, grid_s=t1 - t0, probe_s=t2 - t1,
                                resolution=resolution, n_dir_probes=n_dir_probes,
                                occupancy=occupancy_fraction(grid))
        print(f"accel: build phases - grid program {t1 - t0:.1f}s (incl. compile on first "
              f"call), capacity probe {t2 - t1:.1f}s", file=sys.stderr)
        return self.accel

    def _autoselect_capacity(self, rays_np: np.ndarray, n_jitter_draws: int = 3,
                             ray_batch_size: Optional[int] = None,
                             jitter: Optional[Callable] = None) -> None:
        """Size the compaction buffers and the ray chunk from the live
        fractions of ``rays_np`` against the grid.

        A ray is live when any sample of its z ladder is occupied.  The ray
        capacity covers the worst window of effective-chunk rays (the tail
        window padded with the last ray, as the render pads its last chunk)
        over the midpoint ladder and ``n_jitter_draws`` stratified ones, plus
        one 1/64 step; the sample capacities cover the worst draw's live
        fraction (the fine union counting importance draws live).  The chunk
        grows from the render's toward ``accel_chunk_max`` while the live
        point evaluations stay within ``point_budget``.  A mode with nothing
        to prune (its key capacity >= 0.95: the ray capacity in "rays", the
        sample capacity otherwise) disables the grid.

        :param jitter: ``(chunk index, rays, kc, draws) -> (draws, rays, kc)``
            uniforms of the probe's stratified ladders; None draws them from
            a generator seeded 0
        """
        cfg = self.renderer.cfg
        # the z ladder the render probes
        kc = max(cfg.n_coarse, 1)
        if cfg.accel_mode == "proposal" and cfg.accel_probe_samples:
            kc = cfg.accel_probe_samples
        N = rays_np.shape[0]
        D = 1 + max(int(n_jitter_draws), 0)
        dev = self.accel.occ.device
        gen = torch.Generator(device=dev).manual_seed(0)
        ray_live = np.empty((D, N), bool)
        samp_live = np.zeros(D, np.float64)
        for i, s in enumerate(range(0, N, 65536)):
            sub = torch.from_numpy(rays_np[s:s + 65536]).to(dev)
            u = None if jitter is None else jitter(i, sub.shape[0], kc, D - 1)
            live, counts = _capacity_probe(self.accel, sub, kc, D, jitter=u, generator=gen)
            ray_live[:, s:s + 65536] = live.cpu().numpy()
            samp_live += counts.cpu().numpy().astype(np.float64)
        fc = float((samp_live / (N * kc)).max())

        def worst_window(win: int) -> float:
            win = min(max(win, 256), N)
            n_win = -(-N // win)
            padded = np.concatenate([ray_live, np.tile(ray_live[:, -1:], n_win * win - N)], axis=1)
            return float(padded.reshape(D, n_win, win).mean(axis=2).max())

        def quantize(frac: float) -> float:
            q = (np.ceil(min(frac, 1.0) * 64) + 1) / 64
            return float(np.clip(q, 1 / 32, 1.0))

        cap_c = quantize(fc)
        cap_f = None
        if cfg.using_fine:
            cap_f = quantize((kc * fc + cfg.n_fine) / (kc + cfg.n_fine))

        eff_chunk = self.device_chunk
        if ray_batch_size is not None:
            eff_chunk = min(eff_chunk, ray_batch_size)
        candidates = []
        c = self.accel_chunk_max
        while c > eff_chunk:
            if ray_batch_size is None or c <= ray_batch_size:
                candidates.append(c)
            c //= 2
        candidates.append(eff_chunk)
        for chunk in candidates:
            cap_r = quantize(worst_window(chunk))
            if (chunk == eff_chunk
                    or _live_point_evals(cfg, chunk, cap_r, cap_c, cap_f) <= self.point_budget):
                break
        self.accel_chunk = chunk if chunk > self.device_chunk else None
        fr = worst_window(chunk)
        self.accel_stats = dict(self.accel_stats, ray_live_max=fr,
                                ray_live_mean=float(ray_live[0].mean()), sample_live=fc,
                                cap_r=cap_r, cap_c=cap_c, cap_f=cap_f, chunk=chunk, kc=kc)
        print(f"accel: occupancy {occupancy_fraction(self.accel):.3f}, ray live max/mean "
              f"{fr:.3f}/{ray_live[0].mean():.3f} ({D - 1} jitter draws) -> ray capacity {cap_r}; "
              f"sample live {fc:.3f} -> capacities {cap_c}/{cap_f}; chunk {chunk}",
              file=sys.stderr)
        key_cap = cap_r if cfg.accel_mode == "rays" else cap_c
        if key_cap >= 0.95:
            print("accel: grid nearly fully occupied; disabling pruning", file=sys.stderr)
            self.accel = None
            self.accel_chunk = None
            return
        self.renderer.base_cfg = dataclasses.replace(
            self.renderer.base_cfg, accel_capacity_rays=cap_r, accel_capacity=cap_c,
            accel_capacity_fine=cap_f)

    def set_accel_mode(self, mode: str) -> None:
        """The pruning of later renders: "rays", "proposal" or "samples"."""
        assert mode in ACCEL_MODES, mode
        self.renderer.base_cfg = dataclasses.replace(self.renderer.base_cfg, accel_mode=mode)

    def gate_accel_mode(self, scene: EncodedScene, gate_rays, seed: int, rgb_dense=None, *,
                        ray_batch_size: Optional[int] = None, pack: str = "f32",
                        psnr_gate: float = 30.0, draws: Optional[Callable] = None):
        """Settle the pruning against a dense render of ``gate_rays``: render
        them pruned, and below ``psnr_gate`` dB step down the ladder
        ``proposal`` -> ``proposal+8`` -> ``proposal+16`` (8 and 16 more
        proposal draws) -> ``rays`` -> dense (the grid dropped).  A ladder
        that starts at ``rays`` or ``samples`` has only dense below it.
        Each render, the dense one included, draws from a fresh generator
        seeded ``seed``, so dense and pruned share their coarse z.  The
        proposal count restarts from its first value on every call; the
        settled config persists, and the first config comes back when every
        rung fails.

        :param rgb_dense: the dense render of ``gate_rays`` under ``pack``,
            or None to render it here
        :param draws: forwarded to :meth:`render_simple`
        :return: (label, {rung: PSNR against dense})
        """
        if self.accel is None:
            return "dense", {}
        if not hasattr(self, "_gate_pristine_samples"):
            self._gate_pristine_samples = self.renderer.base_cfg.accel_proposal_samples
        elif self.renderer.base_cfg.accel_proposal_samples != self._gate_pristine_samples:
            self.renderer.base_cfg = dataclasses.replace(
                self.renderer.base_cfg, accel_proposal_samples=self._gate_pristine_samples)
        base_cfg = self.renderer.base_cfg
        device = scene.device if scene is not None else torch.device("cpu")

        def render():
            return self.render_simple(scene, gate_rays,
                                      torch.Generator(device=device).manual_seed(seed),
                                      ray_batch_size=ray_batch_size or 50000, pack=pack,
                                      draws=draws)[0]

        if rgb_dense is None:
            grid, chunk = self.accel, self.accel_chunk
            self.accel = None
            rgb_dense = render()
            self.accel, self.accel_chunk = grid, chunk
        rgb_dense = np.asarray(rgb_dense, np.float32)

        def reselect():
            rays_np = getattr(self, "_build_rays_np", None)
            if rays_np is not None:
                self._autoselect_capacity(
                    rays_np, ray_batch_size=getattr(self, "_build_ray_batch_size", None),
                    jitter=getattr(self, "_build_jitter", None))

        def denser_proposal(extra):
            def setup():
                self.renderer.base_cfg = dataclasses.replace(
                    self.renderer.base_cfg,
                    accel_proposal_samples=base_cfg.accel_proposal_samples + extra)
                reselect()

            return setup

        def to_rays():
            self.renderer.base_cfg = base_cfg
            self.set_accel_mode("rays")
            # the rays probe may find nothing to prune and drop the grid
            reselect()

        if base_cfg.accel_mode == "proposal":
            ladder = [("proposal", None), ("proposal+8", denser_proposal(8)),
                      ("proposal+16", denser_proposal(16)), ("rays", to_rays)]
        else:
            ladder = [(base_cfg.accel_mode, None)]

        psnrs = {}
        for label, setup in ladder:
            if setup is not None:
                setup()
            if self.accel is None:  # a re-selection found nothing to prune
                break
            mse = float(np.mean((np.asarray(render(), np.float32) - rgb_dense) ** 2))
            psnrs[label] = -10.0 * float(np.log10(max(mse, 1e-12)))
            if psnrs[label] >= psnr_gate:
                return label, psnrs
        self.renderer.base_cfg = base_cfg
        self.accel = None
        self.accel_chunk = None
        return "dense", psnrs

    def _chunks(self, scene: EncodedScene, rays, generator: torch.Generator, ray_batch_size: int,
                draws: Optional[Callable[[int, int], RayDraws]], want_weights: bool = False,
                pad: bool = False):
        """Render ``rays`` a chunk at a time -> yields (``render_rays``
        output of the chunk, its true row count).  A short last chunk is
        padded with its last ray under a grid (the capacity windows assume
        it) or with ``pad``."""
        device = scene.device
        rays = torch.as_tensor(np.asarray(rays) if not torch.is_tensor(rays) else rays,
                               dtype=torch.float32).to(device)
        scene = self._table_scene(scene)
        # ray chunks already bound memory: no inner point chunking
        cfg = dataclasses.replace(self.renderer.cfg, eval_batch_size=0)
        dc = self.device_chunk
        if self.accel is not None and self.accel_chunk:
            dc = max(dc, self.accel_chunk)
        chunk = max(1, min(dc, ray_batch_size, rays.shape[0]))
        if self.split is not None:
            n = self.split.world
            chunk = max(-(-chunk // n) * n, n)
        field = self._field(scene)
        for i, start in enumerate(range(0, rays.shape[0], chunk)):
            part = rays[start:start + chunk]
            n = part.shape[0]
            if (pad or self.accel is not None) and n < chunk:
                part = torch.cat([part, part[-1:].expand(chunk - n, 8)])
            yield render_rays(field, part[None], cfg, generator,
                              draws=None if draws is None else draws(i, part.shape[0]),
                              want_weights=want_weights, use_viewdirs=self.use_viewdirs,
                              accel=self.accel, split=self.split), n

    @torch.no_grad()
    def render(self, scene: EncodedScene, rays, generator: torch.Generator,
               ray_batch_size: int = 50000, want_weights: bool = False,
               draws: Optional[Callable[[int, int], RayDraws]] = None) -> dict:
        """Render any number of rays of one scene, every head.

        Each chunk's output comes to the host as soon as it is rendered, so
        the card holds one chunk's weights at a time; the last chunk is
        padded with its last ray, as the JAX pipeline pads it.

        :param rays: (NR, 8) rays, numpy or tensor
        :param ray_batch_size: upper bound on the rays per step
        :param want_weights: add each head's compositing weights (NR, K)
        :param draws: as :meth:`render_simple`'s
        :return: {"coarse": {"rgb", "depth"[, "weights"]}[, "fine": {...}]}
            float32 numpy arrays of NR rows
        """
        pieces = [{h: {k: v[0, :n].cpu().numpy() for k, v in head.items()}
                   for h, head in out.items()}
                  for out, n in self._chunks(scene, rays, generator, ray_batch_size, draws,
                                             want_weights=want_weights, pad=True)]
        return {h: {k: np.concatenate([p[h][k] for p in pieces]) for k in head}
                for h, head in pieces[0].items()}

    @torch.no_grad()
    def render_simple(self, scene: EncodedScene, rays, generator: torch.Generator,
                      ray_batch_size: int = 50000, as_numpy: bool = True, pack: str = "f32",
                      draws: Optional[Callable[[int, int], RayDraws]] = None):
        """(rgb, depth) from the fine pass if present, else the coarse one.

        With a grid (``build_accel``) the chunk may grow to the one the
        capacity probe chose, and a short last chunk is padded with its last
        ray, as the capacity windows assume.

        :param rays: (NR, 8) rays, numpy or tensor
        :param ray_batch_size: upper bound on the rays per step
        :param pack: the wire format of each chunk (:func:`pack_simple`):
            ``"f32"``, or ``"u8"`` for a video or frame writer, never for
            quality metrics
        :param draws: ``(chunk index, rays in it) -> RayDraws`` of each
            chunk, in place of the generator's
        :return: with ``as_numpy``, (rgb (NR, 3), depth (NR,)) float32 numpy
            (:func:`unpack_simple`); else the packed chunks on the scene's
            device, ``[(packed, n), ...]``
        """
        if pack not in ("f32", "u8"):
            raise ValueError(f"pack must be 'f32' or 'u8', got {pack!r}")
        head = "fine" if self.renderer.cfg.using_fine else "coarse"
        pieces = [(pack_simple(out[head]["rgb"][0], out[head]["depth"][0], pack), n)
                  for out, n in self._chunks(scene, rays, generator, ray_batch_size, draws)]
        return unpack_simple(pieces) if as_numpy else pieces
