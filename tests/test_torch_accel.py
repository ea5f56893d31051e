"""The port's occupancy-grid accel against the JAX package's, on the CPU:
``render/accel.py`` (box, build, lookups), the renderer's ray-compacted,
proposal and samples modes fed JAX's own draws, the pipeline's capacity
probe, capacity and chunk selection, quality gate and pruned render, and
the stratified importance draw.

Inputs come from seeded numpy: the analytic sphere field and ring rays of
``tests/test_accel.py`` (copied here), and the small PixelNeRF world of
``tests/test_torch_model.py`` with one set of weights in both packages.

Tolerance: 1e-4 of max(1, max|ref|) (``TOL``), as in
``tests/test_torch_model.py``; occupancies, liveness, capacities, chunks,
gate labels and the compacted buffers' shapes are held exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.parallel import pipeline as jpipeline
from pixelnerf_tpu.render import accel as jaccel
from pixelnerf_tpu.render import rays as jrays
from pixelnerf_tpu.render import renderer as jrenderer
from pixelnerf_tpu_torch.parallel import pipeline as tpipeline
from pixelnerf_tpu_torch.render import accel as taccel
from pixelnerf_tpu_torch.render import rays as trays
from pixelnerf_tpu_torch.render import renderer as trenderer
from pixelnerf_tpu_torch.render.renderer import RayDraws
from test_torch_model import TOL, close

SPHERE_R = 0.4
SIGMA_IN = 60.0


def jsphere_field(points, viewdirs, coarse):
    """Opaque coloured sphere of radius SPHERE_R at the origin, (SB, P, 3)
    -> (SB, 4, P); sigma exactly zero outside."""
    inside = (jnp.sum(points * points, axis=-1) < SPHERE_R * SPHERE_R).astype(points.dtype)
    rgb = 0.5 + 0.5 * jnp.tanh(points)
    return jnp.concatenate([jnp.transpose(rgb, (0, 2, 1)), (SIGMA_IN * inside)[:, None]], axis=1)


def tsphere_field(points, viewdirs, coarse):
    inside = (torch.sum(points * points, dim=-1) < SPHERE_R * SPHERE_R).to(points.dtype)
    rgb = 0.5 + 0.5 * torch.tanh(points)
    return torch.cat([rgb.transpose(1, 2), (SIGMA_IN * inside)[:, None]], dim=1)


def camera_rays(B=256, seed=0, near=0.8, far=2.0, cam_dist=1.4):
    """Rays from a camera ring toward jittered points near the origin."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, B)
    phi = rng.uniform(-0.5, 0.5, B)
    o = cam_dist * np.stack([np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi),
                             np.sin(phi)], axis=-1).astype(np.float32)
    d = rng.uniform(-0.55, 0.55, (B, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((B, 1), near, np.float32),
                           np.full((B, 1), far, np.float32)], axis=-1)


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def port_grid(g) -> taccel.OccupancyGrid:
    """A JAX grid's arrays as the port's grid."""
    return taccel.OccupancyGrid(occ=t(g.occ), lo=t(g.lo), inv_cell=t(g.inv_cell), sig=t(g.sig),
                                thresh=t(g.thresh), resolution=g.resolution)


def jax_grid(g: taccel.OccupancyGrid):
    a = (lambda x: None if x is None else jnp.asarray(x.numpy()))
    return jaccel.OccupancyGrid(occ=a(g.occ), lo=a(g.lo), inv_cell=a(g.inv_cell), sig=a(g.sig),
                                thresh=a(g.thresh), resolution=g.resolution)


def sphere_grid(rays, resolution=48):
    lo, hi = jaccel.aabb_from_rays(rays)
    return jaccel.build_occupancy_grid(jsphere_field, lo, hi, resolution=resolution,
                                       sigma_thresh=1e-2, dilate=1, use_fine=False,
                                       use_viewdirs=False)


def slab_grid(R=8, lo_z=0, hi_z=4, full=False):
    """A unit-box grid occupied over z cells [lo_z, hi_z) (or everywhere)."""
    occ = np.ones((R, R, R), np.float32) if full else np.zeros((R, R, R), np.float32)
    occ[:, :, lo_z:hi_z] = 1.0
    return jaccel.OccupancyGrid(occ=jnp.asarray(occ.reshape(-1)), lo=jnp.zeros(3),
                                inv_cell=jnp.full((3,), float(R)), resolution=R)


def uniform_grid(rays, R, occ_value=1.0, sig=None, thresh=None):
    lo, hi = jaccel.aabb_from_rays(rays)
    return jaccel.OccupancyGrid(
        occ=jnp.full((R ** 3,), occ_value, jnp.float32), lo=jnp.asarray(lo),
        inv_cell=R / (jnp.asarray(hi) - jnp.asarray(lo)),
        sig=None if sig is None else jnp.full((R ** 3,), sig, jnp.float32),
        thresh=None if thresh is None else jnp.asarray(thresh, jnp.float32), resolution=R)


def psnr(a, b):
    return -10.0 * np.log10(max(float(np.mean((np.asarray(a) - np.asarray(b)) ** 2)), 1e-12))


# ---------------------------------------------------------------------------
# render/accel.py
# ---------------------------------------------------------------------------


def test_aabb_from_rays_matches_jax():
    rays = camera_rays(64)
    for got, want in zip(taccel.aabb_from_rays(rays), jaccel.aabb_from_rays(rays)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_build_grid_on_the_sphere_matches_jax():
    rays = camera_rays(128)
    ref = sphere_grid(rays)
    lo, hi = taccel.aabb_from_rays(rays)
    got = taccel.build_occupancy_grid(tsphere_field, lo, hi, resolution=48, sigma_thresh=1e-2,
                                      dilate=1, use_fine=False, use_viewdirs=False,
                                      chunk=1 << 14)
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(ref.occ))
    close(got.sig, ref.sig, what="sig")
    close(got.inv_cell, ref.inv_cell, what="inv_cell")
    assert got.resolution == 48 and float(got.thresh) == float(ref.thresh)
    assert 0.001 < taccel.occupancy_fraction(got) == pytest.approx(jaccel.occupancy_fraction(ref))


def test_lookups_match_jax_inside_and_outside_the_box():
    rays = camera_rays(64)
    g = sphere_grid(rays, resolution=32)
    pg = port_grid(g)
    pts = np.random.default_rng(9).uniform(-3.0, 3.0, (1, 512, 3)).astype(np.float32)
    P, J = torch.from_numpy(pts), jnp.asarray(pts)
    occ = taccel.occupancy_lookup(pg, P)
    assert not occ.all() and occ.any()
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jaccel.occupancy_lookup(g, J)))
    sig = taccel.sigma_lookup(pg, P)
    np.testing.assert_array_equal(sig.numpy(), np.asarray(jaccel.sigma_lookup(g, J)))
    mask, s = taccel.probe_lookup(pg, P)
    np.testing.assert_array_equal(mask.numpy(), occ.numpy())
    np.testing.assert_array_equal(s.numpy(), sig.numpy())
    # a grid without sig: the occupancy alone, outside the box occupied
    bare = dataclasses.replace(pg, sig=None, thresh=None)
    m2, s2 = taccel.probe_lookup(bare, P)
    assert s2 is None
    np.testing.assert_array_equal(m2.numpy(), taccel.occupancy_lookup(bare, P).numpy())
    empty = taccel.OccupancyGrid(occ=torch.zeros(8), lo=torch.zeros(3),
                                 inv_cell=torch.full((3,), 2.0), resolution=2)
    edge = torch.tensor([[[-1.0, 0.5, 0.5], [0.5, 0.5, 0.5], [2.0, 0.5, 0.5]]])
    assert taccel.occupancy_lookup(empty, edge)[0].tolist() == [True, False, True]


def test_stratified_importance_draw_matches_jax():
    rays = camera_rays(40)
    w = np.random.default_rng(2).uniform(0, 1, (40, 12)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    k_u, k_j = jax.random.split(key)
    for strat in (False, True):
        ref = jrays.sample_fine(jnp.asarray(rays), jnp.asarray(w), 7, 12, key, stratified=strat)
        got = trays.sample_fine(t(rays), t(w), 7, 12, u=t(jax.random.uniform(k_u, (40, 7))),
                                jitter=t(jax.random.uniform(k_j, (40, 7))), stratified=strat)
        close(got, ref, what=f"stratified={strat}")


# ---------------------------------------------------------------------------
# the renderer's modes
# ---------------------------------------------------------------------------


def tcfg(cfg) -> trenderer.RenderConfig:
    return trenderer.RenderConfig(**dataclasses.asdict(cfg))


def jax_draws(key, B, cfg, proposal=False, capacity=None):
    """The draws of JAX ``render_rays``' key split for B rays, and with
    ``capacity`` the compacted branch's (the inner render reuses the key on
    ``capacity`` rays)."""
    k_c, _, k_f, k_d, _ = jax.random.split(key, 5)
    k_u, k_j = jax.random.split(k_f)
    n_draw = (cfg.accel_probe_samples or cfg.n_coarse) if proposal else cfg.n_coarse
    n_imp = cfg.accel_proposal_samples if proposal else cfg.n_fine - cfg.n_fine_depth
    n_depth = (cfg.accel_depth_samples if proposal and cfg.accel_depth_samples is not None
               else cfg.n_fine_depth)

    def fine(rows):
        return dict(fine_u=t(jax.random.uniform(k_u, (rows, n_imp), dtype=jnp.float32)),
                    fine_jitter=t(jax.random.uniform(k_j, (rows, n_imp))),
                    depth=t(jax.random.normal(k_d, (rows, n_depth))))

    return RayDraws(coarse=t(jax.random.uniform(k_c, (B, n_draw))), **fine(B),
                    compacted=None if capacity is None else RayDraws(**fine(capacity)))


def jrender(rays, cfg, grid, seed=3):
    out = jax.jit(lambda r, k: jrenderer.render_rays(
        jsphere_field, r, k, cfg, want_weights=True, use_viewdirs=False, accel=grid,
    ))(jnp.asarray(rays[None]), jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, out)


def trender(rays, cfg, grid, draws=None, seed=3, field=tsphere_field, **kw):
    return trenderer.render_rays(
        field, torch.from_numpy(rays)[None], tcfg(cfg),
        torch.Generator().manual_seed(seed) if draws is None else None, draws=draws,
        want_weights=True, use_viewdirs=False,
        accel=None if grid is None else port_grid(grid), **kw)


def capacity_rays(cfg, B):
    return min(max(-(-int(cfg.accel_capacity_rays * B) // 256) * 256, 256), B)


BASE = dict(n_coarse=32, n_fine=16, n_fine_depth=8, white_bkgd=True)


@pytest.mark.parametrize("mode,cap,branch", [
    ("rays", 0.75, "compacted"), ("rays", 0.1, "fallback"),
    ("proposal", 0.75, "compacted"), ("proposal", 0.1, "fallback"), ("proposal", 1.0, "whole"),
    ("samples", 0.6, "compacted"), ("samples", 0.01, "fallback"),
])
def test_render_modes_match_jax(mode, cap, branch):
    """``render_rays`` under each accel mode on the sphere against JAX's, fed
    JAX's draws: both heads' rgb, depth and weights, and the branch taken."""
    B = 1024
    rays = camera_rays(B)
    grid = sphere_grid(rays)
    extra = dict(accel_proposal_samples=24) if mode == "proposal" else {}
    capk = "accel_capacity" if mode == "samples" else "accel_capacity_rays"
    cfg = jrenderer.RenderConfig(**BASE, accel_mode=mode, **{capk: cap}, **extra)
    ref = jrender(rays, cfg, grid)
    proposal = mode == "proposal"
    capacity = capacity_rays(cfg, B) if mode != "samples" else None
    draws = jax_draws(jax.random.PRNGKey(3), B, cfg, proposal=proposal, capacity=capacity)
    trenderer.reset_accel_counts()
    got = trender(rays, cfg, grid, draws)
    counts = dict(trenderer.ACCEL_COUNTS)
    if branch == "whole":
        assert counts["n_live_reads"] == 0
    elif mode == "samples":  # one masked pass a head
        assert counts["n_live_reads"] == 2 and counts[branch + "s" if branch == "fallback"
                                                      else branch] >= 1
    else:
        assert counts["n_live_reads"] == 1 and counts[branch + "s" if branch == "fallback"
                                                      else branch] == 1
    assert set(got) == set(ref) == {"coarse", "fine"}
    for head in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            close(got[head][k], ref[head][k], what=f"{mode} {head} {k}")
    if proposal:
        assert got["fine"]["weights"].shape[-1] == 24 + 8  # proposal + depth draws
        np.testing.assert_allclose(got["coarse"]["rgb"].numpy(), 1.0)


@pytest.mark.parametrize("mode", ["rays", "samples"])
def test_over_capacity_fallback_is_the_dense_render(mode):
    """More live elements than the capacity: the dense render from the same
    coarse draw, equal to the plain render on the same generator bit for bit."""
    rays = camera_rays(512)
    cfg = jrenderer.RenderConfig(n_coarse=16, n_fine=8, accel_mode=mode, accel_capacity=0.01,
                                 accel_capacity_rays=0.25)
    trenderer.reset_accel_counts()
    pruned = trender(rays, cfg, uniform_grid(rays, 16))
    assert trenderer.ACCEL_COUNTS["fallbacks"] >= 1 and trenderer.ACCEL_COUNTS["compacted"] == 0
    dense = trender(rays, cfg, None)
    for head in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            torch.testing.assert_close(pruned[head][k], dense[head][k], rtol=0, atol=0)


def test_all_occupied_grid_is_exact():
    rays = camera_rays(48)
    cfg = jrenderer.RenderConfig(n_coarse=16, accel_mode="samples", accel_capacity=1.0)
    trenderer.reset_accel_counts()
    pruned = trender(rays, cfg, uniform_grid(rays, 8))
    assert trenderer.ACCEL_COUNTS["compacted"] == 1
    dense = trender(rays, cfg, None)
    torch.testing.assert_close(pruned["coarse"]["rgb"], dense["coarse"]["rgb"], rtol=0, atol=1e-6)


def test_training_and_superbatch_ignore_the_grid():
    rays = np.stack([camera_rays(32, seed=s) for s in (5, 6)])  # SB 2
    grid = port_grid(sphere_grid(rays.reshape(-1, 8)))
    cfg = trenderer.RenderConfig(n_coarse=16, n_fine=8, accel_mode="samples")
    for r, training in ((rays, False), (rays[:1], True)):
        outs = [trenderer.render_rays(tsphere_field, torch.from_numpy(r), cfg,
                                      torch.Generator().manual_seed(0), use_viewdirs=False,
                                      accel=g, training=training) for g in (None, grid)]
        torch.testing.assert_close(outs[1]["fine"]["rgb"], outs[0]["fine"]["rgb"], rtol=0, atol=0)


def test_proposal_without_a_fine_pass_is_ray_compaction():
    rays = camera_rays(1024)
    grid = sphere_grid(rays)
    cfg = jrenderer.RenderConfig(n_coarse=32, n_fine=0, white_bkgd=True, accel_mode="proposal",
                                 accel_capacity_rays=0.75)
    ref = jrender(rays, cfg, grid)
    got = trender(rays, cfg, grid, jax_draws(jax.random.PRNGKey(3), 1024, cfg, capacity=768))
    assert set(got) == {"coarse"}
    close(got["coarse"]["rgb"], ref["coarse"]["rgb"], what="rgb")
    close(got["coarse"]["depth"], ref["coarse"]["depth"], what="depth")
    dense = trender(rays, cfg, None, jax_draws(jax.random.PRNGKey(3), 1024, cfg))
    np.testing.assert_allclose(got["coarse"]["rgb"].numpy(), dense["coarse"]["rgb"].numpy(),
                               atol=2e-3)


@pytest.mark.parametrize("sig", [None, 5e-3])
def test_an_empty_ray_has_depth_zero_in_both_branches(sig):
    """An empty grid (and one whose sigma sits under the threshold): the
    compacted branch's fill and the whole-pass proposal both give depth 0.0
    and background rgb on the coarse head."""
    rays = camera_rays(1024)
    grid = uniform_grid(rays, 16, occ_value=0.0, sig=sig, thresh=None if sig is None else 1e-2)
    base = dict(n_coarse=16, n_fine=8, n_fine_depth=4, white_bkgd=False, accel_mode="proposal",
                accel_proposal_samples=12)
    for cap in (0.1, 1.0):
        out = trender(rays, jrenderer.RenderConfig(**base, accel_capacity_rays=cap), grid)
        assert (out["coarse"]["depth"] == 0.0).all() and (out["coarse"]["rgb"] == 0.0).all()


def test_depth_draw_override_and_the_conf():
    from pixelnerf_tpu.config import hocon as jhocon
    from pixelnerf_tpu_torch.config import hocon

    rays = camera_rays(1024)
    grid = sphere_grid(rays)
    cfg = jrenderer.RenderConfig(**BASE, accel_mode="proposal", accel_proposal_samples=24,
                                 accel_depth_samples=4, accel_capacity_rays=0.75)
    ref = jrender(rays, cfg, grid)
    got = trender(rays, cfg, grid, jax_draws(jax.random.PRNGKey(3), 1024, cfg, proposal=True,
                                             capacity=768))
    assert got["fine"]["weights"].shape[-1] == ref["fine"]["weights"].shape[-1] == 28
    close(got["fine"]["rgb"], ref["fine"]["rgb"], what="fine rgb")
    assert trender(rays, cfg, None)["fine"]["weights"].shape[-1] == 48  # the dense union
    for text in ("n_coarse = 8\naccel_mode = proposal\naccel_depth_samples = 4\n",
                 "n_coarse = 8\naccel_depth_samples = -1\n", "n_coarse = 8\n",
                 "accel_capacity_fine = 0.3\naccel_probe_samples = 0\naccel_mode = samples\n"):
        assert (dataclasses.asdict(trenderer.RenderConfig.from_conf(hocon.parse_string(text)))
                == dataclasses.asdict(jrenderer.RenderConfig.from_conf(jhocon.parse_string(text))))
    with pytest.raises(ValueError, match="accel_mode"):
        trenderer.RenderConfig.from_conf(hocon.parse_string("accel_mode = fast\n"))


@pytest.mark.parametrize("cap", [0.75, 1.0])
def test_probe_count_is_decoupled_from_n_coarse(cap):
    """96 grid probes a ray under proposal with 32 coarse samples: the pdf
    over 96 bins, the union unchanged, JAX's render in the compacted and the
    whole-pass branch."""
    rays = camera_rays(1024)
    grid = sphere_grid(rays)
    cfg = jrenderer.RenderConfig(**BASE, accel_mode="proposal", accel_proposal_samples=24,
                                 accel_probe_samples=96, accel_capacity_rays=cap)
    ref = jrender(rays, cfg, grid)
    got = trender(rays, cfg, grid, jax_draws(jax.random.PRNGKey(3), 1024, cfg, proposal=True,
                                             capacity=capacity_rays(cfg, 1024)))
    assert got["coarse"]["weights"].shape[-1] == 96 and got["fine"]["weights"].shape[-1] == 32
    for head in ("coarse", "fine"):
        close(got[head]["rgb"], ref[head]["rgb"], what=f"{head} rgb")
        close(got[head]["depth"], ref[head]["depth"], what=f"{head} depth")


# ---------------------------------------------------------------------------
# the pipeline: capacity probe, capacity and chunk selection, gate
# ---------------------------------------------------------------------------


def march_rays(N, z0, far=0.3):
    """+z rays from (0, 0, z0[i]) over [0, far]."""
    o = np.zeros((N, 3), np.float32)
    o[:, 2] = z0
    return np.concatenate([o, np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (N, 1)),
                           np.zeros((N, 1), np.float32), np.full((N, 1), far, np.float32)], 1)


def jax_jitter(i, n, kc, d):
    """The JAX capacity probe's jitter draws of ray chunk ``i``."""
    return t(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(0), i), (d, n, kc)))


def test_capacity_probe_matches_jax():
    grid = slab_grid()
    rng = np.random.default_rng(5)
    rays = march_rays(512, 0.0)
    rays[:, :3] = rng.uniform(0.0, 1.0, (512, 3))
    rays[:, 7] = 0.25
    kc, D = 8, 4
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)  # the pipeline's first chunk's
    ref_live, ref_counts = jpipeline._capacity_probe(grid, jnp.asarray(rays), key, kc, D)
    live, counts = tpipeline._capacity_probe(port_grid(grid), t(rays), kc, D,
                                             jitter=jax_jitter(0, 512, kc, D - 1))
    np.testing.assert_array_equal(live.numpy(), np.asarray(ref_live))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    # the port's own draws: fixed by the generator's seed
    again = [tpipeline._capacity_probe(port_grid(grid), t(rays), kc, D,
                                       generator=torch.Generator().manual_seed(0))[0]
             for _ in range(2)]
    torch.testing.assert_close(again[0], again[1], rtol=0, atol=0)
    np.testing.assert_array_equal(again[0][0].numpy(), np.asarray(ref_live)[0])  # midpoints


def _pipes(cfg, grid, budget=None):
    jp = jpipeline.RenderPipeline.__new__(jpipeline.RenderPipeline)
    tp = tpipeline.RenderPipeline.__new__(tpipeline.RenderPipeline)
    jp.renderer, tp.renderer = jrenderer.NeRFRenderer(cfg), trenderer.NeRFRenderer(tcfg(cfg))
    jp.accel, tp.accel = grid, port_grid(grid)
    for p in (jp, tp):
        p.device_chunk, p.accel_chunk = 8192, None
        if budget is not None:
            p.point_budget = budget
    return jp, tp


def _same_selection(jp, tp):
    assert (jp.accel is None) == (tp.accel is None)
    assert jp.accel_chunk == tp.accel_chunk
    jc, tc = jp.renderer.base_cfg, tp.renderer.base_cfg
    assert (jc.accel_capacity_rays, jc.accel_capacity, jc.accel_capacity_fine) == \
        (tc.accel_capacity_rays, tc.accel_capacity, tc.accel_capacity_fine)


CASES = {
    # (mode, rays, ray_batch_size, grid, point budget, expected: accel kept, chunk)
    # the worst 512-ray window is the first, fully live: nothing to prune
    "window": ("rays", march_rays(2048, np.where(np.arange(2048) < 512, 0.1, 0.6)), 512,
               slab_grid(), None, (False, None)),
    # no -R hint: one window of the whole batch
    "whole": ("rays", march_rays(2048, np.where(np.arange(2048) < 512, 0.1, 0.6)), None,
              slab_grid(), None, (True, 65536)),
    # only the tail's partial window is live (padded with its last ray)
    "tail": ("rays", march_rays(1200, np.where(np.arange(1200) >= 1024, 0.1, 0.6)), 512,
             slab_grid(), None, (False, None)),
    # every ray crosses the slab: proposal keeps pruning on the sample
    # capacity, rays mode finds nothing to prune, a fog disables both
    "proposal_slab": ("proposal", march_rays(1024, 0.0, far=1.0), 1024, slab_grid(lo_z=3, hi_z=5),
                      None, (True, None)),
    "rays_slab": ("rays", march_rays(1024, 0.0, far=1.0), 1024, slab_grid(lo_z=3, hi_z=5), None,
                  (False, None)),
    "proposal_fog": ("proposal", march_rays(1024, 0.0, far=1.0), 1024, slab_grid(full=True),
                     None, (False, None)),
    # ~30% live everywhere: proposal takes the largest chunk within the
    # budget, rays mode at a tight budget 16384, an -R hint caps the chunk
    "budget_proposal": ("proposal", march_rays(65536, np.where(np.arange(65536) % 10 < 3, 0.1,
                                                                 0.6)),
                        None, slab_grid(), None, (True, 65536)),
    "budget_rays": ("rays", march_rays(65536, np.where(np.arange(65536) % 10 < 3, 0.1, 0.6)),
                    None, slab_grid(), 200_000, (True, 16384)),
    "budget_hint": ("proposal", march_rays(65536, np.where(np.arange(65536) % 10 < 3, 0.1, 0.6)),
                    4096, slab_grid(), None, (True, None)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_capacity_selection_matches_jax(case):
    mode, rays, hint, grid, budget, (kept, chunk) = CASES[case]
    cfg = jrenderer.RenderConfig(n_coarse=8, n_fine=4, n_fine_depth=2 if "budget" in case else 0,
                                 white_bkgd=True, accel_mode=mode, accel_proposal_samples=5)
    jp, tp = _pipes(cfg, grid, budget)
    jp._autoselect_capacity(rays, ray_batch_size=hint)
    tp._autoselect_capacity(rays, ray_batch_size=hint, jitter=jax_jitter)
    _same_selection(jp, tp)
    assert (tp.accel is not None, tp.accel_chunk) == (kept, chunk)
    if case == "whole":
        assert tp.renderer.base_cfg.accel_capacity_rays < 0.5
    if case == "proposal_slab":
        assert tp.renderer.base_cfg.accel_capacity_rays == 1.0
        assert tp.renderer.base_cfg.accel_capacity < 0.95


class FakeRenders:
    """render_simple stand-in: preset frames in call order."""

    def __init__(self, frames):
        self.frames = list(frames)

    def __call__(self, *a, **k):
        return self.frames.pop(0), None


REF, BAD = np.zeros((16, 3), np.float32), np.full((16, 3), 0.25, np.float32)


@pytest.mark.parametrize("frames,label", [
    ([REF], "proposal"), ([BAD, REF], "proposal+8"), ([BAD, BAD, REF], "proposal+16"),
    ([BAD, BAD, BAD, REF], "rays"), ([BAD, BAD, BAD, BAD], "dense"),
])
def test_gate_ladder_matches_jax(frames, label):
    """The gate on preset renders (the dense one passed in): the settled rung,
    each rung's PSNR, the kept config; a second gate restarts from the first
    proposal count."""
    cfg = jrenderer.RenderConfig(n_coarse=8, n_fine=4, accel_mode="proposal",
                                 accel_proposal_samples=16)
    jp, tp = _pipes(cfg, slab_grid())
    results = []
    for p, args in ((jp, (None, None, None, None, REF)), (tp, (None, None, 7, REF))):
        p._autoselect_capacity = lambda *a, **k: None
        p.render_simple = FakeRenders([f.copy() for f in frames])
        results.append(p.gate_accel_mode(*args))
    (jl, jps), (tl, tps) = results
    assert tl == jl == label and list(tps) == list(jps)
    np.testing.assert_allclose(list(tps.values()), list(jps.values()), rtol=1e-6)
    assert (tp.accel is None) == (jp.accel is None) == (label == "dense")
    for f in ("accel_mode", "accel_proposal_samples"):
        assert getattr(tp.renderer.base_cfg, f) == getattr(jp.renderer.base_cfg, f)
    if label == "proposal+8":  # the next object's gate starts at 16 draws again
        tp.accel = port_grid(slab_grid())
        tp.render_simple = FakeRenders([REF.copy()])
        assert tp.gate_accel_mode(None, None, 7, REF)[0] == "proposal"
        assert tp.renderer.base_cfg.accel_proposal_samples == 16


# ---------------------------------------------------------------------------
# the pipeline on the small PixelNeRF world
# ---------------------------------------------------------------------------


def _object_like(variables):
    """The fine head a copy of the coarse one, whose density is a steep
    ramp of its raw output (sigma = relu(100 raw - 700)) and whose colour
    rows are seeded: a field occupying ~1/8 of the box, in colour."""
    p = jax.tree.map(np.asarray, dict(variables))
    lin = p["params"]["mlp_coarse"]["lin_out"]
    k, b = np.array(lin["kernel"]), np.array(lin["bias"])
    k[:, 3] *= 100.0
    k[:, :3] = np.random.default_rng(7).normal(size=k[:, :3].shape) * 0.3
    b[3], b[:3] = -700.0, 0.0
    p["params"]["mlp_coarse"]["lin_out"] = {"kernel": k, "bias": b}
    p["params"]["mlp_fine"] = p["params"]["mlp_coarse"]
    return p


def pipeline_draws(rng, pipe):
    """``render_simple``'s per-chunk draws as the JAX pipeline makes them: a
    key split per dispatch, folded with the chunk index, then
    ``render_rays``' split, under the pipeline's config of the moment."""
    step = jax.random.split(rng)[1]

    def draws(i, rows):
        cfg = pipe.renderer.cfg
        on = pipe.accel is not None
        proposal = on and cfg.accel_mode == "proposal" and cfg.using_fine
        cap = capacity_rays(cfg, rows) if on and cfg.accel_mode != "samples" else rows
        return jax_draws(jax.random.fold_in(step, i), rows, cfg, proposal=proposal,
                         capacity=cap if cap < rows else None)

    return draws


def test_pipeline_build_gate_and_render_match_jax(monkeypatch):
    """``build_accel`` (JAX's probe directions and jitter), ``gate_accel_mode``
    and ``render_simple`` of the port's pipeline against JAX's on the same
    weights, JAX's draws fed: the grid, the capacities, every rung's PSNR
    (this field walks the whole ladder down to ``rays``) and the pruned
    frame; then ``PIXELNERF_ACCEL=0`` disables the build."""
    from pixelnerf_tpu.config import hocon as jhocon
    from pixelnerf_tpu.models import PixelNeRFNet as JNet
    from pixelnerf_tpu.models import make_model as jmake_model
    from pixelnerf_tpu_torch.config import hocon
    from pixelnerf_tpu_torch.data.synthetic import SyntheticDataset
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.utils.geometry import gen_rays_np, pose_spherical
    from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables
    from test_torch_model import CONF, IMG, _bump

    ds = SyntheticDataset(n_objs=1, n_views=3, image_size=IMG, seed=2)
    s = ds[0]
    images, poses, focal = s["images"][None, :1], s["poses"][None, :1], np.float32(s["focal"])
    jnet = jmake_model(jhocon.parse_string(CONF)["model"], mlp_impl="xla")
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                   jnp.asarray(poses), jnp.asarray(focal),
                                   jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 3)))
    variables = _object_like(_bump(variables))
    jscene = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(focal),
                        method=JNet.encode)
    net = make_model(hocon.parse_string(CONF)["model"], mlp_impl="torch", device="cpu")
    net.load_state_dict(from_jax_variables(variables))
    scene = net.encode(torch.from_numpy(images), torch.from_numpy(poses), float(focal))
    rays = gen_rays_np(np.stack([pose_spherical(a, -20.0, 1.3) for a in (40.0, 100.0)]), 16, 16,
                       focal / 2, ds.z_near, ds.z_far).reshape(-1, 8)
    cfg = jrenderer.RenderConfig(n_coarse=16, n_fine=8, n_fine_depth=4, white_bkgd=True,
                                 accel_mode="proposal", accel_proposal_samples=8,
                                 accel_probe_samples=16)
    jp = jpipeline.RenderPipeline(jnet, jrenderer.NeRFRenderer(cfg))
    tp = tpipeline.RenderPipeline(net, trenderer.NeRFRenderer(tcfg(cfg)))
    build = dict(resolution=16, n_dir_probes=2, ray_batch_size=256)
    jgrid = jp.build_accel(variables, jscene, rays, **build)
    dirs = jax.random.normal(jax.random.PRNGKey(0), (2, 3))
    dirs = t(dirs / (jnp.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-8))
    grid = tp.build_accel(scene, rays, dirs=dirs, jitter=jax_jitter, **build)
    np.testing.assert_array_equal(grid.occ.numpy(), np.asarray(jgrid.occ))
    close(grid.sig, jgrid.sig, what="sig")
    assert 0.05 < tp.accel_stats["occupancy"] < 0.5
    _same_selection(jp, tp)

    jlabel, jpsnrs = jp.gate_accel_mode(variables, jscene, rays[:256], jax.random.PRNGKey(11),
                                        ray_batch_size=256)
    label, psnrs = tp.gate_accel_mode(scene, rays[:256], 11, ray_batch_size=256,
                                      draws=pipeline_draws(jax.random.PRNGKey(11), tp))
    assert label == jlabel == "rays" and list(psnrs) == list(jpsnrs)
    np.testing.assert_allclose(list(psnrs.values()), list(jpsnrs.values()), atol=1e-2)
    _same_selection(jp, tp)
    assert tp.renderer.base_cfg.accel_mode == jp.renderer.base_cfg.accel_mode == "rays"

    ref, ref_depth = jp.render_simple(variables, jscene, rays, jax.random.PRNGKey(1),
                                      ray_batch_size=256)
    rgb, depth = tp.render_simple(scene, rays, None, ray_batch_size=256,
                                  draws=pipeline_draws(jax.random.PRNGKey(1), tp))
    close(rgb, ref, what="pruned rgb")
    close(depth, ref_depth, what="pruned depth")

    monkeypatch.setenv("PIXELNERF_ACCEL", "0")
    assert tp.build_accel(scene, rays) is None and tp.accel is None


@pytest.mark.parametrize("cap,branch", [(0.75, "compacted"), (0.1, "fallbacks")])
def test_accel_draw_order_follows_the_generator(cap, branch):
    """Draws left to the generator under proposal: the probe ladder's coarse
    jitter first, then the branch's importance u and jitter and depth noise,
    shaped by the capacity when the branch compacts."""
    B = 1024
    rays = camera_rays(B)
    cfg = jrenderer.RenderConfig(**BASE, accel_mode="proposal", accel_capacity_rays=cap)
    grid = sphere_grid(rays)
    trenderer.reset_accel_counts()
    out = trender(rays, cfg, grid, seed=5)
    assert trenderer.ACCEL_COUNTS[branch] == 1
    rows = capacity_rays(cfg, B) if branch == "compacted" else B
    g = torch.Generator().manual_seed(5)
    coarse = torch.rand(B, cfg.accel_probe_samples, generator=g)
    fine = RayDraws(fine_u=torch.rand(rows, 16, generator=g),
                    fine_jitter=torch.rand(rows, 16, generator=g),
                    depth=torch.randn(rows, 8, generator=g))
    draws = (RayDraws(coarse=coarse, compacted=fine) if branch == "compacted"
             else dataclasses.replace(fine, coarse=coarse))
    again = trender(rays, cfg, grid, draws)
    for head in ("coarse", "fine"):
        for k in out[head]:
            torch.testing.assert_close(out[head][k], again[head][k], rtol=0, atol=0)
