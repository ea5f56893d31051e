"""The ray-sharded render (``RenderPipeline(mesh=make_ray_mesh())``) over 2
ranks against one rank and the JAX package's single-device render, on the
CPU (gloo).  Rank bodies: ``parallel.dryrun.run_legs`` (the one-rank
reference in the test's process); ``spawn`` hands rank 0's results back
to the test.

The model is ``test_torch_train_step``'s (its JAX variables, a live
``fc_1``), the rays two 24 x 24 views of its synthetic object 0 (1152
rays).
Bars: a 2-rank render against one rank in f32 within 1e-6 (the plain
field's matmuls see other row counts), the u8 wire format exact; against
the JAX render ``test_torch_model``'s 1e-4 of max(1, max|ref|) dense, and
with the occupancy grid the JAX mesh test's atol 2e-5
(``tests/test_accel.py::test_mesh_sharded_accel_render_matches_single_device``:
a half-occupied 8^3 grid, ``proposal``, ray capacity 0.75, at its R 128,
where a chunk is below the 256-ray capacity floor and renders whole, and at
R 1024, where it compacts), JAX's draws fed to the port."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.models import PixelNeRFNet as JNet
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.parallel import pipeline as jpipeline
from pixelnerf_tpu.render import accel as jaccel
from pixelnerf_tpu.render import renderer as jrenderer
from pixelnerf_tpu_torch.parallel import dryrun, launch
from pixelnerf_tpu_torch.render import renderer as trenderer
from pixelnerf_tpu_torch.render.accel import aabb_from_rays
from pixelnerf_tpu_torch.utils.geometry import gen_rays_np
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables
from test_torch_accel import pipeline_draws
from test_torch_model import TOL, close
from test_torch_train_step import CONF, setup  # noqa: F401

IMG = 24
ACCEL = dict(n_coarse=8, n_fine=6, n_fine_depth=2, white_bkgd=True, accel_mode="proposal",
             accel_proposal_samples=8, accel_capacity_rays=0.75)
DENSE = dict(n_coarse=8, n_fine=6, n_fine_depth=3, white_bkgd=True)


def _grid(rays):
    """Half of the rays' box occupied (x below the middle), as the JAX test."""
    lo, hi = aabb_from_rays(rays)
    R = 8
    c = (np.arange(R) + 0.5) / R
    gx, _, _ = np.meshgrid(c, c, c, indexing="ij")
    return dict(occ=(gx < 0.5).astype(np.float32).reshape(-1), lo=np.asarray(lo, np.float32),
                inv_cell=(R / (np.asarray(hi) - np.asarray(lo))).astype(np.float32), resolution=R)


def _np(d):
    """A RayDraws of tensors as the rank body's nested numpy dict."""
    if d is None:
        return None
    return {k: (_np(v) if k == "compacted" else np.asarray(v)) for k, v in vars(d).items()
            if v is not None}


def _jax_chunk_draws(key, cfg_kw, grid, rows, n_chunks):
    """JAX's draws of each chunk of ``render_simple`` (``pipeline_draws``)."""
    pipe = types.SimpleNamespace(renderer=types.SimpleNamespace(
        cfg=trenderer.RenderConfig(**cfg_kw)), accel=grid)
    draws = pipeline_draws(key, pipe)
    return [_np(draws(i, rows)) for i in range(n_chunks)]


@pytest.fixture(scope="module")
def world(setup):  # noqa: F811
    s = setup["jds"][0]
    focal = np.float32(s["focal"])
    rays = gen_rays_np(s["poses"][1:3], IMG, IMG, float(focal), 0.8, 1.8).reshape(-1, 8)
    src = dict(images=s["images"][None, :1], poses=s["poses"][None, :1], focal=focal,
               rays=rays.astype(np.float32))
    return dict(src=src, grid=_grid(rays), focal=focal, sample=s)


@pytest.fixture(scope="module")
def jax_renders(setup, world):  # noqa: F811
    """JAX's single-device render_simple, dense (R 96) and on the grid (R 128
    and 1024)."""
    conf = jhocon.parse_string(CONF)
    jnet = jmake_model(conf["model"], mlp_impl="xla")
    variables = setup["variables"]
    s = world["sample"]
    scene = jnet.apply(variables, jnp.asarray(s["images"][None, :1]),
                       jnp.asarray(s["poses"][None, :1]), jnp.asarray(world["focal"]),
                       method=JNet.encode)
    g = world["grid"]
    grid = jaccel.OccupancyGrid(occ=jnp.asarray(g["occ"]), lo=jnp.asarray(g["lo"]),
                                inv_cell=jnp.asarray(g["inv_cell"]), resolution=g["resolution"])
    out = {}
    for name, cfg, R, acc in (("dense", DENSE, 96, None), ("accel", ACCEL, 128, grid),
                              ("accel_compact", ACCEL, 1024, grid)):
        pipe = jpipeline.RenderPipeline(jnet, jrenderer.NeRFRenderer(
            jrenderer.RenderConfig(**cfg)))
        pipe.accel = acc
        out[name] = pipe.render_simple(variables, scene, world["src"]["rays"],
                                       jax.random.PRNGKey(5), ray_batch_size=R)
    return out


@pytest.fixture(scope="module")
def runs(setup, world):  # noqa: F811
    """The legs on one rank (this process) and on 2 ranks."""
    src, grid = world["src"], world["grid"]
    n_rays = src["rays"].shape[0]
    key = jax.random.PRNGKey(5)
    legs = [
        dict(src, kind="render", name="weights", method="render", R=100, cfg=DENSE),
        dict(src, kind="render", name="f32", R=100, cfg=DENSE),
        dict(src, kind="render", name="u8", R=100, cfg=DENSE, pack="u8"),
        dict(src, kind="render", name="jax_dense", R=96, cfg=DENSE,
             draws=_jax_chunk_draws(key, DENSE, None, 96, n_rays // 96)),
        dict(src, kind="render", name="jax_accel", R=128, cfg=ACCEL, grid=grid,
             draws=_jax_chunk_draws(key, ACCEL, grid, 128, -(-n_rays // 128))),
        dict(src, kind="render", name="jax_accel_compact", R=1024, cfg=ACCEL, grid=grid,
             draws=_jax_chunk_draws(key, ACCEL, grid, 1024, -(-n_rays // 1024))),
        dict(src, kind="render", name="rays", R=1024, grid=grid,
             cfg=dict(ACCEL, accel_mode="rays", accel_capacity_rays=0.55)),
        dict(src, kind="render", name="rays_fallback", R=1024, grid=grid,
             cfg=dict(ACCEL, accel_mode="rays", accel_capacity_rays=0.1)),
        dict(src, kind="render", name="samples", R=1024, grid=grid,
             cfg=dict(ACCEL, accel_mode="samples", accel_capacity=0.4,
                      accel_capacity_fine=0.4)),
        dict(src, kind="render", name="samples_fallback", R=1024, grid=grid,
             cfg=dict(ACCEL, accel_mode="samples", accel_capacity=0.05,
                      accel_capacity_fine=0.05)),
    ]
    state = {k: v.numpy() for k, v in from_jax_variables(setup["variables"]).items()}
    out = {}
    for n in (1, 2):
        spec = dict(conf=CONF, impl="torch", device="cpu", state=state,
                    legs=[dict(leg, sharded=n > 1) for leg in legs])
        out[n] = (dryrun.run_legs(spec) if n == 1
                  else launch.spawn(dryrun.run_legs, [0, 1], "cpu", spec))
    return out


def _arrays(res):
    """(path, array) of a render leg's heads."""
    for k, v in res.items():
        if isinstance(v, dict) and k != "accel_counts":
            for kk, vv in v.items():
                yield f"{k}.{kk}", vv
        elif isinstance(v, np.ndarray):
            yield k, v


@pytest.mark.parametrize("leg", ["weights", "f32", "jax_dense", "jax_accel", "jax_accel_compact",
                                 "rays", "rays_fallback", "samples", "samples_fallback"])
def test_two_ranks_render_as_one(runs, leg):
    one, two = dict(_arrays(runs[1][leg])), dict(_arrays(runs[2][leg]))
    assert sorted(one) == sorted(two) and one
    for k, v in one.items():
        assert two[k].shape == v.shape and np.isfinite(two[k]).all()
        np.testing.assert_allclose(two[k], v, rtol=0, atol=1e-6, err_msg=f"{leg} {k}")
    # each rank took the same branch as one device (counts are per rank)
    assert runs[2][leg]["accel_counts"] == runs[1][leg]["accel_counts"]
    assert len(runs[2][leg]["rank_wall_s"]) == 2


def test_u8_wire_is_exact(runs):
    for k in ("rgb", "depth"):
        np.testing.assert_array_equal(runs[2]["u8"][k], runs[1]["u8"][k])


def test_pruned_branches_were_taken(runs):
    """The accel legs exercised the compacted and the fallback branch of
    each mode."""
    c = {leg: runs[2][leg]["accel_counts"] for leg in
         ("jax_accel_compact", "rays", "rays_fallback", "samples", "samples_fallback")}
    assert c["jax_accel_compact"]["compacted"] > 0 and c["rays"]["compacted"] > 0
    assert c["rays_fallback"]["fallbacks"] > 0
    assert c["samples"]["compacted"] > 0
    assert c["samples_fallback"]["fallbacks"] > 0


def test_sharded_render_matches_jax(runs, jax_renders):
    rgb, depth = jax_renders["dense"]
    close(runs[2]["jax_dense"]["rgb"], rgb, TOL, "dense rgb")
    close(runs[2]["jax_dense"]["depth"], depth, TOL, "dense depth")


@pytest.mark.parametrize("leg", ["accel", "accel_compact"])
def test_sharded_accel_render_matches_jax_single_device(runs, jax_renders, leg):
    rgb, depth = jax_renders[leg]
    got = runs[2]["jax_" + leg]
    assert np.isfinite(got["rgb"]).all()
    np.testing.assert_allclose(got["rgb"], np.asarray(rgb), atol=2e-5)
    np.testing.assert_allclose(got["depth"], np.asarray(depth), atol=2e-5)
