"""The port's model and render slice against the JAX package, in f32 on the
CPU, with one set of weights carried JAX -> port by ``from_jax_variables``:
the weight round trip, encode, feature indexing, query on every route, and
``render_rays`` with JAX's own random draws injected.

Tolerance: 1e-4 of max(1, max|ref|) -- XLA:CPU and torch reassociate f32
convolution and matmul sums differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.models import PixelNeRFNet as JPixelNeRFNet
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.models.encoder import SpatialEncoder as JSpatialEncoder
from pixelnerf_tpu.render import renderer as jrenderer
from pixelnerf_tpu.utils import torch_convert
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data.synthetic import SyntheticDataset
from pixelnerf_tpu_torch.models import PixelNeRFNet, make_model
from pixelnerf_tpu_torch.models.encoder import SpatialEncoder
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.render import RayDraws, RenderConfig, render_rays
from pixelnerf_tpu_torch.render import rays as trays
from pixelnerf_tpu_torch.utils.geometry import gen_rays_np, pose_spherical
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

TOL = 1e-4
CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 6\n freq_factor = 1.5\n include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet\n n_blocks = 3\n d_hidden = 64\n combine_layer = 2\n combine_type = average }
    mlp_fine { type = resnet\n n_blocks = 3\n d_hidden = 64\n combine_layer = 2\n combine_type = average }
    encoder { backbone = resnet34\n pretrained = False\n num_layers = 2\n use_first_pool = False }
}
"""
IMG = 32


def close(port, ref, tol=TOL, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    bar = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bar, f"{what} max|d| {err:.3g} > {bar:.3g}"


def _bump(variables, seed=3):
    """Non-trivial weights: random fc_1 (zero at init), MLP biases and BN
    statistics/affines, so every layer and both BN terms matter."""
    rng = np.random.default_rng(seed)

    def visit(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = visit(v, p)
                continue
            v = np.array(v, np.float32)
            if "fc_1" in p and k == "kernel":
                v = rng.normal(size=v.shape).astype(np.float32) * 0.1
            elif p[0] == "params" and p[1].startswith("mlp") and k == "bias":
                v = rng.normal(size=v.shape).astype(np.float32) * 0.1
            elif k == "mean":
                v = rng.normal(size=v.shape).astype(np.float32) * 0.1
            elif k == "var":
                v = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
            elif k == "scale":
                v = rng.uniform(0.8, 1.2, size=v.shape).astype(np.float32)
            out[k] = v
        return out

    return visit(jax.tree.map(np.asarray, dict(variables)), ())


@pytest.fixture(scope="module")
def world():
    """Source view, query points, JAX variables, and the encoded JAX scene."""
    ds = SyntheticDataset(n_objs=1, n_views=3, image_size=IMG, seed=2)
    s = ds[0]
    images, poses = s["images"][None, :1], s["poses"][None, :1]
    focal = np.float32(s["focal"])
    rng = np.random.default_rng(9)
    B = 70
    xyz = (rng.normal(size=(1, B, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(1, B, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    conf = jhocon.parse_string(CONF)
    jnet = jmake_model(conf["model"], mlp_impl="xla")
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(poses),
                                   jnp.asarray(focal), jnp.asarray(xyz), jnp.asarray(vd))
    variables = _bump(variables)
    jscene = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(focal),
                        method=JPixelNeRFNet.encode)
    rays = gen_rays_np(pose_spherical(40.0, -20.0, 1.3)[None], IMG, IMG, focal,
                       ds.z_near, ds.z_far).reshape(-1, 8)[::9][:64]
    return dict(images=images, poses=poses, focal=focal, xyz=xyz, vd=vd, conf=conf,
                variables=variables, jscene=jscene, rays=rays)


def _port(world, impl):
    net = make_model(hocon.parse_string(CONF)["model"], mlp_impl=impl, device="cpu")
    net.load_state_dict(from_jax_variables(world["variables"]))
    scene = net.encode(torch.from_numpy(world["images"]), torch.from_numpy(world["poses"]),
                       float(world["focal"]))
    return net, scene


def test_weight_round_trip_through_convert_pixelnerf(world):
    net, _ = _port(world, "torch")
    back = torch_convert.convert_pixelnerf(net.state_dict())
    assert torch_convert.tree_shapes_match(back, world["variables"]) == []
    flat_a, flat_b = jax.tree_util.tree_flatten_with_path(back)[0], \
        jax.tree_util.tree_flatten_with_path(world["variables"])[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_encode_matches_jax(world):
    _, scene = _port(world, "torch")
    js = world["jscene"]
    close(scene.latents, js.latents, what="latents")
    close(scene.poses, js.poses, what="poses")
    close(scene.focal, js.focal, what="focal")
    close(scene.c, js.c, what="c")
    assert scene.image_shape == tuple(js.image_shape)


@pytest.mark.parametrize("normalize", ["image", "feature"])
def test_index_and_index_taps_match_jax(world, normalize):
    lat = np.asarray(world["jscene"].latents)
    uv = np.random.default_rng(4).uniform(-3, IMG + 3, size=(1, 90, 2)).astype(np.float32)
    kw = dict(backbone="resnet34", num_layers=2, index_normalize=normalize)
    jenc = JSpatialEncoder(**kw)
    with torch.device("meta"):
        enc = SpatialEncoder(**kw)
    L, U = torch.from_numpy(np.array(lat)), torch.from_numpy(uv)
    close(enc.index(L, U, (IMG, IMG)), jenc.index(jnp.asarray(lat), jnp.asarray(uv), (IMG, IMG)))
    idx, w = enc.index_taps(L, U, (IMG, IMG))
    jidx, jw = jenc.index_taps(jnp.asarray(lat), jnp.asarray(uv), (IMG, IMG))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(w, jw)


@pytest.fixture(scope="module")
def jax_query(world):
    """Memoized JAX query outputs per (mlp_impl, gather cap, planar)."""
    cache = {}

    def get(impl, cap, planar, monkeypatch):
        key = (impl, cap, planar)
        if key not in cache:
            monkeypatch.setenv("PIXELNERF_PALLAS_INTERPRET", "1")
            monkeypatch.setenv("PIXELNERF_FUSED_GATHER_MAX_ROWS", str(cap))
            jnet = jmake_model(world["conf"]["model"], mlp_impl=impl)
            cache[key] = [
                np.asarray(jnet.apply(world["variables"], world["jscene"],
                                      jnp.asarray(world["xyz"]), viewdirs=jnp.asarray(world["vd"]),
                                      coarse=coarse, planar_out=planar,
                                      method=JPixelNeRFNet.query))
                for coarse in (True, False)
            ]
        return cache[key]

    return get


@pytest.mark.parametrize(
    "impl,jimpl,cap,planar",
    [
        ("cuda", "pallas", 2048, True),  # fused-gather route
        ("cuda", "pallas", 0, True),  # dense route
        ("cuda", "pallas", 2048, False),
        ("torch", "xla", 2048, True),
        ("auto", "xla", 2048, False),  # CPU tensors: plain forward of the gather
    ],
)
def test_query_matches_jax(world, jax_query, monkeypatch, impl, jimpl, cap, planar):
    refs = jax_query(jimpl, cap, planar, monkeypatch)
    monkeypatch.setenv("PIXELNERF_FUSED_GATHER_MAX_ROWS", str(cap))
    net, scene = _port(world, impl)
    assert net._fused_gather_ok(scene.latents, 1) == (impl != "torch" and cap > 0)
    rf.reset_launches()
    for coarse, ref in zip((True, False), refs):
        with torch.no_grad():  # an eval query: the fused-gather route is eval-only
            out = net.query(scene, torch.from_numpy(world["xyz"]), torch.from_numpy(world["vd"]),
                            coarse=coarse, planar_out=planar)
        close(out, ref, what=f"coarse={coarse}")
    assert not any(rf.LAUNCHES.values())  # CPU tensors never launch a kernel


@pytest.mark.parametrize("act", ["softplus", "softplus_floor"])
def test_sigma_activations_match_jax(act):
    text = CONF.replace("use_encoder = True", f"use_encoder = True\n    sigma_activation = {act}")
    jnet = jmake_model(jhocon.parse_string(text)["model"])
    with torch.device("meta"):
        net = PixelNeRFNet(hocon.parse_string(text)["model"])
    raw = np.linspace(-8, 8, 33, dtype=np.float32)
    ref = jnet.apply({}, jnp.asarray(raw), method=lambda m, r: m._sigma_act(r))
    close(net._sigma_act(torch.from_numpy(raw)), ref)


@pytest.fixture(scope="module")
def jax_render(world):
    """JAX render_rays (XLA field) and the draws its key split gives."""
    cfg = jrenderer.RenderConfig(n_coarse=8, n_fine=6, n_fine_depth=3, white_bkgd=True,
                                 depth_std=0.05, eval_batch_size=0)
    jnet = jmake_model(world["conf"]["model"], mlp_impl="xla")
    rays = jnp.asarray(world["rays"])[None]
    rng = jax.random.PRNGKey(5)

    @jax.jit
    def run(variables, scene, rays, rng):
        def field(points, viewdirs, coarse):
            return jnet.apply(variables, scene, points, viewdirs=viewdirs, coarse=coarse,
                              planar_out=True, method=JPixelNeRFNet.query)

        return jrenderer.render_rays(field, rays, rng, cfg, want_weights=True)

    out = jax.tree.map(np.asarray, run(world["variables"], world["jscene"], rays, rng))
    B = rays.shape[1]
    k_c, _, k_f, k_d, _ = jax.random.split(rng, 5)
    k_u, k_j = jax.random.split(k_f)
    n_imp = cfg.n_fine - cfg.n_fine_depth
    draws = dict(
        coarse=jax.random.uniform(k_c, (B, cfg.n_coarse)),
        fine_u=jax.random.uniform(k_u, (B, n_imp), dtype=jnp.float32),
        fine_jitter=jax.random.uniform(k_j, (B, n_imp)),
        depth=jax.random.normal(k_d, (B, cfg.n_fine_depth)),
    )
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    port_cfg = RenderConfig(n_coarse=8, n_fine=6, n_fine_depth=3, white_bkgd=True,
                            depth_std=0.05, eval_batch_size=0)
    return out, draws, port_cfg


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_render_rays_matches_jax(world, jax_render, impl):
    """The whole slice: encode, query on the route ``impl`` picks, samplers,
    compositing -- fine rgb and depth against JAX's render_rays fed the
    same draws."""
    ref, draws, cfg = jax_render
    net, scene = _port(world, impl)

    def field(points, viewdirs, coarse):
        return net.query(scene, points, viewdirs=viewdirs, coarse=coarse, planar_out=True)

    rays = torch.from_numpy(world["rays"])[None]
    with torch.no_grad():
        out = render_rays(field, rays, cfg, draws=RayDraws(**draws), want_weights=True)
    close(out["coarse"]["weights"], ref["coarse"]["weights"], what="coarse weights")
    # the importance draw inverts the coarse CDF: name any inverse-CDF index
    # that flipped (a bin change is not a rounding difference)
    n_imp = cfg.n_fine - cfg.n_fine_depth
    zp = trays.sample_fine(rays[0], out["coarse"]["weights"][0], n_imp, cfg.n_coarse,
                           u=draws["fine_u"], jitter=torch.zeros_like(draws["fine_jitter"]))
    zj = trays.sample_fine(rays[0], torch.from_numpy(np.array(ref["coarse"]["weights"][0])), n_imp,
                           cfg.n_coarse, u=draws["fine_u"],
                           jitter=torch.zeros_like(draws["fine_jitter"]))
    flipped = torch.nonzero(~torch.isclose(zp, zj, rtol=0, atol=1e-5)).tolist()
    assert not flipped, f"inverse-CDF index flipped at (ray, sample) {flipped}"
    for head in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            close(out[head][k], ref[head][k], what=f"{head} {k}")
