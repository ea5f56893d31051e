"""The fork's remaining model options in the port, against the JAX package
on the CPU: ``grid_sample`` (every mode and padding, ties at .5 included),
the nearest lookup, ``GlobalEncoder``, ``ConvEncoder`` (each layer, at two
image sizes), ``ImplicitNet`` (init and forward), their weights through
``from_jax_variables`` and back through ``convert_pixelnerf``, ``query`` and
``render_rays`` with each option from 1 and 3 source views, three trainer
steps with the global encoder and with the ConvEncoder against the JAX
trainer, and each option from a conf file through a checkpoint and the
port's eval and gen_video CLIs.

The models are small (a resnet18 trunk of 2 stages, 32 px images, heads of
3 x 48), seeded from numpy, every parameter live.  Bars: 1e-4 of max(1,
max|ref|) for the modules, query and render (f32 sums reassociated); the
trainer's of ``tests/test_torch_train_step.py`` (loss rtol 2e-3, grad norm
rtol 5e-3)."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.data import SyntheticDataset as JSyntheticDataset
from pixelnerf_tpu.data.loader import collate as jcollate
from pixelnerf_tpu.models import PixelNeRFNet as JPixelNeRFNet
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.models.custom_encoder import ConvEncoder as JConvEncoder
from pixelnerf_tpu.models.encoder import GlobalEncoder as JGlobalEncoder
from pixelnerf_tpu.models.encoder import SpatialEncoder as JSpatialEncoder
from pixelnerf_tpu.models.mlp import ImplicitNet as JImplicitNet
from pixelnerf_tpu.render import NeRFRenderer as JNeRFRenderer
from pixelnerf_tpu.render import renderer as jrenderer
from pixelnerf_tpu.train.trainer import Trainer as JTrainer
from pixelnerf_tpu.utils.torch_convert import convert_pixelnerf
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import SyntheticDataset
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.models.custom_encoder import ConvEncoder
from pixelnerf_tpu_torch.models.encoder import GlobalEncoder, SpatialEncoder
from pixelnerf_tpu_torch.models.mlp import ImplicitNet
from pixelnerf_tpu_torch.ops.grid_sample import grid_sample
from pixelnerf_tpu_torch.render import NeRFRenderer, RayDraws, RenderConfig, render_rays
from pixelnerf_tpu_torch.train import Trainer
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables
from test_torch_train_step import CONF, _Args, _jax_draws

jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")
TOL = 1e-4
IMG = 32
OPTIONS = ("global", "conv", "mlp", "nearest")


def close(port, ref, tol=TOL, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    bar = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bar, f"{what} max|d| {err:.3g} > {bar:.3g}"


def live(variables, seed=3):
    """Every parameter live: random fc_1 kernels and biases, BatchNorm
    statistics and scales, GroupNorm scales."""
    rng = np.random.default_rng(seed)

    def visit(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = visit(v, path + (k,))
                continue
            v = np.array(v, np.float32)
            if "fc_1" in path and k == "kernel":
                v = rng.normal(size=v.shape).astype(np.float32) * 0.1
            elif k in ("bias", "mean"):
                v = rng.normal(size=v.shape).astype(np.float32) * 0.1
            elif k in ("scale", "var"):
                v = rng.uniform(0.7, 1.3, size=v.shape).astype(np.float32)
            out[k] = v
        return out

    return visit(jax.tree.map(np.asarray, dict(variables)), ())


def option_conf(what):
    """``tests/test_torch_train_step.py``'s small conf with ``what`` on, in
    both packages' trees: the global encoder (a resnet18 code of 16), the
    ConvEncoder, ImplicitNet heads (a skip at layer 1, the views' mean at
    layer 2) or the nearest lookup."""
    out = []
    for parser in (jhocon, hocon):
        conf = parser.parse_string(CONF)
        if what == "global":
            conf.put("model.use_global_encoder", True)
            conf.put("model.global_encoder.backbone", "resnet18")
            conf.put("model.global_encoder.latent_size", 16)
            conf.put("model.global_encoder.pretrained", False)
        elif what == "conv":
            conf.put("model.encoder.type", "conv")
        elif what == "mlp":
            for head in ("mlp_coarse", "mlp_fine"):
                conf.put(f"model.{head}.type", "mlp")
                conf.put(f"model.{head}.dims", [48, 48, 48])
                conf.put(f"model.{head}.skip_in", [1])
                conf.put(f"model.{head}.combine_layer", 2)
                conf.put(f"model.{head}.dim_excludes_skip", True)
        else:
            conf.put("model.encoder.index_interp", "nearest")
        out.append(conf)
    return out


# ----------------------------------------------------------------------------
# grid_sample and the nearest lookup
# ----------------------------------------------------------------------------


def _grid_points(H, W, N, seed):
    """Points in and around [-1, 1]: random ones, exact .5 feature
    coordinates in x and y (where nearest mode's rounding decides), the
    corners, far outside, and NaN / inf."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.3, 1.3, size=(2, N, 2)).astype(np.float32)
    half = (np.arange(W - 1) + 0.5) * 2.0 / (W - 1) - 1.0  # x = k + .5, align_corners
    uv[0, : W - 1] = np.stack([half, -np.ones_like(half)], axis=-1)  # on row 0
    uv[1, : H - 1, 1] = (np.arange(H - 1) + 0.5) * 2.0 / (H - 1) - 1.0
    uv[0, W: W + 4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    uv[1, H: H + 4] = [[30.0, -40.0], [np.nan, 0.2], [np.inf, -np.inf], [-1.2, 1.26]]
    return uv


@pytest.mark.parametrize("padding", ["border", "zeros", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(mode, padding):
    """Every mode x padding against the JAX ``grid_sample``, with points at
    exact .5 feature coordinates kept (the JAX test of the reference nudges
    them away: here the port follows JAX's rounding, half to even)."""
    H, W, C = 5, 7, 6
    feat = np.random.default_rng(1).normal(size=(2, H, W, C)).astype(np.float32)
    uv = _grid_points(H, W, 97, seed=2)
    ref = np.asarray(jgs.grid_sample(jnp.asarray(feat), jnp.asarray(uv), align_corners=True,
                                     padding_mode=padding, mode=mode))
    out = grid_sample(torch.from_numpy(feat), torch.from_numpy(uv), align_corners=True,
                      padding_mode=padding, mode=mode)
    close(out, ref, tol=1e-6, what=f"{mode}/{padding}")
    if mode == "nearest":  # ties: x = 1.5 rounds to 2, 2.5 to 2 (half to even)
        np.testing.assert_array_equal(out[0, 1].numpy(), feat[0, 0, 2])
        np.testing.assert_array_equal(out[0, 2].numpy(), feat[0, 0, 2])


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_spatial_encoder_index_nearest_matches_jax(padding):
    """``SpatialEncoder.index`` with ``index_interp = "nearest"``: the JAX
    lookup (``grid_sample`` nearest, ``align_corners=True``) on the same
    map, bf16 kept bf16."""
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    uv = rng.uniform(-3.0, 21.0, size=(2, 150, 2)).astype(np.float32)
    uv[0, :10, 0] = (np.arange(10) + 0.5) * 18.0 / 11  # x = k + .5 on the map
    jenc = JSpatialEncoder(index_interp="nearest", index_padding=padding)
    ref = np.asarray(jenc.index(jnp.asarray(lat), jnp.asarray(uv), (18.0, 16.0)))
    with torch.device("meta"):
        enc = SpatialEncoder(backbone="resnet18", num_layers=2, index_interp="nearest",
                             index_padding=padding)
    out = enc.index(torch.from_numpy(lat), torch.from_numpy(uv), (18.0, 16.0))
    close(out, ref, tol=0.0, what="nearest index")
    lat16 = torch.from_numpy(lat).bfloat16()
    assert enc.index(lat16, torch.from_numpy(uv), (18.0, 16.0)).dtype == torch.bfloat16


# ----------------------------------------------------------------------------
# the modules
# ----------------------------------------------------------------------------


def _port_module(module, variables, prefix):
    """``variables`` of a JAX module mounted at ``prefix`` of the model,
    loaded (strictly) into the port ``module``."""
    sd = from_jax_variables({c: {prefix: t} for c, t in variables.items()})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()}, strict=True)
    return module


@pytest.mark.parametrize("latent_size", [16, 512])
def test_global_encoder_matches_jax(latent_size):
    """A resnet18 trunk of 5 stages with its first pool, the spatial mean,
    then ``fc`` when 512 != latent_size (none at 512), in eval mode on the
    running statistics and in train mode on the batch's."""
    x = np.random.default_rng(5).uniform(-1, 1, size=(3, 40, 36, 3)).astype(np.float32)
    jm = JGlobalEncoder(backbone="resnet18", latent_size=latent_size)
    v = live(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = _port_module(GlobalEncoder("resnet18", latent_size), v, "global_encoder")
    assert (port.fc is None) == (latent_size == 512) == ("fc" not in v["params"])
    for train in (False, True):
        ref = jm.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"] if train else False)
        ref = np.asarray(ref[0] if train else ref)
        port.train(train)
        close(port(torch.from_numpy(x)), ref, what=f"train={train}")


@pytest.mark.parametrize("size", [(32, 32), (96, 80)])
def test_conv_encoder_matches_jax_layer_by_layer(size):
    """Every layer's output shape and values against flax (SAME padding of
    the strided and transposed convolutions, the bottleneck's NHWC
    flattening, GroupNorm), at a 1-cell bottleneck (32 px) and at a 2 x 2
    one (96 x 80: ``deconv2`` 4 x 128 + 256 wide, taken from the JAX
    variables when they load), and its ``index``."""
    H, W = size
    x = np.random.default_rng(6).uniform(-1, 1, size=(2, H, W, 3)).astype(np.float32)
    jm = JConvEncoder()
    v = live(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref, inter = jm.apply(v, jnp.asarray(x), capture_intermediates=True)
    inter = {k: r for k, r in inter["intermediates"].items() if k != "__call__"}
    with torch.device("meta"):
        port = ConvEncoder()
    port = port.to_empty(device="cpu")
    port = _port_module(port, v, "encoder")
    got = {}
    for name, mod in port.named_children():
        mod.register_forward_hook(lambda m, i, o, name=name: got.__setitem__(name, o))
    out = port(torch.from_numpy(x))
    assert out.shape == (2, 16 * -(-H // 16), 16 * -(-W // 16), 128)
    close(out, np.asarray(ref), what="output")
    assert len(got) == len(inter) == 2 * 3 + 2 * 3 + 5
    for name, r in inter.items():
        close(got[name].permute(0, 2, 3, 1), np.asarray(r["__call__"][0]), what=name)
    uv = np.random.default_rng(7).uniform(-2, W + 2, size=(2, 50, 2)).astype(np.float32)
    jidx = np.asarray(jm.apply(v, ref, jnp.asarray(uv), (float(W), float(H)),
                               method=JConvEncoder.index))
    close(port.index(out, torch.from_numpy(uv), (float(W), float(H))), jidx, what="index")


def _implicit(d_in, **kw):
    jm = JImplicitNet(d_in=d_in, **kw)
    port = ImplicitNet(d_in, **kw)
    return jm, port


def test_implicit_net_init_follows_flax():
    """The geometric init's structure against flax's: the positional-code
    columns zero at layer 0 and at the skip layer, zero biases but the
    last layer's ``radius_init``, its first output near -sqrt(pi / fan_in)
    * sdf_scale, the hidden layers' spread sqrt(2 / fan_out)."""
    kw = dict(dims=[256, 256, 256], skip_in=(2,), dim_excludes_skip=True, sdf_scale=0.5)
    d_in = 39
    jm, port = _implicit(d_in, **kw)
    jv = jm.init(jax.random.PRNGKey(2), jnp.zeros((4, d_in)))["params"]
    port.reset_parameters(torch.Generator().manual_seed(2))
    sd = from_jax_variables({"params": {"mlp_coarse": jv}})
    mine = dict(port.named_parameters())
    assert sorted(k[len("mlp_coarse."):] for k in sd) == sorted(mine)
    for k, ref in sd.items():
        ref, got = ref.numpy(), mine[k[len("mlp_coarse."):]].detach().numpy()
        assert ref.shape == got.shape, k
        if k.endswith("bias"):
            np.testing.assert_array_equal(got, ref)
            continue
        np.testing.assert_array_equal(got == 0, ref == 0, err_msg=k)
        if k.endswith("lin3.weight"):  # the last layer
            np.testing.assert_allclose(got[0].mean(), ref[0].mean(), rtol=1e-3)
            np.testing.assert_allclose(got[1:].std(), ref[1:].std(), rtol=0.15)
        else:
            np.testing.assert_allclose(got[got != 0].std(), ref[ref != 0].std(), rtol=0.15,
                                       err_msg=k)


@pytest.mark.parametrize("kw,NS", [
    (dict(dims=[32, 32, 32]), 1),
    (dict(dims=[32, 40, 32], skip_in=(1,), combine_layer=2, dim_excludes_skip=True), 3),
    (dict(dims=[64, 32, 32, 24], skip_in=(2,), combine_layer=3, beta=2.0), 2),
])
def test_implicit_net_forward_matches_flax(kw, NS):
    """The forward on flax's weights (live biases): the skip layers' 1/sqrt(2)
    concatenation, the view mean at ``combine_layer``, softplus(beta), the
    (z, x) pair, planar out."""
    d_lat, d_x, B = 10, 9, 30
    jm, port = _implicit(d_lat + d_x, **kw)
    rng = np.random.default_rng(8)
    jv = live(jm.init(jax.random.PRNGKey(3), jnp.zeros((NS * B, d_lat + d_x))))
    _port_module(port, jv, "mlp_coarse")
    z = rng.normal(size=(NS * B, d_lat)).astype(np.float32)
    x = rng.normal(size=(NS * B, d_x)).astype(np.float32)
    for planar in (False, True):
        ref = jm.apply(jv, (jnp.asarray(z), jnp.asarray(x)), combine_inner_dims=(NS, B),
                       planar_out=planar)
        out = port((torch.from_numpy(z), torch.from_numpy(x)), combine_inner_dims=(NS, B),
                   planar_out=planar)
        close(out, np.asarray(ref), what=f"planar={planar}")


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------


def _batch(NS, seed=0):
    ds = JSyntheticDataset(n_objs=1, n_views=4, image_size=IMG, seed=seed)
    s = ds[0]
    rng = np.random.default_rng(seed + 9)
    xyz = (rng.normal(size=(1, 60, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(1, 60, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return dict(images=s["images"][None, :NS], poses=s["poses"][None, :NS],
                focal=np.float32(s["focal"]), xyz=xyz, vd=vd, z_near=ds.z_near, z_far=ds.z_far)


@pytest.fixture(scope="module")
def models():
    """Per option: the JAX model and its live variables, built on 32 px images
    (the JAX ConvEncoder takes sides that halve evenly to the bottleneck)."""
    cache = {}

    def get(what):
        if what not in cache:
            jconf, _ = option_conf(what)
            jnet = jmake_model(jconf["model"], mlp_impl="xla")
            b = _batch(1)
            v = live(jax.jit(jnet.init)(
                jax.random.PRNGKey(0), jnp.asarray(b["images"]), jnp.asarray(b["poses"]),
                jnp.asarray(b["focal"]), jnp.asarray(b["xyz"]), jnp.asarray(b["vd"])))
            cache[what] = (jnet, v)
        return cache[what]

    return get


def _port_model(what, variables, impl="torch", **kw):
    _, conf = option_conf(what)
    net = make_model(conf["model"], mlp_impl=impl, device="cpu", **kw)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return net, conf


@pytest.mark.parametrize("what", OPTIONS)
def test_weights_cross_and_go_back_through_convert_pixelnerf(models, what):
    """``from_jax_variables`` loads every JAX variable of each option
    strictly, and the port's ``state_dict`` goes back through the JAX
    package's ``convert_pixelnerf`` to the same variables -- save the
    ConvEncoder's, for which ``convert_pixelnerf`` has no rule (a reference
    gap: ROADMAP.md)."""
    _, v = models(what)
    net, _ = _port_model(what, v)
    back = convert_pixelnerf({k: t.numpy() for k, t in net.state_dict().items()})
    want = jax.tree.map(np.asarray, v)
    if what == "conv":
        assert "encoder" not in back["params"] and "encoder" in want["params"]
        want = {c: {k: t for k, t in tree.items() if k != "encoder"} for c, tree in want.items()}
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert sorted(map(str, flat_b)) == sorted(map(str, flat_w))
    for path, ref in flat_w.items():
        np.testing.assert_array_equal(np.asarray(flat_b[path]), ref, err_msg=str(path))


@pytest.mark.parametrize("NS", [1, 3])
@pytest.mark.parametrize("what", OPTIONS)
def test_query_and_render_match_jax(models, what, NS):
    """encode, ``query`` (both heads, planar) and ``render_rays`` (JAX's
    draws) from NS source views, on the plain route and on the kernel route
    (``impl="cuda"``: its plain versions here), against the JAX model."""
    jnet, v = models(what)
    b = _batch(NS, seed=1)
    jargs = (jnp.asarray(b["images"]), jnp.asarray(b["poses"]), jnp.asarray(b["focal"]))
    jscene = jnet.apply(v, *jargs, method=JPixelNeRFNet.encode)
    cfg = jrenderer.RenderConfig(n_coarse=8, n_fine=6, n_fine_depth=3, white_bkgd=True,
                                 depth_std=0.05, eval_batch_size=0)
    from pixelnerf_tpu_torch.utils.geometry import gen_rays_np, pose_spherical

    rays = gen_rays_np(pose_spherical(40.0, -20.0, 1.3)[None], IMG, IMG, b["focal"],
                       b["z_near"], b["z_far"]).reshape(-1, 8)[::7][:48]
    key = jax.random.PRNGKey(5)

    def jfield(points, viewdirs, coarse):
        return jnet.apply(v, jscene, points, viewdirs=viewdirs, coarse=coarse, planar_out=True,
                          method=JPixelNeRFNet.query)

    jrender = jax.tree.map(np.asarray, jrenderer.render_rays(
        jfield, jnp.asarray(rays)[None], key, cfg, want_weights=True))
    k_c, _, k_f, k_d, _ = jax.random.split(key, 5)
    k_u, k_j = jax.random.split(k_f)
    R = rays.shape[0]
    draws = RayDraws(**{k: torch.from_numpy(np.array(a)) for k, a in dict(
        coarse=jax.random.uniform(k_c, (R, cfg.n_coarse)),
        fine_u=jax.random.uniform(k_u, (R, cfg.n_fine - cfg.n_fine_depth), dtype=jnp.float32),
        fine_jitter=jax.random.uniform(k_j, (R, cfg.n_fine - cfg.n_fine_depth)),
        depth=jax.random.normal(k_d, (R, cfg.n_fine_depth))).items()})
    pcfg = RenderConfig(n_coarse=8, n_fine=6, n_fine_depth=3, white_bkgd=True, depth_std=0.05,
                        eval_batch_size=0)
    for impl in ("torch", "cuda"):
        net, _ = _port_model(what, v, impl)
        with torch.no_grad():
            scene = net.encode(torch.from_numpy(b["images"]), torch.from_numpy(b["poses"]),
                               float(b["focal"]))
            if what == "global":
                close(scene.global_latent, np.asarray(jscene.global_latent), what="g")
            close(scene.latents, np.asarray(jscene.latents), what="latents")
            for coarse in (True, False):
                ref = jnet.apply(v, jscene, jnp.asarray(b["xyz"]), viewdirs=jnp.asarray(b["vd"]),
                                 coarse=coarse, planar_out=True, method=JPixelNeRFNet.query)
                out = net.query(scene, torch.from_numpy(b["xyz"]), torch.from_numpy(b["vd"]),
                                coarse=coarse, planar_out=True)
                close(out, np.asarray(ref), what=f"{impl} query coarse={coarse}")

            def field(points, viewdirs, coarse):
                return net.query(scene, points, viewdirs, coarse=coarse, planar_out=True)

            got = render_rays(field, torch.from_numpy(rays)[None], pcfg, draws=draws,
                              want_weights=True)
        for head in ("coarse", "fine"):
            for k in ("rgb", "depth", "weights"):
                close(got[head][k], jrender[head][k], what=f"{impl} {head} {k}")


# ----------------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("what,size", [("global", 64), ("conv", IMG)])
def test_train_steps_match_jax_trainer(tmp_path, monkeypatch, what, size):
    """Three steps with the global encoder (its trunk's BatchNorm in train
    mode) and with the ConvEncoder (GroupNorm), the port's kernel route
    (``impl="cuda"``: its plain versions here) against the JAX trainer, on
    the same weights, batch, host generator and draws; both new encoders'
    parameters are in the optimizer and train, and after the first step the
    global trunk's running statistics are flax's.  The global encoder's images are
    64 px: at 32 its last map is 1 x 1, and the train-mode BatchNorm over
    two such maps is so ill-conditioned that the port's f32 step parts from
    its own float64 step by 7% in grad norm (JAX's by 5%).  Their lr is
    5e-5: Adam's first update is about lr * sign(g), and a trunk under
    train-mode BatchNorm has many gradients that are rounding noise (a
    channel's shift before the norm), whose signs then part the runs by lr's
    share."""
    monkeypatch.setattr(jgs, "_ONEHOT_BWD_MAX_ROWS", 0)  # read when the JAX step is traced
    jconf, conf = option_conf(what)
    jds = JSyntheticDataset(n_objs=3, n_views=4, image_size=size)
    s = jds[0]
    jnet = jmake_model(jconf["model"], mlp_impl="xla")
    v = live(jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(s["images"][None, :1]), jnp.asarray(s["poses"][None, :1]),
        jnp.asarray(np.float32(s["focal"])), jnp.zeros((1, 4, 3)), jnp.zeros((1, 4, 3))))
    data = jcollate([jds[0], jds[1]])
    lr = 5e-5 if what == "global" else 5e-4
    tr_j = JTrainer(jnet, v, jds, jds, JNeRFRenderer.from_conf(jconf["renderer"]),
                    _Args(str(tmp_path / "j"), lr=lr), jconf)
    net = make_model(conf["model"], mlp_impl="cuda", device="cpu", diff_mode=True)
    net.load_state_dict(from_jax_variables(v))
    ds = SyntheticDataset(n_objs=3, n_views=4, image_size=size)
    tr_p = Trainer(net, ds, ds, NeRFRenderer.from_conf(conf["renderer"]),
                   _Args(str(tmp_path / "p"), lr=lr), conf)
    new = net.global_encoder if what == "global" else net.encoder
    opt = {id(p) for p in tr_p.optimizer.params}
    assert all(id(p) in opt for p in new.parameters())
    before = {k: t.clone() for k, t in net.state_dict().items()}
    tr_j.rng, tr_p.rng = np.random.default_rng(7), np.random.default_rng(7)
    tr_j.jrng = jax.random.PRNGKey(3)
    for step in range(3):
        draws = _jax_draws(tr_j.jrng, 2 * tr_p.args.ray_batch_size, tr_j.renderer.cfg)
        ld_j = tr_j.train_step(data)
        ld_p = tr_p.train_step(data, draws=draws)
        np.testing.assert_allclose(ld_p["t"], ld_j["t"], rtol=2e-3, err_msg=f"step {step}")
        np.testing.assert_allclose(ld_p["grad_norm"], ld_j["grad_norm"], rtol=5e-3,
                                   err_msg=f"step {step}")
        if step == 0 and what == "global":
            # the first step's statistics come from the same weights: the
            # global trunk's moved as flax's did
            stats = from_jax_variables({"batch_stats": jax.tree.map(np.asarray,
                                                                    tr_j.state.batch_stats)})
            state = net.state_dict()
            for k, t in stats.items():
                if k.startswith("global_encoder.") and "running" in k:
                    assert not torch.equal(t, before[k]), k
                    torch.testing.assert_close(state[k], t, rtol=1e-4, atol=1e-4, msg=k)
    after = net.state_dict()
    prefix = "global_encoder." if what == "global" else "encoder."
    moved = [k for k in after if k.startswith(prefix) and not torch.equal(after[k], before[k])]
    assert any(k.endswith("weight") for k in moved)


def test_conv_encoder_stays_off_the_fused_gather(models):
    """A reference gap: the JAX ``_fused_gather_ok`` does not look at the
    encoder type, so with ``mlp_impl`` "auto" or "pallas" a ConvEncoder map
    of at most 2048 rows (images up to 32 px) is sent to ``index_taps``,
    which the ConvEncoder does not have.  The port keeps the ConvEncoder on
    the dense route, where the JAX "xla" model's query is the answer."""
    jnet, v = models("conv")
    b = _batch(1, seed=2)
    jargs = (jnp.asarray(b["images"]), jnp.asarray(b["poses"]), jnp.asarray(b["focal"]))
    jconf, _ = option_conf("conv")
    jauto = jmake_model(jconf["model"], mlp_impl="auto")
    scene_j = jauto.apply(v, *jargs, method=JPixelNeRFNet.encode)
    assert scene_j.latents.shape[1] * scene_j.latents.shape[2] <= 2048
    with pytest.raises(AttributeError, match="index_taps"):
        jauto.apply(v, scene_j, jnp.asarray(b["xyz"]), viewdirs=jnp.asarray(b["vd"]),
                    method=JPixelNeRFNet.query)
    ref = jnet.apply(v, scene_j, jnp.asarray(b["xyz"]), viewdirs=jnp.asarray(b["vd"]),
                     method=JPixelNeRFNet.query)
    for impl in ("auto", "cuda"):
        net, _ = _port_model("conv", v, impl)
        with torch.no_grad():
            scene = net.encode(torch.from_numpy(b["images"]), torch.from_numpy(b["poses"]),
                               float(b["focal"]))
            assert not net._fused_gather_ok(scene.latents, 1)
            out = net.query(scene, torch.from_numpy(b["xyz"]), torch.from_numpy(b["vd"]))
        close(out, np.asarray(ref), what=impl)


_OPTION_TEXT = {
    "global": "model { use_global_encoder = true\n global_encoder { backbone = resnet18\n"
              " latent_size = 16\n pretrained = false } }",
    "conv": "model { encoder { type = conv } }",
    "mlp": "model {\n mlp_coarse { type = mlp\n dims = [48, 48, 48]\n skip_in = [1]\n"
           " combine_layer = 2\n dim_excludes_skip = true }\n"
           " mlp_fine { type = mlp\n dims = [48, 48, 48]\n skip_in = [1]\n combine_layer = 2\n"
           " dim_excludes_skip = true } }",
    "nearest": "model { encoder { index_interp = nearest } }",
}


@pytest.mark.parametrize("what", OPTIONS)
def test_checkpoint_and_eval_clis_take_each_option(models, tmp_path, what):
    """Each option from a conf file (``tests/test_torch_train_step.py``'s
    small conf with the option's keys): a checkpoint of its weights (the
    global trunk's BatchNorm statistics and the ConvEncoder's GroupNorm
    included) saves and loads back equal into a fresh model, and the port's
    ``eval`` and ``gen_video`` CLIs run on it (finite PSNR / SSIM, the
    journal and the frames written)."""
    import types

    from pixelnerf_tpu_torch.eval.eval import main as eval_main
    from pixelnerf_tpu_torch.eval.gen_video import main as gen_video_main
    from pixelnerf_tpu_torch.train import checkpoints

    conf = tmp_path / "opt.conf"
    conf.write_text(CONF + "\n" + _OPTION_TEXT[what] + "\n")
    assert hocon.parse_file(str(conf)).as_dict() == option_conf(what)[1].as_dict()
    _, v = models(what)
    net, _ = _port_model(what, v)
    ck = tmp_path / "ck"
    checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=str(ck), name="opt"), net)
    fresh = make_model(option_conf(what)[1]["model"], device="cpu",
                       generator=torch.Generator().manual_seed(9))
    assert checkpoints.load_weights(types.SimpleNamespace(checkpoints_path=str(ck), name="opt",
                                                          resume=True), fresh)
    want = net.state_dict()
    got = fresh.state_dict()
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    base = ["-n", "opt", "-c", str(conf), "-F", "synthetic", "--checkpoints_path", str(ck),
            "--split", "test", "--device", "cpu", "-R", "2048"]
    (tmp_path / "views.txt").write_text("3\n")
    res = eval_main(base + ["-P", "0", "--max_objs", "1", "--scale", "0.25", "--eval_view_list",
                            str(tmp_path / "views.txt"), "-O", str(tmp_path / "ev")])
    assert res["cnt"] == 1 and all(np.isfinite([p, s]).all() for _, p, s in res["objects"])
    assert (tmp_path / "ev" / "finish.txt").exists()
    vid = gen_video_main(base + ["-S", "0", "-P", "0", "--num_views", "1", "--scale", "0.25",
                                 "--visual_path", str(tmp_path / "vis")])
    assert len(os.listdir(vid["frame_dir"])) == 1 and np.isfinite(vid["frames"]).all()
