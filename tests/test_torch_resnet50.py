"""The ResNet50 backbone and its 1856-channel latent, on the CPU, against the
JAX package with one set of weights carried across by
``utils/jax_convert.py::from_jax_variables``.

* The trunk: ``ResNetFeatures("resnet50")`` (Bottleneck blocks: ``conv3`` /
  ``bn3``, ``downsample.0/1`` on every stage's first block) at all 5 stages
  with its first pool, and ``SpatialEncoder(backbone="resnet50",
  num_layers=4)`` without it (the unified map: 64 + 256 + 512 + 1024 = 1856
  channels, its ``index`` and ``index_taps``), in eval mode on the running
  statistics and in train mode on the batch's (the running statistics
  moved as flax moves them); a port checkpoint of the model goes back to
  the JAX variables through ``utils/torch_convert.py::convert_pixelnerf``.
* Rows 5a / 5b at C = 1856: the plain backward and the weights kernel's
  plain version on the data kernel's plain DataOut against the JAX
  ``_bwd_kernel`` in interpret mode from 1 and 3 views, at the bars of
  ``tests/test_torch_bwd_weights.py`` (its own test body).
* The slice: the train conf of ``tests/test_torch_train_step.py`` with the
  encoder overridden to ResNet50 at 4 layers (no first pool) and d_hidden
  64 heads (3 blocks, the latent in blocks 0-1, the views' mean at block
  2), on 32 px images: encode, ``query`` on the kernel route (the kernels'
  plain versions: the fused gathers under the cap, the dense rows at a cap
  of 0) against the JAX Pallas kernels in interpret mode and
  ``render_rays`` on JAX's draws from 1 and 3 views, to 1e-4 of max(1,
  max|ref|); one trainer step at -V 1 against the JAX trainer (loss rtol
  2e-3, grad norm rtol 5e-3, the bars of ``tests/test_torch_train_step.py``).

The kernels themselves run on the card only: ``chip_smoke.py`` (phase 21)
holds them against these plain versions at sn64's widths there.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bwd_weights as bwd_weights_tests
from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.data import SyntheticDataset as JSyntheticDataset
from pixelnerf_tpu.data.loader import collate as jcollate
from pixelnerf_tpu.models import PixelNeRFNet as JPixelNeRFNet
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.models.encoder import SpatialEncoder as JSpatialEncoder
from pixelnerf_tpu.models.resnet import ResNetFeatures as JResNetFeatures
from pixelnerf_tpu.render import NeRFRenderer as JNeRFRenderer
from pixelnerf_tpu.render import renderer as jrenderer
from pixelnerf_tpu.train.trainer import Trainer as JTrainer
from pixelnerf_tpu.utils import torch_convert
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import SyntheticDataset
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.models.encoder import SpatialEncoder
from pixelnerf_tpu_torch.models.resnet import ResNetFeatures
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.render import NeRFRenderer, RayDraws, RenderConfig, render_rays
from pixelnerf_tpu_torch.train import Trainer
from pixelnerf_tpu_torch.utils.geometry import gen_rays_np, pose_spherical
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables
from test_torch_train_step import CONF, _Args, _jax_draws

TOL = 1e-4
IMG = 32
C = 1856  # ResNet50's unified map at 4 layers: 64 + 256 + 512 + 1024
# the ops package re-exports a function under the module's name
jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")


def close(port, ref, tol=TOL, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    bar = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bar, f"{what} max|d| {err:.3g} > {bar:.3g}"


def live(variables, seed=3):
    """Every parameter live: random fc_1 kernels and biases, BatchNorm
    statistics and scales."""
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


def _port_module(module, variables, prefix):
    """``variables`` of a JAX module mounted at ``prefix`` of the model,
    loaded (strictly) into the port ``module``."""
    sd = from_jax_variables({c: {prefix: t} for c, t in variables.items()})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()}, strict=True)
    return module


def _running(module, mutated, prefix, tol=TOL):
    """The port module's running statistics against flax's updated ones."""
    stats = from_jax_variables({"batch_stats": {prefix: jax.tree.map(np.asarray, mutated)}})
    state = module.state_dict()
    for k, want in stats.items():
        if "running" in k:
            close(state[k[len(prefix) + 1:]], want, tol=tol, what=k)


@functools.lru_cache(maxsize=1)
def _trunk():
    """Two 96 x 80 images, the JAX trunk and its live variables."""
    x = np.random.default_rng(5).uniform(-1, 1, size=(2, 96, 80, 3)).astype(np.float32)
    jm = JResNetFeatures(backbone="resnet50", num_layers=5, use_first_pool=True)
    return x, jm, live(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))


@pytest.mark.parametrize("train", [False, True])
def test_resnet50_trunk_matches_jax(train):
    """Every stage of the ResNet50 trunk (5 stages, the first pool on, two
    96 x 80 images: 3 x 3 at the last stage), eval and train mode.  In train
    mode flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2, which
    loses digits that the port's two-pass variance keeps, and the last
    stages normalise over few samples a channel (18 at stage 4): there the
    JAX trunk's f32 maps part from the port's by 4.4e-4 of their range at
    stage 4 and 1.4e-4 at stage 3, where the port's own f32 and float64
    runs part by 1.0e-4 and 3.1e-5.  So train mode is held at 2e-3 of
    max(1, max|ref|), eval mode at 1e-4."""
    x, jm, v = _trunk()
    port = _port_module(ResNetFeatures("resnet50", num_layers=5, use_first_pool=True), v,
                        "global_encoder")
    keys = port.state_dict().keys()
    assert {"layer1.0.conv3.weight", "layer1.0.bn3.running_var", "layer4.0.downsample.0.weight",
            "layer4.0.downsample.1.bias"} <= set(keys)
    port.train(train)
    with torch.no_grad():
        feats = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    if train:
        ref, mutated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(v, jnp.asarray(x))
    assert [f.shape[1] for f in feats] == [64, 256, 512, 1024, 2048]
    tol = 2e-3 if train else TOL
    for i, (f, r) in enumerate(zip(feats, ref)):
        close(f.permute(0, 2, 3, 1), r, tol=tol, what=f"stage {i} train={train}")
    if train:  # the statistics moved as flax's (their batch variance too)
        _running(port, mutated["batch_stats"], "global_encoder", tol=tol)


@pytest.mark.parametrize("train", [False, True])
def test_resnet50_spatial_encoder_matches_jax(train):
    """The unified map of ResNet50 at 4 layers on 32 px images (16 x 16 x
    1856), then ``index`` and ``index_taps`` at points in and outside it."""
    x = np.random.default_rng(6).uniform(-1, 1, size=(3, IMG, IMG, 3)).astype(np.float32)
    kw = dict(backbone="resnet50", num_layers=4, use_first_pool=False)
    jm = JSpatialEncoder(**kw)
    v = live(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    enc = _port_module(SpatialEncoder(**kw), v, "encoder")
    assert enc.latent_size == C
    enc.train(train)
    with torch.no_grad():
        lat = enc(torch.from_numpy(x))
    if train:
        ref, mutated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        _running(enc, mutated["batch_stats"], "encoder")
    else:
        ref = jm.apply(v, jnp.asarray(x))
    assert tuple(lat.shape) == (3, IMG // 2, IMG // 2, C)
    close(lat, ref, what=f"unified map train={train}")
    uv = np.random.default_rng(4).uniform(-3, IMG + 3, size=(3, 90, 2)).astype(np.float32)
    L, U, jl = lat, torch.from_numpy(uv), jnp.asarray(np.asarray(ref))
    close(enc.index(L, U, (IMG, IMG)), jm.index(jl, jnp.asarray(uv), (IMG, IMG)), what="index")
    idx, w = enc.index_taps(L, U, (IMG, IMG))
    jidx, jw = jm.index_taps(jl, jnp.asarray(uv), (IMG, IMG))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(w, jw, what="index_taps weights")


# rows 5a / 5b at C = 1856 from 1 and 3 views: (NS, sb, B_obj, d_in, d_latent,
# d_hidden, n_blocks, combine_layer); B_pad an odd multiple of 32
BWD_CASES = [(1, 1, 96, 42, C, 64, 3, 2), (3, 2, 48, 42, C, 64, 3, 2)]


@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_plain_at_1856_matches_pallas_interpret(case):
    """Rows 5a / 5b's plain versions (``bwd_weights_reference``, lin_z's
    products of M = 1856, on ``workspace_reference``'s DataOut) and the
    plain backward (dz in 1856 columns, dx) against ``_bwd_kernel`` in
    interpret mode, every weight and bias gradient."""
    bwd_weights_tests.test_weights_reference_matches_pallas_interpret(*case)


# ----------------------------------------------------------------------------
# the slice
# ----------------------------------------------------------------------------


def _conf(parser):
    """The train conf with ResNet50 at 4 layers and d_hidden 64 heads."""
    conf = parser.parse_string(CONF)
    conf.put("model.encoder.backbone", "resnet50")
    conf.put("model.encoder.num_layers", 4)
    for head in ("mlp_coarse", "mlp_fine"):
        conf.put(f"model.{head}.d_hidden", 64)
    return conf


@pytest.fixture(scope="module")
def world():
    """Three source views of one object, query points, rays, live JAX
    variables and the JAX scenes from 1 and 3 views."""
    ds = SyntheticDataset(n_objs=1, n_views=3, image_size=IMG, seed=2)
    s = ds[0]
    rng = np.random.default_rng(9)
    B = 50
    xyz = (rng.normal(size=(1, B, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(1, B, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    conf = _conf(jhocon)
    jnet = jmake_model(conf["model"], mlp_impl="xla")
    variables = live(jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(s["images"][None, :1]),
        jnp.asarray(s["poses"][None, :1]), jnp.asarray(np.float32(s["focal"])),
        jnp.asarray(xyz), jnp.asarray(vd)))
    scenes = {NS: jnet.apply(variables, jnp.asarray(s["images"][None, :NS]),
                             jnp.asarray(s["poses"][None, :NS]), jnp.asarray(s["focal"]),
                             method=JPixelNeRFNet.encode) for NS in (1, 3)}
    rays = gen_rays_np(pose_spherical(40.0, -20.0, 1.3)[None], IMG, IMG, s["focal"],
                       ds.z_near, ds.z_far).reshape(-1, 8)[::9][:40]
    return dict(images=s["images"], poses=s["poses"], focal=np.float32(s["focal"]), xyz=xyz,
                vd=vd, conf=conf, variables=variables, scenes=scenes, rays=rays)


def _port(world, NS, impl="cuda"):
    net = make_model(_conf(hocon)["model"], mlp_impl=impl, device="cpu")
    net.load_state_dict(from_jax_variables(world["variables"]))
    assert (net.encoder.backbone, net.encoder.num_layers, net.d_latent) == ("resnet50", 4, C)
    with torch.no_grad():
        scene = net.encode(torch.from_numpy(world["images"][None, :NS]),
                           torch.from_numpy(world["poses"][None, :NS]), float(world["focal"]))
    return net, scene


def test_resnet50_checkpoint_goes_back_through_convert_pixelnerf(world):
    """A port checkpoint of the ResNet50 model (Bottleneck ``conv3`` /
    ``bn3`` and ``downsample`` keys included) is the JAX variables again."""
    net, _ = _port(world, 1, "torch")
    sd = net.state_dict()
    assert "encoder.model.layer3.5.bn3.running_mean" in sd
    assert "encoder.model.layer2.0.downsample.0.weight" in sd
    back = torch_convert.convert_pixelnerf(sd)
    assert torch_convert.tree_shapes_match(back, world["variables"]) == []
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(world["variables"])[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("NS", [1, 3])
def test_resnet50_encode_matches_jax(world, NS):
    _, scene = _port(world, NS)
    js = world["scenes"][NS]
    assert tuple(scene.latents.shape) == (NS, IMG // 2, IMG // 2, C)
    close(scene.latents, js.latents, what="latents")
    close(scene.poses, js.poses, what="poses")


@pytest.mark.parametrize("NS,cap", [(1, 2048), (1, 0), (3, 2048), (3, 0)])
def test_resnet50_query_matches_jax(world, monkeypatch, NS, cap):
    """The fused gather (row 1) or the dense forward (row 2) from one view,
    the multi-view gather (row 4) or dense forward (row 3) from three, in
    their plain versions at C = 1856, against the JAX Pallas kernels in
    interpret mode; both heads."""
    monkeypatch.setenv("PIXELNERF_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PIXELNERF_FUSED_GATHER_MAX_ROWS", str(cap))
    jnet = jmake_model(world["conf"]["model"], mlp_impl="pallas")
    net, scene = _port(world, NS)
    assert net._fused_gather_ok(scene.latents, NS) == (cap > 0)
    rf.reset_launches()
    for coarse in (True, False):
        ref = jnet.apply(world["variables"], world["scenes"][NS], jnp.asarray(world["xyz"]),
                         viewdirs=jnp.asarray(world["vd"]), coarse=coarse, planar_out=True,
                         method=JPixelNeRFNet.query)
        with torch.no_grad():
            out = net.query(scene, torch.from_numpy(world["xyz"]), torch.from_numpy(world["vd"]),
                            coarse=coarse, planar_out=True)
        close(out, ref, what=f"NS={NS} coarse={coarse}")
    assert not any(rf.LAUNCHES.values())  # CPU tensors never launch a kernel


@pytest.mark.parametrize("NS", [1, 3])
def test_resnet50_render_rays_matches_jax(world, NS):
    """Encode, the kernel route's query (plain versions), the samplers and
    the compositing from NS views against JAX's render_rays (XLA field) on
    the same draws: weights, rgb and depth of both passes."""
    samples = dict(n_coarse=8, n_fine=6, n_fine_depth=3)
    cfg = jrenderer.RenderConfig(**samples, white_bkgd=True, depth_std=0.01, eval_batch_size=0)
    jnet = jmake_model(world["conf"]["model"], mlp_impl="xla")
    rays = jnp.asarray(world["rays"])[None]
    key = jax.random.PRNGKey(5)

    def field(points, viewdirs, coarse):
        return jnet.apply(world["variables"], world["scenes"][NS], points, viewdirs=viewdirs,
                          coarse=coarse, planar_out=True, method=JPixelNeRFNet.query)

    ref = jax.tree.map(np.asarray, jrenderer.render_rays(field, rays, key, cfg, want_weights=True))
    n_rays = rays.shape[1]
    k_c, _, k_f, k_d, _ = jax.random.split(key, 5)
    k_u, k_j = jax.random.split(k_f)
    n_imp = cfg.n_fine - cfg.n_fine_depth
    draws = dict(coarse=jax.random.uniform(k_c, (n_rays, cfg.n_coarse)),
                 fine_u=jax.random.uniform(k_u, (n_rays, n_imp), dtype=jnp.float32),
                 fine_jitter=jax.random.uniform(k_j, (n_rays, n_imp)),
                 depth=jax.random.normal(k_d, (n_rays, cfg.n_fine_depth)))
    draws = RayDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    net, scene = _port(world, NS)

    def pfield(points, viewdirs, coarse):
        return net.query(scene, points, viewdirs=viewdirs, coarse=coarse, planar_out=True)

    with torch.no_grad():
        out = render_rays(pfield, torch.from_numpy(world["rays"])[None],
                          RenderConfig(**samples, white_bkgd=True, depth_std=0.01,
                                       eval_batch_size=0), draws=draws, want_weights=True)
    for head in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            close(out[head][k], ref[head][k], what=f"NS={NS} {head} {k}")


def test_resnet50_train_step_matches_jax_trainer(tmp_path, monkeypatch):
    """One ``-V 1`` step on the kernel route (``impl="cuda"``: the dense
    forward's plain version at C = 1856 and the backward's plain
    transcription through the autograd Function; remat off, as on the card)
    against the JAX trainer: the same live weights, batch, host generator
    and render draws; the ResNet50 trunk trains in train-mode BatchNorm on
    both sides."""
    monkeypatch.setattr(jgs, "_ONEHOT_BWD_MAX_ROWS", 0)  # read when the JAX step is traced
    jconf, conf = _conf(jhocon), _conf(hocon)
    jds = JSyntheticDataset(n_objs=3, n_views=4, image_size=IMG)
    s = jds[0]
    jnet = jmake_model(jconf["model"], mlp_impl="xla")
    v = live(jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(s["images"][None, :1]), jnp.asarray(s["poses"][None, :1]),
        jnp.asarray(np.float32(s["focal"])), jnp.zeros((1, 4, 3)), jnp.zeros((1, 4, 3))))
    tr_j = JTrainer(jnet, v, jds, jds, JNeRFRenderer.from_conf(jconf["renderer"]),
                    _Args(str(tmp_path / "j")), jconf)
    net = make_model(conf["model"], mlp_impl="cuda", device="cpu", diff_mode=True)
    net.load_state_dict(from_jax_variables(v))
    assert net.d_latent == C
    ds = SyntheticDataset(n_objs=3, n_views=4, image_size=IMG)
    tr_p = Trainer(net, ds, ds, NeRFRenderer.from_conf(conf["renderer"]),
                   _Args(str(tmp_path / "p")), conf)
    assert not tr_p.remat  # the kernel route saves only its inputs
    data = jcollate([jds[0], jds[1]])
    tr_j.rng, tr_p.rng = np.random.default_rng(7), np.random.default_rng(7)
    tr_j.jrng = jax.random.PRNGKey(3)
    draws = _jax_draws(tr_j.jrng, 2 * tr_p.args.ray_batch_size, tr_j.renderer.cfg)
    ld_j = tr_j.train_step(data)
    ld_p = tr_p.train_step(data, draws=draws)
    assert np.isfinite(ld_p["t"]), ld_p
    np.testing.assert_allclose(ld_p["t"], ld_j["t"], rtol=2e-3)
    np.testing.assert_allclose(ld_p["grad_norm"], ld_j["grad_norm"], rtol=5e-3)
