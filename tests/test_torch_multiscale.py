"""The port's multi-scale model (``conf/exp/sn64_multiscale.conf``) against
the JAX package, in f32 on the CPU.

The recipe at full width builds and loads the JAX model's variables; then,
at small ResnetFC widths and 32 px images but the JAX package's 512-wide
fused latent, the multi-scale encoder and ``index`` over the pyramid, and
``encode`` / ``query`` (the fused-gather and the dense route) /
``render_rays`` with JAX's draws at four variants: fusion with attention,
weighted fusion, fusion with the adaptive gate, and the raw pyramid.  One
set of JAX variables (bumped off their init) serves every variant, carried
JAX -> port by ``from_jax_variables``.  Then three trainer steps of the
recipe against the JAX trainer (``fusion_dropout = 0``, the recipe's
``grad_clip`` on), the recipe's dropout through the trainer's generator,
and the train CLI and ``gen_video`` on a multi-scale conf.

Tolerances: ``max|d| <= 1e-4 * max(1, max|ref|)`` for the model; the train
steps at ``tests/test_torch_train_step.py``'s bars (loss rtol 2e-3,
``grad_norm`` rtol 5e-3)."""

import dataclasses
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
from pixelnerf_tpu.models.encoder import SpatialEncoder as JSpatialEncoder
from pixelnerf_tpu.render import NeRFRenderer as JNeRFRenderer
from pixelnerf_tpu.render import renderer as jrenderer
from pixelnerf_tpu.train.trainer import Trainer as JTrainer
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import SyntheticDataset
from pixelnerf_tpu_torch.eval.gen_video import main as gen_video_main
from pixelnerf_tpu_torch.models import PixelNeRFNet, make_model
from pixelnerf_tpu_torch.models.encoder import SpatialEncoder
from pixelnerf_tpu_torch.render import NeRFRenderer, RayDraws, RenderConfig, render_rays
from pixelnerf_tpu_torch.models.losses import l2_loss
from pixelnerf_tpu_torch.train import Optimizer, Trainer, make_step_fns, prepare_ray_batch
from pixelnerf_tpu_torch.train import main as train_main
from pixelnerf_tpu_torch.utils.geometry import gen_rays_np, pose_spherical
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables
from test_torch_train_step import _Args, _jax_draws

RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf", "exp",
                      "sn64_multiscale.conf")
jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")
TOL = 1e-4
IMG = 32
# (use_smart_fusion, fusion_type, use_adaptive_sampling)
VARIANTS = {"attention": (True, "attention", False), "weighted": (True, "weighted", False),
            "gated": (True, "attention", True), "raw": (False, "attention", False)}


def close(port, ref, tol=TOL, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    bar = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bar, f"{what} max|d| {err:.3g} > {bar:.3g}"


def recipe(variant="gated", small=True, dropout=0.0, cbam=True):
    """The recipe in both packages' conf trees: small ResnetFC heads, a
    resnet18 trunk (the recipe's 4 stages of 64 / 64 / 128 / 256 channels,
    no first pool), random backbone, and ``variant``'s fusion switches."""
    fusion, ftype, gate = VARIANTS[variant]
    out = []
    for parser in (jhocon, hocon):
        conf = parser.parse_file(RECIPE)
        conf.put("model.encoder.pretrained", False)
        conf.put("model.use_smart_fusion", fusion)
        conf.put("model.fusion_type", ftype)
        conf.put("model.use_adaptive_sampling", gate)
        conf.put("model.fusion_dropout", dropout)
        conf.put("model.use_cbam", cbam)
        if small:
            conf.put("model.encoder.backbone", "resnet18")
            for head in ("mlp_coarse", "mlp_fine"):
                conf.put(f"model.{head}.d_hidden", 32)
                conf.put(f"model.{head}.n_blocks", 3)
                conf.put(f"model.{head}.combine_layer", 2)
            conf.put("renderer.n_coarse", 8)
            conf.put("renderer.n_fine", 6)
            conf.put("renderer.n_fine_depth", 3)
        out.append(conf)
    return out


def bump(variables, seed=3):
    """Live weights: random fc_1, biases, BatchNorm statistics and affines."""
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
            elif k in ("bias", "mean"):
                v = rng.normal(size=v.shape).astype(np.float32) * 0.1
            elif k in ("scale", "var"):
                v = rng.uniform(0.7, 1.3, size=v.shape).astype(np.float32)
            out[k] = v
        return out

    return visit(jax.tree.map(np.asarray, dict(variables)), ())


def for_variant(variables, variant):
    """The gated recipe's variables cut to ``variant``'s modules."""
    fusion, ftype, gate = VARIANTS[variant]
    out = {}
    for coll, tree in variables.items():
        tree = dict(tree)
        if not gate:
            tree.pop("adaptive_sampler", None)
        if not fusion:
            tree.pop("feature_fusion", None)
        elif ftype != "attention" and "feature_fusion" in tree:
            tree["feature_fusion"] = {k: v for k, v in tree["feature_fusion"].items()
                                      if k not in ("channel_attn", "spatial_attn")}
        out[coll] = tree
    return out


@pytest.fixture(scope="module")
def world():
    ds = SyntheticDataset(n_objs=1, n_views=3, image_size=IMG, seed=2)
    s = ds[0]
    images, poses = s["images"][None, :1], s["poses"][None, :1]
    focal = np.float32(s["focal"])
    rng = np.random.default_rng(9)
    xyz = (rng.normal(size=(1, 70, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(1, 70, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    jconf, _ = recipe("gated")
    jnet = jmake_model(jconf["model"], mlp_impl="xla")
    variables = bump(jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(poses), jnp.asarray(focal),
        jnp.asarray(xyz), jnp.asarray(vd)))
    rays = gen_rays_np(pose_spherical(40.0, -20.0, 1.3)[None], IMG, IMG, focal,
                       ds.z_near, ds.z_far).reshape(-1, 8)[::9][:64]
    return dict(images=images, poses=poses, focal=focal, xyz=xyz, vd=vd, variables=variables,
                rays=rays)


@pytest.fixture(scope="module")
def jax_side(world):
    """Per variant: the JAX model, its variables, its encoded scene, its
    query outputs and its render (with the draws its key split gives)."""
    cache = {}
    cfg = jrenderer.RenderConfig(n_coarse=8, n_fine=6, n_fine_depth=3, white_bkgd=True,
                                 depth_std=0.05, eval_batch_size=0)
    key = jax.random.PRNGKey(5)

    def get(variant):
        if variant in cache:
            return cache[variant]
        jnet = jmake_model(recipe(variant)[0]["model"], mlp_impl="xla")
        v = for_variant(world["variables"], variant)
        args = (jnp.asarray(world["images"]), jnp.asarray(world["poses"]),
                jnp.asarray(world["focal"]))
        scene = jnet.apply(v, *args, method=JPixelNeRFNet.encode)
        queries = [np.asarray(jnet.apply(v, scene, jnp.asarray(world["xyz"]),
                                         viewdirs=jnp.asarray(world["vd"]), coarse=coarse,
                                         planar_out=True, method=JPixelNeRFNet.query))
                   for coarse in (True, False)]

        @jax.jit
        def run(variables, scene, rays, rng):
            def field(points, viewdirs, coarse):
                return jnet.apply(variables, scene, points, viewdirs=viewdirs, coarse=coarse,
                                  planar_out=True, method=JPixelNeRFNet.query)

            return jrenderer.render_rays(field, rays, rng, cfg, want_weights=True)

        render = jax.tree.map(np.asarray, run(v, scene, jnp.asarray(world["rays"])[None], key))
        cache[variant] = dict(v=v, scene=scene, queries=queries, render=render)
        return cache[variant]

    B = world["rays"].shape[0]
    k_c, _, k_f, k_d, _ = jax.random.split(key, 5)
    k_u, k_j = jax.random.split(k_f)
    draws = RayDraws(**{k: torch.from_numpy(np.array(v)) for k, v in dict(
        coarse=jax.random.uniform(k_c, (B, cfg.n_coarse)),
        fine_u=jax.random.uniform(k_u, (B, cfg.n_fine - cfg.n_fine_depth), dtype=jnp.float32),
        fine_jitter=jax.random.uniform(k_j, (B, cfg.n_fine - cfg.n_fine_depth)),
        depth=jax.random.normal(k_d, (B, cfg.n_fine_depth))).items()})
    port_cfg = RenderConfig(n_coarse=8, n_fine=6, n_fine_depth=3, white_bkgd=True,
                            depth_std=0.05, eval_batch_size=0)
    return get, draws, port_cfg


def _port(world, jax_variables, variant, impl):
    net = make_model(recipe(variant)[1]["model"], mlp_impl=impl, device="cpu")
    net.load_state_dict(from_jax_variables(jax_variables))
    scene = net.encode(torch.from_numpy(world["images"]), torch.from_numpy(world["poses"]),
                       float(world["focal"]))
    return net, scene


def test_recipe_builds_at_full_width_and_loads_jax_variables():
    """``make_model`` on ``conf/exp/sn64_multiscale.conf`` as it stands
    (ResNet34, 4 stages, no first pool, attention fusion with CBAM to 512,
    the adaptive gate, ResnetFC 512 x 5 on both heads), and every JAX
    variable of that model loads into it, strictly."""
    jconf, conf = recipe("gated", small=False, dropout=0.1)
    conf.put("model.encoder.pretrained", True)  # as the recipe has it: not read by make_model
    net = make_model(conf["model"], device="cpu")
    assert net.encoder.use_multi_scale and net.encoder.latent_sizes == [64, 64, 128, 256]
    assert net.encoder.latent_size == [64, 64, 128, 256] and net.latent_size == 512
    assert net.feature_fusion.dropout == 0.1 and net.feature_fusion.use_cbam
    assert net.feature_fusion.use_attention and net.adaptive_sampler.quality_threshold == 0.3
    heads = (net.mlp_coarse.d_hidden, net.mlp_coarse.n_blocks, net.mlp_fine.d_latent)
    assert heads == (512, 5, 512)
    jnet = jmake_model(jconf["model"])
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 64, 64, 3)),
                            jnp.tile(jnp.eye(4), (1, 1, 1, 1)), jnp.float32(60.0),
                            jnp.zeros((1, 4, 3)), jnp.zeros((1, 4, 3)))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), dict(shapes))
    net.load_state_dict(from_jax_variables(zeros), strict=True)
    assert all(float(p.detach().abs().sum()) == 0.0 for p in net.parameters())
    # the recipe's 32 x 32 fused map: a 1024-row table, on the fused-gather route
    assert net.FUSED_GATHER_MAX_ROWS >= 32 * 32


@pytest.mark.parametrize("what", ["global", "conv", "mlp", "nearest"])
def test_what_is_not_ported_still_raises(world, what):
    """The four options that raised here until they were ported now build on
    the gated recipe (the global encoder's code, the ConvEncoder in place of
    the pyramid, an ImplicitNet coarse head, the nearest lookup into each
    scale), and encode and ``query`` (both heads, plain route) match the JAX
    model on its live variables; what is still not ported, an
    ``upsample_interp`` other than bilinear or nearest, still raises."""
    confs = recipe("gated")
    for conf in confs:
        if what == "global":
            conf.put("model.use_global_encoder", True)
            conf.put("model.global_encoder.backbone", "resnet18")
            conf.put("model.global_encoder.latent_size", 16)
        elif what == "conv":
            conf.put("model.encoder.type", "conv")
        elif what == "mlp":
            conf.put("model.mlp_coarse.type", "mlp")
            conf.put("model.mlp_coarse.dims", [32, 32])
        else:
            conf.put("model.encoder.index_interp", "nearest")
    jnet = jmake_model(confs[0]["model"], mlp_impl="xla")
    args = (jnp.asarray(world["images"]), jnp.asarray(world["poses"]), jnp.asarray(world["focal"]))
    v = bump(jax.jit(jnet.init)(jax.random.PRNGKey(1), *args, jnp.asarray(world["xyz"]),
                                jnp.asarray(world["vd"])))
    scene_j = jnet.apply(v, *args, method=JPixelNeRFNet.encode)
    net = make_model(confs[1]["model"], device="cpu")
    net.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        scene = net.encode(torch.from_numpy(world["images"]), torch.from_numpy(world["poses"]),
                           float(world["focal"]))
        for coarse in (True, False):
            ref = jnet.apply(v, scene_j, jnp.asarray(world["xyz"]), viewdirs=jnp.asarray(world["vd"]),
                             coarse=coarse, planar_out=True, method=JPixelNeRFNet.query)
            out = net.query(scene, torch.from_numpy(world["xyz"]), torch.from_numpy(world["vd"]),
                            coarse=coarse, planar_out=True)
            close(out, ref, what=f"{what} coarse={coarse}")
    confs[1].put("model.encoder.type", "spatial")
    confs[1].put("model.encoder.upsample_interp", "bicubic")
    confs[1].put("model.encoder.use_multi_scale", False)
    with pytest.raises(NotImplementedError), torch.device("meta"):
        PixelNeRFNet(confs[1]["model"])


@pytest.mark.parametrize("normalize", ["image", "feature"])
def test_multiscale_encoder_and_index_match_jax(world, jax_side, normalize):
    """The per-stage maps (finest first: 16^2 x 64, 16^2 x 64, 8^2 x 128, 4^2
    x 256 at 32 px) and ``index`` over the pyramid, each scale normalized by
    its own (H_l, W_l), the samples concatenated; ``index_taps`` stays
    single-map."""
    ref = jax_side[0]("raw")["scene"].latents
    net, scene = _port(world, jax_side[0]("raw")["v"], "raw", "torch")
    assert isinstance(scene.latents, tuple) and len(scene.latents) == len(ref) == 4
    assert [tuple(t.shape[1:]) for t in scene.latents] == [(16, 16, 64), (16, 16, 64),
                                                          (8, 8, 128), (4, 4, 256)]
    for a, b in zip(scene.latents, ref):
        close(a, b, what="pyramid")
    kw = dict(backbone="resnet18", num_layers=4, use_multi_scale=True,
              index_normalize=normalize)
    jenc = JSpatialEncoder(**kw)
    with torch.device("meta"):
        enc = SpatialEncoder(**kw)
    uv = np.random.default_rng(4).uniform(-3, IMG + 3, size=(1, 90, 2)).astype(np.float32)
    lats = [np.array(t) for t in ref]
    out = enc.index([torch.from_numpy(t) for t in lats], torch.from_numpy(uv), (IMG, IMG))
    assert out.shape == (1, 90, 512)
    close(out, jenc.index([jnp.asarray(t) for t in lats], jnp.asarray(uv), (IMG, IMG)))
    idx, w = enc.index_taps(torch.from_numpy(lats[2]), torch.from_numpy(uv), (IMG, IMG))
    jidx, jw = jenc.index_taps(jnp.asarray(lats[2]), jnp.asarray(uv), (IMG, IMG))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(w, jw)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encode_query_render_match_jax(world, jax_side, variant):
    """``encode``; ``query`` on the plain route and the kernel route (their
    plain versions on CPU tensors: the fused gather on the fused map, the
    dense route on the raw pyramid); ``render_rays`` fed JAX's draws."""
    get, draws, cfg = jax_side
    ref = get(variant)
    for impl in ("torch", "cuda"):
        net, scene = _port(world, ref["v"], variant, impl)
        if variant == "raw":
            for a, b in zip(scene.latents, ref["scene"].latents):
                close(a, b, what="pyramid")
        else:
            assert tuple(scene.latents.shape) == (1, 16, 16, 512)
            close(scene.latents, ref["scene"].latents, what="fused latents")
        assert net._fused_gather_ok(scene.latents, 1) == (impl == "cuda" and variant != "raw")
        for coarse, want in zip((True, False), ref["queries"]):
            with torch.no_grad():
                out = net.query(scene, torch.from_numpy(world["xyz"]),
                                torch.from_numpy(world["vd"]), coarse=coarse, planar_out=True)
            close(out, want, what=f"{impl} coarse={coarse}")

    def field(points, viewdirs, coarse):
        return net.query(scene, points, viewdirs=viewdirs, coarse=coarse, planar_out=True)

    with torch.no_grad():
        out = render_rays(field, torch.from_numpy(world["rays"])[None], cfg, draws=draws,
                          want_weights=True)
    for head in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            close(out[head][k], ref["render"][head][k], what=f"{head} {k}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

STEP_DATA = dict(n_objs=3, n_views=4, image_size=24)


def _step_batch():
    """The collated batch of the train steps (objects 0 and 1)."""
    from pixelnerf_tpu_torch.data import collate

    ds = SyntheticDataset(**STEP_DATA)
    return collate([ds[0], ds[1]])


def _without_cbam(variables):
    return {coll: dict(tree, feature_fusion={k: v for k, v in tree["feature_fusion"].items()
                                             if k != "cbam"})
            if "feature_fusion" in tree else tree for coll, tree in variables.items()}


@pytest.fixture(scope="module")
def jax_steps(world, tmp_path_factory):
    """Three JAX trainer steps of the gated recipe without CBAM (dropout 0,
    ``grad_clip`` 1 with ``check_gradients``), with the draws each step
    made.  CBAM stays out of this comparison: with it, the JAX trainer's
    jitted step on XLA:CPU parts from the same step run eagerly (and from
    the port's float64 step) by ~12% in the fusion and encoder gradients;
    :func:`test_cbam_train_step_matches_float64` holds the port's CBAM step."""
    jgs._ONEHOT_BWD_MAX_ROWS, saved = 0, jgs._ONEHOT_BWD_MAX_ROWS  # read when the step is traced
    try:
        jconf, _ = recipe("gated", cbam=False)
        jds = JSyntheticDataset(**STEP_DATA)
        data = jcollate([jds[0], jds[1]])
        tr = JTrainer(jmake_model(jconf["model"], mlp_impl="xla"),
                      _without_cbam(world["variables"]), jds, jds,
                      JNeRFRenderer.from_conf(jconf["renderer"]),
                      _Args(str(tmp_path_factory.mktemp("jax_steps")), check_gradients=True,
                            grad_clip=1.0), jconf)
        tr.rng, tr.jrng = np.random.default_rng(7), jax.random.PRNGKey(3)
        n_rays = 2 * tr.args.ray_batch_size
        steps = []
        for _ in range(3):
            draws = _jax_draws(tr.jrng, n_rays, tr.renderer.cfg)
            steps.append((draws, {k: float(v) for k, v in tr.train_step(data).items()}))
        return dict(steps=steps, data=data, clip=tr.grad_clip)
    finally:
        jgs._ONEHOT_BWD_MAX_ROWS = saved


def _port_trainer(world, tmp, impl, dropout=0.0, cbam=True, **kw):
    _, conf = recipe("gated", dropout=dropout, cbam=cbam)
    net = make_model(conf["model"], mlp_impl=impl, device="cpu", diff_mode=True)
    net.load_state_dict(from_jax_variables(world["variables"] if cbam
                                           else _without_cbam(world["variables"])))
    ds = SyntheticDataset(**STEP_DATA)
    return Trainer(net, ds, ds, NeRFRenderer.from_conf(conf["renderer"]),
                   _Args(str(tmp), check_gradients=True, grad_clip=1.0, **kw), conf)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_train_steps_match_jax_trainer(world, jax_steps, tmp_path, impl):
    """The encoder, the adaptive gate and the attention fusion train with the
    field: three steps on the plain route and the kernel route (its plain
    versions) against the JAX trainer; the fusion's parameters are in the
    optimizer and the checkpoint, and their running statistics move."""
    tr = _port_trainer(world, tmp_path, impl, cbam=False)
    assert tr.optimizer.clip == jax_steps["clip"] == 1.0  # the recipe's grad_clip
    opt = {id(p) for p in tr.optimizer.params}
    for stage in (tr.net.feature_fusion, tr.net.adaptive_sampler):
        assert all(id(p) in opt for p in stage.parameters())
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    tr.rng = np.random.default_rng(7)
    for step, (draws, want) in enumerate(jax_steps["steps"]):
        got = tr.train_step(jax_steps["data"], draws=draws)
        assert np.isfinite(float(got["t"])), got
        np.testing.assert_allclose(float(got["t"]), want["t"], rtol=2e-3, err_msg=f"step {step}")
        np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"], rtol=5e-3,
                                   err_msg=f"step {step}")
    after = tr.net.state_dict()
    for k in ("feature_fusion.fusion.1.running_mean", "feature_fusion.projections.3.1.running_var",
              "feature_fusion.fusion.0.weight", "adaptive_sampler.quality_fc1.2.weight"):
        assert not torch.equal(after[k], before[k]), k
    assert any(k.startswith("feature_fusion.") for k in tr._payload()["model"])


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_cbam_train_step_matches_float64(world, jax_steps, impl):
    """The gated recipe with CBAM: one f32 train step (plain route, and the
    kernel route's plain versions) against the same step in float64 on the
    plain route, from the same weights, batch and JAX draws, at the bars
    above; and every gradient of the encoder, the gate and the fusion at
    cosine >= 0.9999."""
    _, conf = recipe("gated")
    draws = jax_steps["steps"][0][0]
    rcfg = NeRFRenderer.from_conf(conf["renderer"]).cfg
    steps = {}
    for dt, route in ((torch.float64, "torch"), (torch.float32, impl)):
        net = make_model(conf["model"], mlp_impl=route, device="cpu", diff_mode=True)
        net.load_state_dict(from_jax_variables(world["variables"]))
        net.to(dt)
        batch = prepare_ray_batch(jax_steps["data"], 1, 24, 0.8, 1.8, True,
                                  np.random.default_rng(7))
        batch = {k: torch.from_numpy(np.asarray(v)).to(dt) for k, v in batch.items()}
        d = RayDraws(**{f.name: getattr(draws, f.name).to(dt) for f in dataclasses.fields(draws)
                        if torch.is_tensor(getattr(draws, f.name))})
        train_step, _ = make_step_fns(net, Optimizer(list(net.parameters()), lambda t: 0.0),
                                      lambda: rcfg, 1.0, 1.0, l2_loss, l2_loss, True, amp=False,
                                      remat=False)
        out = train_step(batch, None, d)
        steps[dt] = (float(out["t"]), float(out["grad_norm"]),
                     {k: p.grad.double().flatten() for k, p in net.named_parameters()})
    (l64, n64, g64), (l32, n32, g32) = steps[torch.float64], steps[torch.float32]
    np.testing.assert_allclose(l32, l64, rtol=2e-3)
    np.testing.assert_allclose(n32, n64, rtol=5e-3)
    for k, g in g64.items():
        if k.startswith(("encoder.", "feature_fusion.", "adaptive_sampler.")) and g.norm() > 1e-6:
            cos = float(g32[k] @ g / (g32[k].norm() * g.norm()))
            assert cos >= 0.9999, (k, cos)


def test_train_step_with_fusion_dropout_is_reproducible(world, tmp_path):
    """The recipe's ``fusion_dropout = 0.1`` in a train step draws from the
    trainer's generator: two trainers from one seed take the same step, a
    third from another seed does not; ``--freeze_enc`` leaves the encoder,
    the gate and the fusion without gradient."""
    losses = []
    for seed in (7, 7, 8):
        tr = _port_trainer(world, tmp_path / str(len(losses)), "torch", dropout=0.1)
        tr.rng = np.random.default_rng(1)
        tr.generator.manual_seed(seed)
        losses.append(float(tr.train_step(_step_batch())["t"]))
    assert losses[0] == losses[1] != losses[2]

    tr = _port_trainer(world, tmp_path / "frozen", "torch", dropout=0.1)
    tr.net.stop_encoder_grad = True
    tr.rng = np.random.default_rng(1)
    tr.train_step(_step_batch())
    for name, p in tr.net.named_parameters():
        frozen = name.startswith(("encoder.", "feature_fusion.", "adaptive_sampler."))
        assert (torch.count_nonzero(p.grad) == 0) == frozen, name


def test_train_cli_and_gen_video_on_a_multiscale_conf(tmp_path):
    """``python -m pixelnerf_tpu_torch.train -c <multi-scale conf>`` (in
    process, CPU, the recipe's dropout) writes a checkpoint that
    ``python -m pixelnerf_tpu_torch.eval.gen_video`` renders from."""
    text = open(RECIPE).read().replace("backbone = resnet34", "backbone = resnet18").replace(
        "pretrained = true", "pretrained = false").replace("d_hidden = 512", "d_hidden = 32")
    path = tmp_path / "ms.conf"
    default = os.path.join(os.path.dirname(RECIPE), "..", "default_mv.conf")
    path.write_text(text.replace('include required("../default_mv.conf")',
                                 f'include required("{default}")'))
    ck = str(tmp_path / "ck")
    trainer = train_main(["--device", "cpu", "-F", "synthetic", "-c", str(path), "-n", "ms",
                          "--checkpoints_path", ck, "--epochs", "1", "-B", "2", "-R", "8",
                          "--visual_path", str(tmp_path / "vis"), "--logs_path",
                          str(tmp_path / "logs")])
    assert trainer.global_step > 0 and all(np.isfinite(trainer.history))
    assert trainer.net.feature_fusion.dropout == 0.1
    assert os.path.exists(os.path.join(ck, "ms", "pixel_nerf_latest"))
    res = gen_video_main(["--device", "cpu", "-n", "ms", "-c", str(path), "-F", "synthetic",
                          "--checkpoints_path", ck, "--split", "test", "-S", "0", "-P", "0",
                          "--num_views", "2", "--visual_path", str(tmp_path / "vis"),
                          "-R", "512"])
    assert res["frames"].shape[0] == 2 and len(os.listdir(res["frame_dir"])) == 2
