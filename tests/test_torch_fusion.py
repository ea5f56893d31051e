"""The port's multi-scale fusion modules against the JAX package, in f32 on
the CPU: ``resize_bilinear`` (up and down), every attention module,
``SmartFeatureFusion`` (attention and weighted, CBAM on and off, eval mode
and train mode with its updated running statistics),
``AdaptiveFeatureSampler`` (the soft gate, the qualities and ``select``),
``MultiScaleFusionModule`` and ``create_feature_fusion``; the fusion
dropout's draws; a port checkpoint read back by ``convert_pixelnerf``; and
the eval CLI on a multi-scale conf against the repository's
``eval/eval.py``.

Inputs come from a numpy seed; weights go JAX -> port through
``from_jax_variables`` (the standalone modules nested where the model holds
them).  Tolerance: ``max|d| <= 1e-4 * max(1, max|ref|)``."""

import re
import runpy
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.models import PixelNeRFNet as JPixelNeRFNet
from pixelnerf_tpu.models import attention as jatt
from pixelnerf_tpu.models import fusion as jfusion
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.ops.grid_sample import resize_bilinear as jresize_bilinear
from pixelnerf_tpu.utils import torch_convert
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.eval.eval import main as eval_main
from pixelnerf_tpu_torch.models import (
    CBAM,
    AdaptiveFeatureSampler,
    ChannelAttention,
    CrossViewAttention,
    MultiScaleFusionModule,
    MultiViewAttention,
    SmartFeatureFusion,
    SpatialAttention,
    create_feature_fusion,
    make_model,
)
from pixelnerf_tpu_torch.models.fusion import dropout
from pixelnerf_tpu_torch.ops.grid_sample import resize_bilinear
from pixelnerf_tpu_torch.train import checkpoints
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4


def close(port, ref, tol=TOL, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    bar = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bar, f"{what} max|d| {err:.3g} > {bar:.3g}"


def maps(shapes, seed=0, batch=2):
    """NHWC maps [(batch, h, w, c), ...] from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch,) + tuple(s)).astype(np.float32) for s in shapes]


def bump(variables, seed=1):
    """Live weights: random biases, BatchNorm affines and statistics, gates."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = visit(v)
                continue
            v = np.array(v, np.float32)
            if k in ("bias", "mean", "scale_logits"):
                v = rng.normal(size=v.shape).astype(np.float32) * 0.1
            elif k in ("scale", "var"):
                v = rng.uniform(0.6, 1.4, size=v.shape).astype(np.float32)
            elif k == "gamma":
                v = np.full(v.shape, 0.5, np.float32)
            out[k] = v
        return out

    return visit(jax.tree.map(np.asarray, dict(variables)))


def jinit(module, *args, **kw):
    return bump(module.init(jax.random.PRNGKey(0), *args, **kw))


def nested_state(variables, path):
    """A standalone module's JAX variables -> its port state dict, through
    ``from_jax_variables`` with the module nested at ``path`` of the model."""
    wrapped = {}
    for coll, tree in variables.items():
        for k in reversed(path):
            tree = {k: tree}
        wrapped[coll] = tree
    prefix = ".".join(path) + "."
    return {k[len(prefix):]: v for k, v in from_jax_variables(wrapped).items()}


def plain_state(variables):
    """Variables of a module outside the model (no reference naming) ->
    Linear / LayerNorm state: kernel (I, O) -> weight (O, I), scale ->
    weight, ``unify_i`` -> ``unify.i``, bare parameters as they are."""
    sd = {}

    def visit(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                visit(v, path + (re.sub(r"^(unify)_(\d+)$", r"\1.\2", k),))
                continue
            v = np.array(v, np.float32)
            name = {"kernel": "weight", "scale": "weight"}.get(k, k)
            sd[".".join(path + (name,))] = torch.from_numpy(np.array(v.T if k == "kernel" else v))

    visit(variables["params"], ())
    return sd


def port(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


def tt(xs):
    return [torch.from_numpy(x) for x in xs]


# ---------------------------------------------------------------------------
# resize_bilinear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((16, 16), (32, 32)), ((8, 8), (32, 32)),
                                     ((5, 7), (32, 32)), ((32, 32), (8, 8)),
                                     ((32, 32), (5, 7))])
def test_resize_bilinear_matches_jax(src, dst):
    """2x, 4x and 5 x 7 -> 32 x 32 upsampling (SmartFeatureFusion's), 32 ->
    8 and 32 -> 5 x 7 downsampling (MultiScaleFusionModule's, antialiased
    in JAX)."""
    (x,) = maps([src + (6,)], seed=sum(src) + sum(dst))
    ref = jresize_bilinear(jnp.asarray(x), *dst)
    close(resize_bilinear(torch.from_numpy(x), *dst), ref, what=f"{src}->{dst}")
    if dst[0] >= src[0] and dst[1] >= src[1]:  # upsampling: F.interpolate's half-pixel resize
        up = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst,
                                             mode="bilinear", align_corners=False)
        close(up.permute(0, 2, 3, 1), ref, what="F.interpolate")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def test_channel_spatial_and_cbam_match_jax():
    (x,) = maps([(9, 11, 32)], seed=3)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    path = ("feature_fusion", "cbam")
    for jmod, tmod, sub in ((jatt.ChannelAttention(32), ChannelAttention(32), ("channel_attn",)),
                            (jatt.SpatialAttention(), SpatialAttention(), ("spatial_attn",)),
                            (jatt.CBAM(32), CBAM(32), ())):
        v = jinit(jmod, xj)
        ref = jmod.apply(v, xj)
        close(port(tmod, nested_state(v, path + sub))(xt), ref, what=type(tmod).__name__)
    # the reference layout: bias-free 1x1 convolutions and a bias-free 7x7 conv
    names = {k: tuple(t.shape) for k, t in CBAM(32).state_dict().items()}
    assert names == {"channel_attn.fc.0.weight": (2, 32, 1, 1),
                     "channel_attn.fc.2.weight": (32, 2, 1, 1),
                     "spatial_attn.conv.weight": (1, 2, 7, 7)}


def test_multi_and_cross_view_attention_match_jax():
    a, b = maps([(6, 5, 32), (6, 5, 32)], seed=4)
    mva = jatt.MultiViewAttention(32, num_heads=4)
    v = jinit(mva, jnp.asarray(a))
    close(port(MultiViewAttention(32, 4), plain_state(v))(torch.from_numpy(a)),
          mva.apply(v, jnp.asarray(a)), what="MultiViewAttention")
    cva = jatt.CrossViewAttention(32)
    v = jinit(cva, jnp.asarray(a), jnp.asarray(b))
    assert float(v["params"]["gamma"][0]) == 0.5  # a live residual gate
    close(port(CrossViewAttention(32), plain_state(v))(torch.from_numpy(a), torch.from_numpy(b)),
          cva.apply(v, jnp.asarray(a), jnp.asarray(b)), what="CrossViewAttention")
    with pytest.raises(ValueError, match="divide"):
        MultiViewAttention(30, 4)


# ---------------------------------------------------------------------------
# SmartFeatureFusion
# ---------------------------------------------------------------------------

PYRAMID = [(16, 16, 16), (16, 16, 16), (8, 8, 24), (4, 4, 32)]


@pytest.mark.parametrize("use_attention,use_cbam,shapes,out_dim", [
    (True, True, PYRAMID, 64),
    (False, True, PYRAMID, 64),  # fusion_type = weighted
    (True, False, PYRAMID, 64),
    (True, True, PYRAMID[1:], 64),  # 3 scales: 21 channels each, a 63-wide concat
])
def test_smart_feature_fusion_matches_jax(use_attention, use_cbam, shapes, out_dim):
    """Eval mode on the running statistics; then train mode on batch
    statistics, with the running statistics updated as flax updates them."""
    feats = maps(shapes, seed=len(shapes) + use_attention + 2 * use_cbam)
    dims = tuple(s[-1] for s in shapes)
    kw = dict(output_dim=out_dim, use_attention=use_attention, use_cbam=use_cbam)
    jmod = jfusion.SmartFeatureFusion(layer_dims=dims, **kw)
    fj = [jnp.asarray(f) for f in feats]
    v = jinit(jmod, fj)
    tmod = port(SmartFeatureFusion(dims, **kw), nested_state(v, ("feature_fusion",)))
    assert hasattr(tmod, "channel_attention") == use_attention
    assert hasattr(tmod, "cbam") == use_cbam
    close(tmod(tt(feats)), jmod.apply(v, fj), what="eval")

    ref, mutated = jmod.apply(v, fj, train=True, mutable=["batch_stats"])
    tmod.train()
    close(tmod(tt(feats)), ref, what="train")
    stats = nested_state({"batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])},
                         ("feature_fusion",))
    state = tmod.state_dict()
    for k, want in stats.items():
        if "running" in k:
            close(state[k], want, what=k)


def test_fusion_dropout_draws_from_the_generator():
    """The same generator seed gives the same output and the global
    generator is not touched; the kept share sits near 1 - rate and the kept
    values are scaled by 1 / (1 - rate); eval mode draws nothing; train mode
    without a generator raises."""
    feats = tt(maps(PYRAMID[1:], seed=9))
    mod = SmartFeatureFusion((16, 24, 32), output_dim=48, dropout=0.25).train()
    torch.manual_seed(123)
    before = torch.rand(4)
    torch.manual_seed(123)
    out1 = mod(feats, generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.rand(4), before)
    out2 = mod(feats, generator=torch.Generator().manual_seed(5))
    out3 = mod(feats, generator=torch.Generator().manual_seed(6))
    assert torch.equal(out1, out2) and not torch.equal(out1, out3)
    with pytest.raises(ValueError, match="generator"):
        mod(feats)
    mod.eval()
    assert torch.equal(mod(feats), mod(feats))

    x = torch.full((400_000,), 2.0)
    for rate in (0.1, 0.5):
        y = dropout(x, rate, True, torch.Generator().manual_seed(0))
        kept = y != 0
        assert abs(kept.float().mean().item() - (1 - rate)) < 0.005, rate
        assert torch.all(y[kept] == torch.tensor(2.0) / (1 - rate))
    assert dropout(x, 0.1, False, None) is x


# ---------------------------------------------------------------------------
# AdaptiveFeatureSampler, MultiScaleFusionModule, create_feature_fusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
def test_adaptive_sampler_matches_jax(threshold):
    """The qualities, the soft gate (some scales under the threshold at
    0.5 / 0.7) and the host-side ``select`` against JAX's at several
    thresholds and ``top_k``."""
    feats = maps(PYRAMID, seed=11, batch=3)
    fj = [jnp.asarray(f) * 3.0 for f in feats]
    ft = [torch.from_numpy(f) * 3.0 for f in feats]
    jmod = jfusion.AdaptiveFeatureSampler(feature_dim=32, quality_threshold=threshold)
    v = jinit(jmod, fj)
    tmod = port(AdaptiveFeatureSampler(32, threshold, layer_dims=[s[-1] for s in PYRAMID]),
                nested_state(v, ("adaptive_sampler",)))
    q_ref = np.asarray(jmod.apply(v, fj, return_q=True))
    q = tmod(ft, return_q=True)
    close(q, q_ref, what="qualities")
    for a, b in zip(tmod(ft), jmod.apply(v, fj)):
        close(a, b, what="gated")
    for top_k, thr in ((None, threshold), (2, 0.3), (1, 0.0), (None, 0.999)):
        got = AdaptiveFeatureSampler.select(ft, q, top_k=top_k, quality_threshold=thr)
        want = jfusion.AdaptiveFeatureSampler.select(fj, q_ref, top_k=top_k,
                                                     quality_threshold=thr)
        assert got[1] == want[1], (top_k, thr)
        assert all(a is ft[i] for a, i in zip(got[0], got[1]))


def test_multiscale_fusion_module_matches_jax():
    """1x1 unification, an antialiased resize to the coarsest (5 x 7) map,
    softmax-weighted sum."""
    feats = maps([(16, 16, 8), (8, 8, 12), (5, 7, 16)], seed=12)
    jmod = jfusion.MultiScaleFusionModule(layer_dims=(8, 12, 16), output_dim=24)
    fj = [jnp.asarray(f) for f in feats]
    v = jinit(jmod, fj)
    tmod = port(MultiScaleFusionModule((8, 12, 16), 24), plain_state(v))
    close(tmod(tt(feats)), jmod.apply(v, fj))


def test_create_feature_fusion_matches_jax():
    for kw in (dict(layer_dims=(8, 16)), dict(feature_dim=16), dict(feature_dim=16,
                                                                    fusion_type="adaptive")):
        j, t = jfusion.create_feature_fusion(**kw), create_feature_fusion(**kw)
        assert type(t).__name__ == type(j).__name__
    for kw, msg in ((dict(), "feature_dim or layer_dims"), (dict(fusion_type="adaptive"),
                                                           "required"),
                    (dict(feature_dim=8, fusion_type="x"), "Unknown")):
        with pytest.raises(ValueError, match=msg):
            create_feature_fusion(**kw)


# ---------------------------------------------------------------------------
# the model: a port checkpoint read by the JAX package; the eval CLI
# ---------------------------------------------------------------------------

CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 4\n freq_factor = 1.5\n include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet\n n_blocks = 3\n d_hidden = 32\n combine_layer = 2 }
    mlp_fine { type = resnet\n n_blocks = 3\n d_hidden = 32\n combine_layer = 2 }
    encoder { backbone = resnet18\n pretrained = False\n num_layers = 4
              use_first_pool = False\n use_multi_scale = True }
    use_smart_fusion = True
    fusion_type = attention
    fusion_dropout = 0.1
    use_cbam = True
    use_adaptive_sampling = False
}
renderer {
    n_coarse = 8\n n_fine = 6\n n_fine_depth = 3\n white_bkgd = True\n sched = []
}
"""


def _live_port_model(text=CONF, seed=4):
    """The port's seeded model with every fusion layer live (BatchNorm
    statistics and affines off their init, biases non-zero)."""
    net = make_model(hocon.parse_string(text)["model"], device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.startswith(("feature_fusion.", "adaptive_sampler.")) and t.is_floating_point():
                if name.endswith(("running_var", "weight")) and t.ndim == 1:
                    t.copy_(0.7 + 0.6 * torch.rand(t.shape, generator=g))
                elif name.endswith(("bias", "running_mean")):
                    t.copy_(0.1 * torch.randn(t.shape, generator=g))
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(0.1 * torch.randn(blk.fc_1.weight.shape, generator=g))
    return net


def test_port_checkpoint_through_convert_pixelnerf():
    """Port ``state_dict`` -> ``convert_pixelnerf`` -> the JAX model's output
    equals the port's (fusion on, the adaptive gate off); the converter has
    no rule for ``adaptive_sampler.*`` and drops those keys."""
    net = _live_port_model()
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)[None]
    pose[:, 2, 3] = 1.5
    xyz = (rng.normal(size=(1, 60, 3)) * 0.3).astype(np.float32)
    vd = rng.normal(size=(1, 60, 3)).astype(np.float32)
    jnet = jmake_model(jhocon.parse_string(CONF)["model"])
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), img, pose, jnp.float32(40.0),
                            xyz, vd)
    back = torch_convert.convert_pixelnerf(net.state_dict())
    assert torch_convert.tree_shapes_match(
        back, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), dict(shapes))) == []
    scene = net.encode(torch.from_numpy(img), torch.from_numpy(pose), 40.0)
    jscene = jnet.apply(back, jnp.asarray(img), jnp.asarray(pose), jnp.float32(40.0),
                        method=JPixelNeRFNet.encode)
    close(scene.latents, jscene.latents, what="fused latents")
    for coarse in (True, False):
        with torch.no_grad():
            out = net.query(scene, torch.from_numpy(xyz), torch.from_numpy(vd), coarse=coarse)
        close(out, jnet.apply(back, jscene, jnp.asarray(xyz), viewdirs=jnp.asarray(vd),
                              coarse=coarse, method=JPixelNeRFNet.query), what=f"coarse={coarse}")

    gated = _live_port_model(CONF.replace("use_adaptive_sampling = False",
                                          "use_adaptive_sampling = True"))
    assert any(k.startswith("adaptive_sampler.") for k in gated.state_dict())
    assert "adaptive_sampler" not in torch_convert.convert_pixelnerf(gated.state_dict())["params"]


def test_eval_cli_on_a_multiscale_conf_matches_jax_eval(tmp_path, monkeypatch):
    """``-F synthetic --split test -P 0 --max_objs 1`` and one eval view, on a
    checkpoint of the port's multi-scale model, through the port's CLI and
    the repository's ``eval/eval.py``: the same target view, PSNR within
    0.5 dB and SSIM within 0.02 (the CLIs draw their samples from different
    generators, as in ``tests/test_torch_eval.py``)."""
    conf = tmp_path / "ms.conf"
    conf.write_text(CONF)
    (tmp_path / "views.txt").write_text("3\n")
    ck = tmp_path / "ck"
    checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=str(ck), name="ms"),
                             _live_port_model())

    def argv(out):
        return ["-n", "ms", "-c", str(conf), "-F", "synthetic", "--checkpoints_path", str(ck),
                "--split", "test", "-P", "0", "--max_objs", "1", "--eval_view_list",
                str(tmp_path / "views.txt"), "-O", str(tmp_path / out)]

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["eval/eval.py"] + argv("jax_out"))
    runpy.run_path(str(ROOT / "eval" / "eval.py"), run_name="__main__")
    res = eval_main(argv("port_out") + ["--device", "cpu"])
    jj = (tmp_path / "jax_out" / "finish.txt").read_text().split()
    assert sorted(p.name for p in (tmp_path / "port_out" / "0").iterdir()) == ["000003.png"]
    assert sorted(p.name for p in (tmp_path / "jax_out" / "0").iterdir()) == ["000003.png"]
    (name, psnr, ssim), = res["objects"]
    assert name == jj[0] == "0" and np.isfinite(psnr) and np.isfinite(ssim)
    assert abs(psnr - float(jj[1])) <= 0.5 and abs(ssim - float(jj[2])) <= 0.02
