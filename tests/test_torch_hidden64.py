"""The slice as a whole at d_hidden 64, on the CPU: ``conf/exp/sn64.conf``
with both heads' d_hidden set to 64 (5 blocks, the 512-wide latent in
blocks 0-2, the views' mean at block 3, the 6-frequency code; a random
encoder), the weights carried across from the JAX parameters by
``utils/jax_convert.py::from_jax_variables``.

* ``query`` from 1 and 3 source views on the kernel route (``impl="cuda"``:
  on CPU tensors the kernels' plain versions, at a fused-gather cap above
  the views' 1024-row tables and at 0, so the gather and the dense routes)
  against the JAX model's Pallas kernels in interpret mode
  (``PIXELNERF_PALLAS_INTERPRET=1``), 1e-4 of max(1, max|ref|) (f32 sums
  reassociated), as ``tests/test_torch_multiview.py`` holds them at its
  small width.
* ``render_rays`` from 1 and 3 views against JAX's ``render_rays`` fed the
  same draws, at the same bar.
* One trainer step at ``-V 1`` on the kernel route (its autograd Function,
  the backward's plain transcription) against the JAX ``Trainer``: loss
  rtol 2e-3 and grad norm rtol 5e-3, the bars of
  ``tests/test_torch_train_step.py``.

sn64's renderer is cut to 8 coarse and 6 fine samples (3 around the depth)
and its images to 64 px, NMR's own size: the model's widths stay sn64's.
The kernels themselves run on the card only; ``chip_smoke.py`` (phases 17
and 18) holds them against these plain versions there."""

import importlib
from pathlib import Path

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
from pixelnerf_tpu.render import NeRFRenderer as JNeRFRenderer
from pixelnerf_tpu.render import renderer as jrenderer
from pixelnerf_tpu.train.trainer import Trainer as JTrainer
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import SyntheticDataset
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from pixelnerf_tpu_torch.render import NeRFRenderer, RayDraws, RenderConfig, render_rays
from pixelnerf_tpu_torch.train import Trainer
from pixelnerf_tpu_torch.utils.geometry import gen_rays_np, pose_spherical
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

SN64 = Path(__file__).resolve().parent.parent / "conf" / "exp" / "sn64.conf"
H = 64
IMG = 64
TOL = 1e-4
SAMPLES = dict(n_coarse=8, n_fine=6, n_fine_depth=3)
# the ops package re-exports a function under the module's name
jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")


def _conf(parse_file, H=H, n_blocks=None, num_freqs=None):
    """sn64's conf at d_hidden H (64 here; other widths' slices read it
    too), and ``n_blocks`` blocks and a code of ``num_freqs`` frequencies
    over (xyz, viewdir) (``use_code_viewdirs``) when given, through one
    package's parser: a random encoder, the test's few samples a ray."""
    conf = parse_file(str(SN64))
    conf.put("model.encoder.pretrained", False)
    for head in ("mlp_coarse", "mlp_fine"):
        conf.put(f"model.{head}.d_hidden", H)
        if n_blocks is not None:
            conf.put(f"model.{head}.n_blocks", n_blocks)
    if num_freqs is not None:
        conf.put("model.use_code_viewdirs", True)
        conf.put("model.code.num_freqs", num_freqs)
    for k, v in SAMPLES.items():
        conf.put(f"renderer.{k}", v)
    return conf


def close(port, ref, tol=TOL, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    bar = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bar, f"{what} max|d| {err:.3g} > {bar:.3g}"


def _bump(variables, rng):
    """Every fc_1 and every head bias live (fc_1 starts at zero)."""

    def go(tree, path=()):
        if isinstance(tree, dict):
            return {k: go(v, path + (k,)) for k, v in tree.items()}
        v = np.array(tree, np.float32)
        if ("fc_1" in path and path[-1] == "kernel") or (
                len(path) > 1 and path[1].startswith("mlp") and path[-1] == "bias"):
            v = rng.normal(size=v.shape).astype(np.float32) * 0.1
        return v

    return go(jax.tree.map(np.asarray, dict(variables)))


@pytest.fixture(scope="module")
def world():
    return make_world(H)


def make_world(H):
    """Three source views of one object, query points, rays, and JAX
    variables of the d_hidden H model."""
    ds = SyntheticDataset(n_objs=1, n_views=3, image_size=IMG, seed=2)
    s = ds[0]
    rng = np.random.default_rng(9)
    B = 60
    xyz = (rng.normal(size=(1, B, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(1, B, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    conf = _conf(jhocon.parse_file, H)
    jnet = jmake_model(conf["model"], mlp_impl="xla")
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(s["images"][None, :1]),
                                   jnp.asarray(s["poses"][None, :1]), jnp.asarray(s["focal"]),
                                   jnp.asarray(xyz), jnp.asarray(vd))
    rays = gen_rays_np(pose_spherical(40.0, -20.0, 1.3)[None], IMG, IMG, s["focal"],
                       ds.z_near, ds.z_far).reshape(-1, 8)[::37][:48]
    return dict(images=s["images"], poses=s["poses"], focal=np.float32(s["focal"]), xyz=xyz,
                vd=vd, conf=conf, variables=_bump(variables, rng), rays=rays, H=H)


def _jax_scene(world, NS):
    jnet = jmake_model(world["conf"]["model"], mlp_impl="xla")
    return jnet.apply(world["variables"], jnp.asarray(world["images"][None, :NS]),
                      jnp.asarray(world["poses"][None, :NS]), jnp.asarray(world["focal"]),
                      method=JPixelNeRFNet.encode)


def _port(world, NS):
    net = make_model(_conf(hocon.parse_file, world["H"])["model"], mlp_impl="cuda", device="cpu")
    net.load_state_dict(from_jax_variables(world["variables"]))
    assert net.mlp_fine.d_hidden == net.mlp_coarse.d_hidden == world["H"]
    assert (net.mlp_fine.n_blocks, net.mlp_fine.combine_layer, net.d_latent) == (5, 3, 512)
    scene = net.encode(torch.from_numpy(world["images"][None, :NS]),
                       torch.from_numpy(world["poses"][None, :NS]), float(world["focal"]))
    return net, scene


def takes_the_kernels_on_a_card(H, n_blocks=None):
    """Under ``auto`` the route rule sends the heads of sn64's model at
    d_hidden H to the kernels on a CUDA device, forward and under grad, from
    1 and 3 views, reading only the width's mirrored limits."""
    net = make_model(_conf(hocon.parse_file, H, n_blocks)["model"], mlp_impl="auto",
                     device="meta")
    cuda = torch.device("cuda")  # compared by type only: nothing is allocated on it
    for mlp in (net.mlp_coarse, net.mlp_fine):
        assert mlp.d_hidden == H and mlp.n_blocks == (n_blocks or 5)
        assert all(mlp._kernel_route((NS, 64), cuda, grad) for NS in (1, 3)
                   for grad in (False, True))
    assert not rf._LIBS and not rv._LIBS


def test_d_hidden_64_takes_the_kernels_on_a_card():
    """The d_hidden 64 heads: the 64 library's mirrored limits take sn64's
    other widths."""
    takes_the_kernels_on_a_card(H)


@pytest.mark.parametrize("NS,cap", [(1, 2048), (1, 0), (3, 4096), (3, 0)])
def test_query_at_d_hidden_64_matches_jax(world, monkeypatch, NS, cap):
    """The fused gather (row 1) or the dense forward (row 2) from one view,
    the multi-view gather (row 4) or dense forward (row 3) from three, in
    their plain versions, against the JAX Pallas kernels in interpret
    mode; both heads."""
    query_matches_jax(world, monkeypatch, NS, cap)


def query_matches_jax(world, monkeypatch, NS, cap):
    """``query`` of ``world``'s model from NS views at a fused-gather cap
    of ``cap`` rows against the JAX model's Pallas kernels in interpret
    mode, both heads."""
    monkeypatch.setenv("PIXELNERF_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PIXELNERF_FUSED_GATHER_MAX_ROWS", str(cap))
    jscene = _jax_scene(world, NS)
    jnet = jmake_model(world["conf"]["model"], mlp_impl="pallas")
    net, scene = _port(world, NS)
    assert net._fused_gather_ok(scene.latents, NS) == (cap > 0)
    rf.reset_launches()
    for coarse in (True, False):
        ref = jnet.apply(world["variables"], jscene, jnp.asarray(world["xyz"]),
                         viewdirs=jnp.asarray(world["vd"]), coarse=coarse, planar_out=True,
                         method=JPixelNeRFNet.query)
        with torch.no_grad():
            out = net.query(scene, torch.from_numpy(world["xyz"]), torch.from_numpy(world["vd"]),
                            coarse=coarse, planar_out=True)
        close(out, ref, what=f"NS={NS} coarse={coarse}")
    assert not any(rf.LAUNCHES.values())  # CPU tensors never launch a kernel


@pytest.fixture(scope="module")
def jax_render(world):
    return make_jax_render(world)


def make_jax_render(world, views=(1, 3)):
    """JAX render_rays (XLA field) from each view count of ``views`` (1 and
    3 source views), and the draws its key split gives."""
    cfg = jrenderer.RenderConfig(**SAMPLES, white_bkgd=True, depth_std=0.01, eval_batch_size=0)
    jnet = jmake_model(world["conf"]["model"], mlp_impl="xla")
    rays = jnp.asarray(world["rays"])[None]
    rng = jax.random.PRNGKey(5)

    @jax.jit
    def run(variables, scene, rays, rng):
        def field(points, viewdirs, coarse):
            return jnet.apply(variables, scene, points, viewdirs=viewdirs, coarse=coarse,
                              planar_out=True, method=JPixelNeRFNet.query)

        return jrenderer.render_rays(field, rays, rng, cfg, want_weights=True)

    outs = {NS: jax.tree.map(np.asarray, run(world["variables"], _jax_scene(world, NS), rays, rng))
            for NS in views}
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
    return outs, draws, RenderConfig(**SAMPLES, white_bkgd=True, depth_std=0.01,
                                     eval_batch_size=0)


@pytest.mark.parametrize("NS", [1, 3])
def test_render_rays_at_d_hidden_64_matches_jax(world, jax_render, NS):
    render_rays_matches_jax(world, jax_render, NS)


def render_rays_matches_jax(world, jax_render, NS, tol=TOL):
    """Encode, the kernel route's query (plain versions), the samplers and
    the compositing from NS views against JAX's render_rays on the same
    draws: weights, rgb and depth of both passes, to ``tol`` of max(1,
    max|ref|)."""
    refs, draws, cfg = jax_render
    ref = refs[NS]
    net, scene = _port(world, NS)

    def field(points, viewdirs, coarse):
        return net.query(scene, points, viewdirs=viewdirs, coarse=coarse, planar_out=True)

    with torch.no_grad():
        out = render_rays(field, torch.from_numpy(world["rays"])[None], cfg,
                          draws=RayDraws(**draws), want_weights=True)
    close(out["coarse"]["weights"], ref["coarse"]["weights"], tol, what="coarse weights")
    for head in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            close(out[head][k], ref[head][k], tol, what=f"NS={NS} {head} {k}")


class _Args:
    def __init__(self, tmp):
        self.name = "t"
        self.checkpoints_path = str(tmp / "ck")
        self.visual_path = str(tmp / "vis")
        self.logs_path = str(tmp / "logs")
        self.epochs = 10000
        self.lr = 5e-4
        self.gamma = 1.0
        self.ray_batch_size = 24
        self.nviews = "1"
        self.batch_size = 2
        self.resume = False
        self.use_amp = False
        self.grad_clip = 0.0
        self.check_gradients = False
        self.no_bbox_step = 100000


def _jax_draws(key, n_rays, cfg):
    """The random numbers the JAX trainer's next step draws."""
    key, step = jax.random.split(key)
    rng_render, _ = jax.random.split(step)
    k_c, _, k_f, k_fd, _ = jax.random.split(rng_render, 5)
    k_u, k_j = jax.random.split(k_f)
    n_imp = cfg.n_fine - cfg.n_fine_depth
    draws = dict(
        coarse=jax.random.uniform(k_c, (n_rays, cfg.n_coarse)),
        fine_u=jax.random.uniform(k_u, (n_rays, n_imp), dtype=jnp.float32),
        fine_jitter=jax.random.uniform(k_j, (n_rays, n_imp)),
        depth=jax.random.normal(k_fd, (n_rays, cfg.n_fine_depth)),
    )
    return RayDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})


def test_train_step_at_d_hidden_64_matches_jax_trainer(tmp_path, monkeypatch):
    """One ``-V 1`` step of the kernel route (the dense forward's plain
    version and the backward's plain transcription through the autograd
    Function; remat off, as on the card) against the JAX trainer: the same
    weights, batch, host generator and render draws."""
    train_step_matches_jax_trainer(tmp_path, monkeypatch, H)


def train_step_matches_jax_trainer(tmp_path, monkeypatch, H, n_blocks=None, num_freqs=None):
    """One ``-V 1`` trainer step of sn64's conf at d_hidden H (and
    ``n_blocks`` blocks, a code of ``num_freqs`` frequencies over (xyz,
    viewdir)) on the kernel route against the JAX trainer; returns the
    port's trainer."""
    monkeypatch.setattr(jgs, "_ONEHOT_BWD_MAX_ROWS", 0)  # read when the JAX step is traced
    jds = JSyntheticDataset(n_objs=3, n_views=4, image_size=IMG)
    sample = jds[0]
    jconf = _conf(jhocon.parse_file, H, n_blocks, num_freqs)
    jnet = jmake_model(jconf["model"], mlp_impl="xla")
    variables = jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(sample["images"][None, :1]),
        jnp.asarray(sample["poses"][None, :1]), jnp.asarray(np.float32(sample["focal"])),
        jnp.zeros((1, 4, 3), jnp.float32), jnp.zeros((1, 4, 3), jnp.float32))
    variables = _bump(variables, np.random.default_rng(3))
    tr_j = JTrainer(jnet, variables, jds, jds, JNeRFRenderer.from_conf(jconf["renderer"]),
                    _Args(tmp_path / "j"), jconf)
    conf = _conf(hocon.parse_file, H, n_blocks, num_freqs)
    net = make_model(conf["model"], mlp_impl="cuda", device="cpu", diff_mode=True)
    net.load_state_dict(from_jax_variables(variables))
    ds = SyntheticDataset(n_objs=3, n_views=4, image_size=IMG)
    tr_p = Trainer(net, ds, ds, NeRFRenderer.from_conf(conf["renderer"]), _Args(tmp_path / "p"),
                   conf)
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
    return tr_p
