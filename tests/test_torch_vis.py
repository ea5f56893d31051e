"""The trainer's visuals against the JAX package, on the CPU:
``RenderPipeline.render`` with weights against JAX's ``render`` on JAX's
draws, the train CLI's ``vis_step`` grid against a grid built from the JAX
render in the layout of the root ``train/train.py``, and the port's train
CLI beside the root one with ``vis_interval = 1`` (the vis PNG, the
TensorBoard tags through a recording ``SummaryWriter``).

Weights cross through ``from_jax_variables``; inputs are seeded.  Bars:
rgb, depth and weights within 1e-4 of max(1, max|ref|); the vis grid within
one u8 level and its PSNR within 1e-3 dB.
"""

import os
import runpy
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.data import SyntheticDataset as JSyntheticDataset
from pixelnerf_tpu.models import PixelNeRFNet as JNet
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.parallel.pipeline import RenderPipeline as JRenderPipeline
from pixelnerf_tpu.render import renderer as jrenderer
from pixelnerf_tpu.utils import geometry as jgeo
from pixelnerf_tpu.utils import metrics as jmetrics
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import SyntheticDataset
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.parallel.pipeline import RenderPipeline
from pixelnerf_tpu_torch.render import NeRFRenderer
from pixelnerf_tpu_torch.train import cli
from pixelnerf_tpu_torch.train import main as train_main
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables
from pixelnerf_tpu_torch.utils.png import read_png
from test_torch_accel import pipeline_draws, tcfg
from test_torch_model import close
from test_torch_train_step import CONF, _Args

ROOT = Path(__file__).resolve().parent.parent
IMG = 16
TOL = 1e-4


@pytest.fixture(scope="module")
def world():
    """One set of weights (live fc_1) in both packages, the dataset pair and
    its first object."""
    jds = JSyntheticDataset(n_objs=2, n_views=4, image_size=IMG, seed=1)
    s = jds[0]
    jnet = jmake_model(jhocon.parse_string(CONF)["model"], mlp_impl="xla")
    variables = jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(s["images"][None, :1]),
        jnp.asarray(s["poses"][None, :1]), jnp.asarray(np.float32(s["focal"])),
        jnp.zeros((1, 4, 3), jnp.float32), jnp.zeros((1, 4, 3), jnp.float32))
    rng = np.random.default_rng(3)

    def bump(tree, path=()):
        if isinstance(tree, dict):
            return {k: bump(v, path + (k,)) for k, v in tree.items()}
        v = np.array(tree, np.float32)
        if "fc_1" in path and path[-1] == "kernel":
            v = rng.normal(size=v.shape).astype(np.float32) * 0.1
        return v

    variables = bump(jax.tree.map(np.asarray, dict(variables)))
    return dict(jds=jds, ds=SyntheticDataset(n_objs=2, n_views=4, image_size=IMG, seed=1),
                jnet=jnet, variables=variables, sample=s)


def _port_net(world, impl="auto", diff_mode=False):
    net = make_model(hocon.parse_string(CONF)["model"], mlp_impl=impl, device="cpu",
                     diff_mode=diff_mode)
    net.load_state_dict(from_jax_variables(world["variables"]))
    return net


def _renderers():
    conf = jhocon.parse_string(CONF)["renderer"]
    jr = jrenderer.NeRFRenderer.from_conf(conf)
    return jr, NeRFRenderer(tcfg(jr.cfg))


@pytest.mark.parametrize("views,ray_batch_size", [((0,), 96), ((0, 2), 170)])
def test_render_with_weights_matches_jax(world, views, ray_batch_size):
    """Two target views (512 rays) in chunks that leave a ragged last one,
    from one and two source views: every head's rgb, depth and weights."""
    s, v = world["sample"], list(views)
    images, poses = s["images"][None, v], s["poses"][None, v]
    focal = np.float32(s["focal"])
    jscene = world["jnet"].apply(world["variables"], jnp.asarray(images), jnp.asarray(poses),
                                 jnp.asarray(focal), method=JNet.encode)
    net = _port_net(world)
    scene = net.encode(torch.from_numpy(images), torch.from_numpy(poses), float(focal))
    rays = jgeo.gen_rays_np(s["poses"][[1, 3]], IMG, IMG, focal, 0.8, 1.8).reshape(-1, 8)
    jr, tr = _renderers()
    key = jax.random.PRNGKey(5)
    ref = JRenderPipeline(world["jnet"], jr).render(
        world["variables"], jscene, rays, key, ray_batch_size=ray_batch_size, want_weights=True)
    pipe = RenderPipeline(net, tr)
    out = pipe.render(scene, rays, torch.Generator().manual_seed(0),
                      ray_batch_size=ray_batch_size, want_weights=True,
                      draws=pipeline_draws(key, pipe))
    assert sorted(out) == sorted(ref) == ["coarse", "fine"]
    for head in ("coarse", "fine"):
        assert sorted(out[head]) == sorted(ref[head]) == ["depth", "rgb", "weights"]
        for k in ("rgb", "depth", "weights"):
            assert isinstance(out[head][k], np.ndarray) and out[head][k].shape[0] == 512
            close(out[head][k], ref[head][k], TOL, what=f"{head} {k}")
    assert out["fine"]["weights"].shape[1] == tr.cfg.n_coarse + tr.cfg.n_fine
    # without weights: the same rgb and no weights key
    plain = pipe.render(scene, rays, torch.Generator().manual_seed(0),
                        ray_batch_size=ray_batch_size, draws=pipeline_draws(key, pipe))
    assert "weights" not in plain["fine"]
    np.testing.assert_array_equal(plain["fine"]["rgb"], out["fine"]["rgb"])


def _jax_vis_grid(out, images, src_view, target):
    """The root ``train/train.py`` vis grid (its lines 232-244) on a JAX
    render."""
    H, W = images.shape[1:3]
    gt = images[target] * 0.5 + 0.5
    src_vis = images[src_view[0]] * 0.5 + 0.5

    def row(branch):
        rgb = np.clip(branch["rgb"].reshape(H, W, 3), 0, 1)
        depth_vis = jmetrics.cmap(branch["depth"].reshape(H, W)).astype(np.float32) / 255.0
        alpha = branch["weights"].reshape(H, W, -1).sum(-1)
        alpha_vis = jmetrics.cmap(alpha).astype(np.float32) / 255.0
        return np.hstack([src_vis, gt, depth_vis, rgb, alpha_vis]), rgb

    rows = [row(out["coarse"])]
    if "fine" in out:
        rows.append(row(out["fine"]))
    grid = np.vstack([r[0] for r in rows])
    return (grid * 255).astype(np.uint8), jmetrics.psnr(rows[-1][1], gt)


def test_vis_step_matches_the_jax_grid(world, tmp_path, monkeypatch):
    """``PixelNeRFTrainer.vis_step`` with ``--fixed_test`` on the train
    net (built for training, so the vis opens its eval routes), JAX's draws
    fed, against the grid of the JAX render: within one u8 level, PSNR
    within 1e-3 dB.  ``-R 5`` renders 256 rays in 80-ray chunks."""
    R = 5
    from pixelnerf_tpu.data.loader import collate as jcollate

    data = jcollate([world["jds"][0]])
    images, poses = data["images"][0], data["poses"][0]
    focal = np.asarray(data["focal"][0])
    conf = hocon.parse_string(CONF)
    _, tr = _renderers()
    trainer = cli.PixelNeRFTrainer(_port_net(world, diff_mode=True), world["ds"], world["ds"], tr,
                                   _Args(str(tmp_path), fixed_test=True, ray_batch_size=R), conf)
    trainer.global_step = 7
    key = jax.random.PRNGKey(7)
    render = RenderPipeline.render

    def fed(self, scene, rays, generator, **kw):
        assert not self.net.diff_mode and not torch.is_grad_enabled()
        return render(self, scene, rays, generator, draws=pipeline_draws(key, self),
                      **{k: v for k, v in kw.items() if k != "draws"})

    monkeypatch.setattr(RenderPipeline, "render", fed)
    grid, vis_psnr = trainer.vis_step(data)
    assert trainer.net.diff_mode  # restored

    jr, _ = _renderers()
    src_view, target = np.array([0]), 1
    jscene = world["jnet"].apply(world["variables"], jnp.asarray(images[src_view][None]),
                                 jnp.asarray(poses[src_view][None]), jnp.asarray(focal),
                                 method=JNet.encode)
    rays = jgeo.gen_rays_np(poses[target:target + 1], IMG, IMG, focal, trainer.z_near,
                            trainer.z_far).reshape(-1, 8)
    out = JRenderPipeline(world["jnet"], jr).render(
        world["variables"], jscene, rays, key, ray_batch_size=R * 16, want_weights=True)
    jgrid, jpsnr = _jax_vis_grid(out, images, src_view, target)
    assert grid.dtype == np.uint8 and grid.shape == jgrid.shape == (2 * IMG, 5 * IMG, 3)
    assert np.abs(grid.astype(int) - jgrid.astype(int)).max() <= 1
    assert abs(vis_psnr - jpsnr) <= 1e-3


class _RecordingWriter:
    """A ``tensorboardX.SummaryWriter`` stand-in: keeps (tag, step)."""

    log = []

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir

    def add_scalar(self, tag, value, step):
        assert np.isfinite(value)
        self.log.append((self.logdir, tag, int(step)))

    def add_image(self, tag, img, step):
        assert img.dtype == np.uint8 and img.shape[0] == 3
        self.log.append((self.logdir, tag, int(step)))

    def flush(self):
        pass


TINY = """
model {
    mlp_coarse { n_blocks = 2\n d_hidden = 32 }
    mlp_fine { n_blocks = 2\n d_hidden = 32 }
    encoder { num_layers = 2\n pretrained = False }
}
renderer { n_coarse = 8\n n_fine = 4\n n_fine_depth = 2\n eval_batch_size = 8192 }
train { print_interval = 1\n save_interval = 1\n vis_interval = 1\n eval_interval = 1 }
"""


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    from pixelnerf_tpu.data.synthetic import write_synthetic_dvr

    root = tmp_path_factory.mktemp("vis_cli")
    data = write_synthetic_dvr(str(root / "data"), n_objs=2, n_views=4, image_size=IMG)
    shutil.copyfile(ROOT / "conf" / "default.conf", root / "default.conf")
    conf = root / "tiny.conf"
    conf.write_text('include required("default.conf")\n' + TINY)
    return root, data, str(conf)


def _argv(root, data, conf, name):
    out = root / name
    return ["-n", name, "-c", conf, "-D", data, "-F", "dvr", "--epochs", "1", "-B", "2",
            "-R", "32", "--fixed_test", "--visual_path", str(out / "vis"),
            "--checkpoints_path", str(out / "ck"), "--logs_path", str(out / "logs")]


def test_train_cli_writes_the_vis_and_tags_of_the_root_cli(cli_env, monkeypatch):
    """One epoch each of the port's train CLI and the root ``train/train.py``
    with ``vis_interval = 1``: each writes ``0000_vis.png`` of the same
    shape, and the recording ``SummaryWriter`` sees the same (tag, step)
    pairs from both."""
    import tensorboardX

    root, data, conf = cli_env
    monkeypatch.setattr(tensorboardX, "SummaryWriter", _RecordingWriter)
    monkeypatch.setattr(_RecordingWriter, "log", [])
    monkeypatch.setattr(sys, "argv", ["train/train.py"] + _argv(root, data, conf, "jax"))
    runpy.run_path(str(ROOT / "train" / "train.py"), run_name="__main__")
    trainer = train_main(_argv(root, data, conf, "port") + ["--device", "cpu"])
    assert isinstance(trainer, cli.PixelNeRFTrainer)

    def tags(name):
        logdir = str(root / name / "logs" / name)
        return sorted((tag, step) for d, tag, step in _RecordingWriter.log if d == logdir)

    assert tags("port") == tags("jax")
    assert {tag for tag, _ in tags("port")} >= {"train/t", "train/lr", "val/loss", "vis",
                                                "vis/psnr"}
    jpng = read_png(str(root / "jax" / "vis" / "jax" / "0000_vis.png"))
    png = read_png(str(root / "port" / "vis" / "port" / "0000_vis.png"))
    assert png.shape == jpng.shape == (2 * IMG, 5 * IMG, 3) and png.dtype == np.uint8


def test_vis_interval_and_a_missing_tensorboardx(cli_env, monkeypatch, capsys):
    """Without ``tensorboardX`` the trainer prints the JAX trainer's line
    and runs; the vis is written every ``vis_interval`` epochs only."""
    root, data, conf = cli_env
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    text = open(conf).read().replace("vis_interval = 1", "vis_interval = 2")
    conf2 = root / "every2.conf"
    conf2.write_text(text)
    argv = _argv(root, data, str(conf2), "every2") + ["--device", "cpu"]
    argv[argv.index("--epochs") + 1] = "3"
    trainer = train_main(argv)
    assert trainer.writer is None
    assert "TensorBoard writer unavailable" in capsys.readouterr().out
    assert sorted(os.listdir(root / "every2" / "vis" / "every2")) == ["0001_vis.png"]


def test_a_failing_vis_propagates(world, tmp_path, monkeypatch):
    """Unlike the JAX loop, a vis that raises stops ``Trainer.start``; an
    empty test set skips the vis with a line."""
    conf = hocon.parse_string(CONF.replace("vis_interval = 1000", "vis_interval = 1"))
    _, tr = _renderers()
    args = _Args(str(tmp_path), epochs=1, fixed_test=True)
    trainer = cli.PixelNeRFTrainer(_port_net(world, diff_mode=True), world["ds"], world["ds"], tr,
                                   args, conf)
    assert trainer.vis_interval == 1

    def broken(*a, **k):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(cli, "vis_render", broken)
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        trainer.start()

    trainer = cli.PixelNeRFTrainer(_port_net(world, diff_mode=True), world["ds"], world["ds"], tr,
                                   _Args(str(tmp_path / "e"), epochs=1), conf)
    trainer.test_loader = []
    trainer.validate = lambda: float("inf")
    trainer.start()  # the broken vis_render is never reached
    assert not os.listdir(trainer.visual_path)


def test_vis_takes_each_views_intrinsics(world, tmp_path):
    """A focal and a principal point with a row per view: the source view
    is encoded with its row and the target's rays use the target's.  Rows
    equal to the shared values give the shared grid bit for bit; a changed
    target row changes the render and not the source or ground-truth
    columns; a changed source row changes the render too."""
    from pixelnerf_tpu_torch.data import collate

    data = collate([world["ds"][0]])
    NV = data["images"].shape[1]
    f = float(np.asarray(data["focal"]).reshape(-1)[0])
    conf = hocon.parse_string(CONF)
    _, tr = _renderers()
    trainer = cli.PixelNeRFTrainer(_port_net(world, diff_mode=True), world["ds"], world["ds"], tr,
                                   _Args(str(tmp_path), fixed_test=True), conf)

    def grid(focal_rows, c_rows):
        d = dict(data, focal=focal_rows[None], c=c_rows[None])
        return trainer.vis_step(d)[0].astype(int)

    base = trainer.vis_step(data)[0].astype(int)
    focal = np.full((NV, 2), f, np.float32)
    c = np.tile(np.float32([IMG * 0.5, IMG * 0.5]), (NV, 1))
    np.testing.assert_array_equal(grid(focal, c), base)
    target = focal.copy()
    target[1] *= 1.3
    moved = grid(target, c)
    np.testing.assert_array_equal(moved[:, :2 * IMG], base[:, :2 * IMG])  # src | gt
    assert np.abs(moved[:, 2 * IMG:] - base[:, 2 * IMG:]).max() > 8
    src = c.copy()
    src[0] += 2.0
    assert np.abs(grid(focal, src)[:, 3 * IMG:4 * IMG] - base[:, 3 * IMG:4 * IMG]).max() > 8
