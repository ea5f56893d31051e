"""The port's train step, checkpoints and train CLI against the JAX package,
on the CPU.

Whole-step parity follows ``tests/test_train_pipeline.py``'s fused-MLP test:
the same weights, the same collated batch and host generator, and the JAX
trainer's render draws rebuilt from its key and injected into the port
(``RayDraws``).  The JAX ``Trainer`` runs the XLA field without AMP; the
port runs the plain field (``impl="torch"``) and the kernel route
(``impl="cuda"``, the kernels' plain versions on CPU tensors).  Bars: loss
rtol 2e-3, grad norm rtol 5e-3, and fewer than 1e-3 of the parameters
drifted by more than a quarter of 3 x lr after 3 steps.

For tables up to 16384 rows the JAX ``gather_taps`` backward is a one-hot
matmul of bf16-rounded operands even without AMP; the port sums the table
gradient in f32.  Adam's first update is about lr * sign(g), so the encoder's
small gradients of opposite rounding then part the two runs (a 0.75% grad
norm gap at step 1).  The parity test therefore has the JAX step take its
f32 scatter-add backward, the path it uses for larger tables."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.data import SyntheticDataset as JSyntheticDataset
from pixelnerf_tpu.data import get_split_dataset as jget_split_dataset
from pixelnerf_tpu.data import synthetic as jsynthetic
from pixelnerf_tpu.data.loader import collate as jcollate
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.render import NeRFRenderer as JNeRFRenderer
from pixelnerf_tpu.train import checkpoints as jcheckpoints
from pixelnerf_tpu.train.trainer import CheckpointManager as JCheckpointManager
from pixelnerf_tpu.train.trainer import Trainer as JTrainer
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import SyntheticDataset, collate, get_split_dataset
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.render import NeRFRenderer, RayDraws
from pixelnerf_tpu_torch.train import CheckpointManager, Trainer, checkpoints
from pixelnerf_tpu_torch.train import main as train_main
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

ROOT = Path(__file__).resolve().parent.parent
# the ops package re-exports a function under the module's name
jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")
CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 4\n freq_factor = 1.5\n include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet\n n_blocks = 3\n d_hidden = 48\n combine_layer = 2 }
    mlp_fine { type = resnet\n n_blocks = 3\n d_hidden = 48\n combine_layer = 2 }
    encoder { backbone = resnet18\n pretrained = False\n num_layers = 2\n use_first_pool = False }
}
renderer {
    n_coarse = 8\n n_fine = 6\n n_fine_depth = 3\n white_bkgd = True\n sched = []
}
loss {
    rgb { use_l1 = False }
    rgb_fine { use_l1 = False }
    lambda_coarse = 1.0\n lambda_fine = 1.0
}
train {
    print_interval = 100\n save_interval = 1000\n vis_interval = 1000
    eval_interval = 1000\n num_epoch_repeats = 1
}
"""


class _Args:
    def __init__(self, tmp, **kw):
        self.name = "t"
        self.checkpoints_path = os.path.join(tmp, "ck")
        self.visual_path = os.path.join(tmp, "vis")
        self.logs_path = os.path.join(tmp, "logs")
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
        self.__dict__.update(kw)


@pytest.fixture(scope="module")
def setup():
    """JAX variables (live fc_1), the dataset pair and one collated batch."""
    jds = JSyntheticDataset(n_objs=3, n_views=4, image_size=24)
    sample = jds[0]
    jnet = jmake_model(jhocon.parse_string(CONF)["model"])
    variables = jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(sample["images"][None, :1]),
        jnp.asarray(sample["poses"][None, :1]), jnp.asarray(np.float32(sample["focal"])),
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
    return dict(jds=jds, variables=variables, data=jcollate([jds[0], jds[1]]))


def _jax_trainer(setup, tmp):
    conf = jhocon.parse_string(CONF)
    net = jmake_model(conf["model"], mlp_impl="xla")
    return JTrainer(net, setup["variables"], setup["jds"], setup["jds"],
                    JNeRFRenderer.from_conf(conf["renderer"]), _Args(str(tmp)), conf)


def _port_trainer(setup, tmp, impl, ds=None, **kw):
    conf = hocon.parse_string(CONF)
    net = make_model(conf["model"], mlp_impl=impl, device="cpu", diff_mode=True)
    net.load_state_dict(from_jax_variables(setup["variables"]))
    if ds is None:
        ds = SyntheticDataset(n_objs=3, n_views=4, image_size=24)
    return Trainer(net, ds, ds, NeRFRenderer.from_conf(conf["renderer"]), _Args(str(tmp), **kw),
                   conf)


def _jax_draws(key, n_rays, cfg):
    """The random numbers the JAX trainer's next step draws: its key split,
    then ``compute_loss``'s and ``render_rays``' splits."""
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


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_train_steps_match_jax_trainer(setup, tmp_path, monkeypatch, impl):
    monkeypatch.setattr(jgs, "_ONEHOT_BWD_MAX_ROWS", 0)  # read when the JAX step is traced
    tr_j = _jax_trainer(setup, tmp_path / "j")
    tr_p = _port_trainer(setup, tmp_path / "p", impl)
    assert tr_p.remat == (impl == "torch")  # the kernel route saves only its inputs
    tr_j.rng, tr_p.rng = np.random.default_rng(7), np.random.default_rng(7)
    tr_j.jrng = jax.random.PRNGKey(3)
    n_rays = 2 * tr_p.args.ray_batch_size
    for step in range(3):
        draws = _jax_draws(tr_j.jrng, n_rays, tr_j.renderer.cfg)
        ld_j = tr_j.train_step(setup["data"])
        ld_p = tr_p.train_step(setup["data"], draws=draws)
        assert np.isfinite(ld_p["t"]), ld_p
        np.testing.assert_allclose(ld_p["t"], ld_j["t"], rtol=2e-3, err_msg=f"step {step}")
        np.testing.assert_allclose(ld_p["grad_norm"], ld_j["grad_norm"], rtol=5e-3,
                                   err_msg=f"step {step}")
    ref = from_jax_variables({"params": jax.tree.map(np.asarray, tr_j.state.params)})
    got = dict(tr_p.net.named_parameters())
    assert sorted(ref) == sorted(got)
    budget = 3 * tr_p.args.lr
    drifted = total = 0
    for k, v in ref.items():
        d = (got[k].detach() - v).abs()
        drifted += int((d > 0.25 * budget).sum())
        total += d.numel()
    assert drifted / total < 1e-3, (drifted, total)
    # the encoder's running statistics moved as flax's did
    stats = from_jax_variables({"batch_stats": jax.tree.map(np.asarray, tr_j.state.batch_stats)})
    state = tr_p.net.state_dict()
    for k, v in stats.items():
        if "running" in k:
            torch.testing.assert_close(state[k], v, rtol=1e-4, atol=1e-4, msg=k)


@pytest.mark.parametrize("fmt,nviews", [("dvr", "1"), ("dvr_dtu", "3")])
def test_file_format_steps_match_jax_trainer(setup, tmp_path, monkeypatch, fmt, nviews):
    """Three kernel-route steps on data read from disk, each trainer through
    its own package's adapter: ``-F dvr`` (NDC cameras, a scalar focal) at
    -V 1, and ``-F dvr_dtu`` at -V 3 on non-square 15 x 20 scans with an
    anisotropic focal, negated world_mats and a rotated scale_mat.  The
    bars of the synthetic steps: loss rtol 2e-3, grad norm rtol 5e-3."""
    monkeypatch.setattr(jgs, "_ONEHOT_BWD_MAX_ROWS", 0)  # read when the JAX step is traced
    root = str(tmp_path / "data")
    if fmt == "dvr":
        jsynthetic.write_synthetic_dvr(root, n_objs=4, n_views=4, image_size=24)
    else:
        jsynthetic.write_synthetic_dtu(root, n_scenes=2, n_views=4, image_size=(15, 20),
                                       focal_aniso=1.2, negate_world_mat=True,
                                       scale_rot_deg=33.0)
    jds = jget_split_dataset(fmt, root, want_split="train")
    pds = get_split_dataset(fmt, root, want_split="train")
    assert len(jds) == len(pds) == 2
    conf = jhocon.parse_string(CONF)
    tr_j = JTrainer(jmake_model(conf["model"], mlp_impl="xla"), setup["variables"], jds, jds,
                    JNeRFRenderer.from_conf(conf["renderer"]),
                    _Args(str(tmp_path / "j"), nviews=nviews), conf)
    tr_p = _port_trainer(setup, tmp_path / "p", "cuda", ds=pds, nviews=nviews)
    assert (tr_p.z_near, tr_p.z_far) == (tr_j.z_near, tr_j.z_far) and not tr_p.remat
    jdata, pdata = jcollate([jds[0], jds[1]]), collate([pds[0], pds[1]])
    assert pdata["images"].shape[2:4] == ((24, 24) if fmt == "dvr" else (15, 20))
    tr_j.rng, tr_p.rng = np.random.default_rng(7), np.random.default_rng(7)
    tr_j.jrng = jax.random.PRNGKey(3)
    n_rays = 2 * tr_p.args.ray_batch_size
    for step in range(3):
        draws = _jax_draws(tr_j.jrng, n_rays, tr_j.renderer.cfg)
        ld_j = tr_j.train_step(jdata)
        ld_p = tr_p.train_step(pdata, draws=draws)
        assert np.isfinite(ld_p["t"]), ld_p
        np.testing.assert_allclose(ld_p["t"], ld_j["t"], rtol=2e-3, err_msg=f"step {step}")
        np.testing.assert_allclose(ld_p["grad_norm"], ld_j["grad_norm"], rtol=5e-3,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("strategy,kw", [("keep_last", {"keep_last": 2}),
                                         ("milestone", {"milestone_interval": 3}),
                                         ("keep_all", {})])
def test_checkpoint_retention_matches_jax(tmp_path, strategy, kw):
    port = CheckpointManager(str(tmp_path / "p"), strategy=strategy, **kw)
    ref = JCheckpointManager(str(tmp_path / "j"), strategy=strategy, **kw)
    for epoch in range(8):
        port.save({"x": torch.tensor(float(epoch)), "epoch": epoch}, epoch, is_best=epoch == 5)
        ref.save({"x": np.float32(epoch), "epoch": epoch}, epoch, is_best=epoch == 5)
        assert port.epochs_on_disk() == ref.epochs_on_disk()
    latest = port.load_latest()
    assert latest["epoch"] == 8 and float(latest["x"]) == 7.0
    best = torch.load(tmp_path / "p" / "best.ckpt", weights_only=True)
    assert best["epoch"] == 5


def test_resume_takes_the_same_next_step(setup, tmp_path):
    """Save after two steps; a new Trainer with --resume loads the weights,
    the optimizer, the counters and the renderer, and its next step equals
    the first trainer's, bit for bit."""
    tr_a = _port_trainer(setup, tmp_path, "torch")
    for _ in range(2):
        tr_a.train_step(setup["data"])
    tr_a.save_checkpoint()
    tr_b = _port_trainer(setup, tmp_path, "torch", resume=True)
    assert (tr_b.epoch, tr_b.global_step, tr_b.optimizer.count) == (1, 2, 2)
    for k, v in tr_a.net.state_dict().items():
        torch.testing.assert_close(tr_b.net.state_dict()[k], v, rtol=0, atol=0, msg=k)
    cfg = tr_a.renderer.cfg
    draws = _jax_draws(jax.random.PRNGKey(1), 2 * tr_a.args.ray_batch_size, cfg)
    outs = []
    for tr in (tr_a, tr_b):
        tr.rng = np.random.default_rng(5)
        outs.append(tr.train_step(setup["data"], draws=draws))
    assert outs[0] == outs[1]
    for (k, a), b in zip(tr_a.net.named_parameters(), tr_b.net.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


def test_pixel_nerf_latest_loads_in_jax(setup, tmp_path):
    """The port's ``pixel_nerf_latest`` is a reference-naming torch state
    dict: the JAX ``load_model`` reads it unchanged, to the same variables;
    the previous file is kept as ``_backup``."""
    net = _port_trainer(setup, tmp_path, "torch").net
    args = _Args(str(tmp_path))
    checkpoints.save_weights(args, net)
    checkpoints.save_weights(args, net)
    path = checkpoints.checkpoint_path(args)
    assert os.path.exists(path + "_backup")
    loaded = jcheckpoints.load_model(path, target_variables=setup["variables"])
    back = from_jax_variables(jax.tree.map(np.asarray, loaded))
    state = net.state_dict()
    assert sorted(back) == sorted(state)
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(state[k], v, rtol=0, atol=0, msg=k)
    fresh = make_model(hocon.parse_string(CONF)["model"], device="cpu")
    checkpoints.load_model(path, fresh)
    for k, v in state.items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_train_cli_on_cpu(tmp_path):
    """``python -m pixelnerf_tpu_torch.train --device cpu`` on a tiny conf for
    one epoch writes its checkpoints; without ``--device`` it asks for the
    card; two ``--gpu_id``s train on two ranks, rank 0 writing the
    checkpoints (their parity: ``tests/test_torch_sharded_cli.py``)."""
    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    cmd = [sys.executable, "-m", "pixelnerf_tpu_torch.train", "--device", "cpu", "-F", "synthetic",
           "-c", str(conf), "-n", "cli", "--checkpoints_path", str(tmp_path / "ck"),
           "--epochs", "1", "-B", "2", "-R", "8"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    for name in ("pixel_nerf_latest", "latest.ckpt", "epoch_0000.ckpt"):
        assert (tmp_path / "ck" / "cli" / name).exists(), name
    base = ["-F", "synthetic", "-c", str(conf), "--checkpoints_path", str(tmp_path / "ck2")]
    assert train_main(base + ["--gpu_id", "0 1", "--device", "cpu", "-n", "two", "--epochs", "1",
                              "-B", "2", "-R", "8", "--visual_path", str(tmp_path / "vis"),
                              "--logs_path", str(tmp_path / "logs")]) is None
    for name in ("pixel_nerf_latest", "latest.ckpt", "epoch_0000.ckpt"):
        assert (tmp_path / "ck2" / "two" / name).exists(), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(base)


def test_train_cli_profile_dir(tmp_path):
    """``--profile_dir D`` on the CPU, on ``-F dvr`` data written by the
    port's writer: ``D/trace.json`` parses and holds the spans of train steps
    3-5, each step's split covers its wall time, and no other step span."""
    from pixelnerf_tpu_torch.data import write_synthetic_dvr
    from pixelnerf_tpu_torch.train.profile import load_events, split_trace, step_spans

    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF)
    data = write_synthetic_dvr(str(tmp_path / "dvr"), n_objs=4, n_views=3, image_size=16)
    prof = tmp_path / "prof"
    trainer = train_main(["--device", "cpu", "-F", "dvr", "-D", data, "-c", str(conf), "-n", "p",
                          "--checkpoints_path", str(tmp_path / "ck"), "--epochs", "3", "-B", "1",
                          "-R", "8", "--profile_dir", str(prof), "--visual_path",
                          str(tmp_path / "vis"), "--logs_path", str(tmp_path / "logs")])
    assert trainer.global_step == 6
    path = prof / "trace.json"
    assert path.exists()
    spans = step_spans(load_events(str(path)))
    assert sorted(spans) == [3, 4, 5]
    split = split_trace(str(path))
    for n, st in split["steps"].items():
        assert st["wall_ms"] > 0 and st["field_ms"] == st["other_ms"] == 0.0  # no card here
        assert st["idle_ms"] == pytest.approx(st["wall_ms"])
        phases = st["phases"]
        assert sorted(phases) == ["backward", "forward", "optimizer", "rest"]
        assert min(phases[k]["wall_ms"] for k in ("forward", "backward", "optimizer")) > 0
        assert sum(p["wall_ms"] for p in phases.values()) == pytest.approx(st["wall_ms"])
