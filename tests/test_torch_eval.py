"""The port's eval side against the JAX package, on the CPU: the metrics, the
render wire formats, the PNG writer, and ``python -m
pixelnerf_tpu_torch.eval.eval`` against the repository's ``eval/eval.py`` on
one checkpoint.

Tolerances: PSNR and SSIM of the same arrays to 1e-6 (both float64 numpy
and scipy; only the reductions may differ).  The two eval CLIs draw their
stratified samples from different generators (a torch.Generator split per
object against a JAX key split), so their per-object metrics agree to a
sampling gap, not to rounding: PSNR within 0.5 dB and SSIM within 0.02 (the
gaps measured on this conf are 1.8e-4 dB and 7.7e-5); the target views,
the rays and the ``finish.txt`` format match exactly."""

import os
import runpy
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.parallel import RenderPipeline as JRenderPipeline
from pixelnerf_tpu.parallel.pipeline import unpack_simple as junpack_simple
from pixelnerf_tpu.utils import metrics as jmetrics
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.eval.eval import main as eval_main
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.parallel.pipeline import RenderPipeline, pack_simple, unpack_simple
from pixelnerf_tpu_torch.train import checkpoints
from pixelnerf_tpu_torch.utils import metrics
from pixelnerf_tpu_torch.utils.png import encode_png, write_png

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("shape", [(20, 24, 3), (17, 13)])
def test_psnr_ssim_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.uniform(0, 1, size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    assert abs(metrics.psnr(a, b) - jmetrics.psnr(a, b)) <= 1e-6
    assert abs(metrics.ssim(a, b, data_range=1.0) - jmetrics.ssim(a, b, data_range=1.0)) <= 1e-6
    assert metrics.psnr(a, a) == float("inf") and abs(metrics.ssim(a, a) - 1.0) <= 1e-6
    u = metrics.image_float_to_uint8(b)
    np.testing.assert_array_equal(u, jmetrics.image_float_to_uint8(b))
    try:
        import cv2  # noqa: F401  (the JAX cmap is OpenCV's)
    except ImportError:
        return
    np.testing.assert_array_equal(metrics.cmap(b), jmetrics.cmap(b))


def test_wire_formats_match_jax():
    """``pack_simple`` quantizes as the JAX render function does, and
    ``unpack_simple`` of both packs is bit-equal to JAX's on the same pieces."""
    rng = np.random.default_rng(0)
    pieces = {"f32": [], "u8": []}
    for n, pad in ((50, 14), (37, 0)):  # chunks padded past their true row count
        rgb = rng.uniform(-0.1, 1.1, size=(n + pad, 3)).astype(np.float32)
        depth = rng.uniform(0.8, 1.8, size=(n + pad,)).astype(np.float32)
        ref_u8 = np.concatenate([
            np.asarray(jnp.round(jnp.clip(jnp.asarray(rgb), 0.0, 1.0) * 255.0).astype(jnp.uint8)),
            np.asarray(jnp.asarray(depth).astype(jnp.float16)).view(np.uint8).reshape(-1, 2),
        ], axis=-1)
        for pack in ("f32", "u8"):
            out = pack_simple(torch.from_numpy(rgb), torch.from_numpy(depth), pack)
            if pack == "u8":
                np.testing.assert_array_equal(out.numpy(), ref_u8)
            pieces[pack].append((out.numpy(), n))
    for pack, ps in pieces.items():
        for got, want in zip(unpack_simple(ps), junpack_simple(ps)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="pack"):
        pack_simple(torch.zeros(2, 3), torch.zeros(2), "f16")


def test_png_writer_reads_back():
    imageio = pytest.importorskip("imageio.v2")
    rgb = np.random.default_rng(1).integers(0, 256, size=(9, 14, 3), dtype=np.uint8)
    path = Path(os.environ.get("TMPDIR", "/tmp")) / f"port_png_{os.getpid()}.png"
    try:
        write_png(str(path), rgb)
        np.testing.assert_array_equal(imageio.imread(path), rgb)
    finally:
        path.unlink(missing_ok=True)
    for bad in (rgb.astype(np.float32), rgb[..., :2], rgb[0], rgb[:0]):
        with pytest.raises(ValueError, match="uint8 RGB"):
            encode_png(bad)


# ---------------------------------------------------------------------------
# the eval CLI against eval/eval.py
# ---------------------------------------------------------------------------

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
"""


def _spy(monkeypatch, cls, rays_arg, seen):
    """Record the rays of every ``render_simple`` call of ``cls``."""
    orig = cls.render_simple

    def render_simple(self, *args, **kwargs):
        seen.append(np.asarray(args[rays_arg]))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(cls, "render_simple", render_simple)


def _journal(out):
    return [ln.split() for ln in (out / "finish.txt").read_text().splitlines()]


def test_eval_cli_matches_jax_eval(tmp_path, monkeypatch):
    """``-F synthetic --split test -P 0 --max_objs 1`` and one eval view, on
    a checkpoint of the port's model (live fc_1), through both CLIs; then a
    resumed port run renders nothing."""
    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF)
    (tmp_path / "views.txt").write_text("3\n")
    net = make_model(hocon.parse_string(CONF)["model"], device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(0.1 * torch.randn(blk.fc_1.weight.shape, generator=g))
    ck = tmp_path / "ck"
    checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=str(ck), name="ev"), net)

    def argv(out):
        return ["-n", "ev", "-c", str(conf), "-F", "synthetic", "--checkpoints_path", str(ck),
                "--split", "test", "-P", "0", "--max_objs", "1", "--eval_view_list",
                str(tmp_path / "views.txt"), "-O", str(tmp_path / out)]

    jrays, rays = [], []
    _spy(monkeypatch, JRenderPipeline, 2, jrays)  # (variables, scene, rays, rng)
    _spy(monkeypatch, RenderPipeline, 1, rays)  # (scene, rays, generator)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["eval/eval.py"] + argv("jax_out"))
    runpy.run_path(str(ROOT / "eval" / "eval.py"), run_name="__main__")
    res = eval_main(argv("port_out") + ["--device", "cpu"])

    assert len(rays) == len(jrays) == 1
    np.testing.assert_array_equal(rays[0], jrays[0])
    assert rays[0].shape == (64 * 64, 8)  # one target view of the 64 px split
    for out in ("jax_out", "port_out"):  # the target views
        assert sorted(os.listdir(tmp_path / out / "0")) == ["000003.png"]
    jj, jp = _journal(tmp_path / "jax_out"), _journal(tmp_path / "port_out")
    assert len(jj) == len(jp) == 1 and len(jp[0]) == 4
    assert (jp[0][0], jp[0][3]) == (jj[0][0], jj[0][3]) == ("0", "1")
    psnr, ssim = float(jp[0][1]), float(jp[0][2])
    assert res["objects"] == [("0", psnr, ssim)] and res["cnt"] == 1
    assert abs(psnr - float(jj[0][1])) <= 0.5 and abs(ssim - float(jj[0][2])) <= 0.02

    rays.clear()
    again = eval_main(argv("port_out") + ["--device", "cpu"])
    assert not rays and again["objects"] == [] and again["cnt"] == 1
    assert _journal(tmp_path / "port_out") == jp


def test_eval_cli_on_dvr_at_half_scale_matches_jax_eval(tmp_path, monkeypatch):
    """``-F dvr --scale 0.5`` with the ground-truth compare on, on a
    fixture written by the JAX writer: the same rays (at half the focal and
    principal point), the same PNG names, and metrics against the ground
    truth resized by area (the root CLI resizes with OpenCV)."""
    from pixelnerf_tpu.data import write_synthetic_dvr

    data = write_synthetic_dvr(str(tmp_path / "dvr"), n_objs=3, n_views=3, image_size=32)
    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF)
    (tmp_path / "views.txt").write_text("2\n")
    net = make_model(hocon.parse_string(CONF)["model"], device="cpu")
    ck = tmp_path / "ck"
    checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=str(ck), name="ev"), net)

    def argv(out):
        return ["-n", "ev", "-c", str(conf), "-F", "dvr", "-D", data, "--checkpoints_path",
                str(ck), "--split", "test", "-P", "0", "--scale", "0.5", "--eval_view_list",
                str(tmp_path / "views.txt"), "-O", str(tmp_path / out)]

    jrays, rays = [], []
    _spy(monkeypatch, JRenderPipeline, 2, jrays)
    _spy(monkeypatch, RenderPipeline, 1, rays)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["eval/eval.py"] + argv("jax_out"))
    runpy.run_path(str(ROOT / "eval" / "eval.py"), run_name="__main__")
    res = eval_main(argv("port_out") + ["--device", "cpu"])

    assert len(rays) == len(jrays) == 1 and rays[0].shape == (16 * 16, 8)
    np.testing.assert_allclose(rays[0], jrays[0], rtol=1e-6, atol=1e-6)
    for out in ("jax_out", "port_out"):
        assert sorted(os.listdir(tmp_path / out / "obj0002")) == ["000002.png"]
    jj, jp = _journal(tmp_path / "jax_out"), _journal(tmp_path / "port_out")
    assert len(jj) == len(jp) == 1 and jp[0][0] == jj[0][0] == "obj0002"
    psnr, ssim = float(jp[0][1]), float(jp[0][2])
    assert np.isfinite(psnr) and np.isfinite(ssim) and res["cnt"] == 1
    assert abs(psnr - float(jj[0][1])) <= 0.5 and abs(ssim - float(jj[0][2])) <= 0.02


def test_eval_cli_on_per_view_intrinsics(tmp_path, monkeypatch):
    """``-F dvr_dtu`` on scans whose principal point moves from view to view
    (an (NV, 2) c): each target view's rays use its own c, as one-view calls
    of the JAX ray builder do, and the source views' rows reach the encoder.
    The root CLI fails on such data (ROADMAP.md section 3)."""
    from pixelnerf_tpu.data import write_synthetic_dtu
    from pixelnerf_tpu.utils import geometry as jgeometry
    from pixelnerf_tpu_torch.data import get_split_dataset

    data = write_synthetic_dtu(str(tmp_path / "dtu"), n_scenes=1, n_views=5, image_size=(12, 16),
                               offcenter_c=0.1, focal_aniso=1.2, negate_world_mat=True, seed=1)
    sample = get_split_dataset("dvr_dtu", data, want_split="val")[0]
    assert sample["c"].shape == (5, 2)
    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF)
    net = make_model(hocon.parse_string(CONF)["model"], device="cpu")
    ck = tmp_path / "ck"
    checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=str(ck), name="ev"), net)
    rays, cs = [], []
    _spy(monkeypatch, RenderPipeline, 1, rays)
    encode = type(net).encode

    def spy_encode(self, images, poses, focal, c=None, **kw):
        cs.append(c.numpy())
        return encode(self, images, poses, focal, c=c, **kw)

    monkeypatch.setattr(type(net), "encode", spy_encode)
    res = eval_main(["-n", "ev", "-c", str(conf), "-F", "dvr_dtu", "-D", data, "--device", "cpu",
                     "--checkpoints_path", str(ck), "--split", "val", "-P", "0 3", "-O",
                     str(tmp_path / "out")])
    assert res["cnt"] == 1 and np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
    np.testing.assert_array_equal(cs[0], sample["c"][[0, 3]])
    want = np.concatenate([
        np.asarray(jgeometry.gen_rays_np(sample["poses"][v:v + 1], 16, 12, sample["focal"],
                                         0.1, 5.0, c=sample["c"][v])).reshape(-1, 8)
        for v in (1, 2, 4)])
    np.testing.assert_array_equal(rays[0], want)


def test_eval_cli_refuses_what_is_not_ported(tmp_path):
    """What the eval CLI refuses, on one rank and, before it starts them,
    on several (a ``--gpu_id`` list runs one rank an id:
    ``tests/test_torch_sharded_cli.py``)."""
    base = ["-F", "synthetic", "--checkpoints_path", str(tmp_path / "ck"), "--device", "cpu",
            "-c", "conf/exp/sn64.conf", "-O", str(tmp_path / "o")]
    for ids in ("0", "0 1"):
        with pytest.raises(SystemExit, match="fine head"):
            eval_main(base + ["--gpu_id", ids, "--accel", "proposal", "--coarse"])


def _object_checkpoint(tmp_path, sigma_bias=-60.0, sigma_scale=20.0):
    """A checkpoint of the tiny model whose fine head is its coarse head and
    whose density, relu(20 raw - 60), fills ~1/10 of the object's box: a
    field the accel prunes and the gate passes at its first rung."""
    net = make_model(hocon.parse_string(CONF)["model"], device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(0.1 * torch.randn(blk.fc_1.weight.shape, generator=g))
        net.mlp_fine.load_state_dict(net.mlp_coarse.state_dict())
        for mlp in (net.mlp_coarse, net.mlp_fine):
            mlp.lin_out.weight[3] *= sigma_scale
            mlp.lin_out.bias[3] = sigma_bias
    ck = tmp_path / "ck"
    checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=str(ck), name="ev"), net)
    return ck


def _jax_probes(monkeypatch):
    """The JAX build's probe directions and capacity-probe jitter, and the
    JAX gate's draws (its key from the gate's seed), in the port."""
    import jax

    from pixelnerf_tpu_torch.render import accel as taccel
    from test_torch_accel import jax_jitter, pipeline_draws

    def jdirs(n, generator=None):
        d = jax.random.normal(jax.random.PRNGKey(0), (max(n, 1), 3))
        return torch.from_numpy(np.array(d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)))

    monkeypatch.setattr(taccel, "probe_dirs", jdirs)
    build, gate = RenderPipeline.build_accel, RenderPipeline.gate_accel_mode

    def jbuild(self, *a, **k):
        return build(self, *a, jitter=jax_jitter, **k)

    monkeypatch.setattr(RenderPipeline, "build_accel", jbuild)

    def jgate(self, scene, rays, seed, *a, **k):
        return gate(self, scene, rays, seed, *a,
                    draws=pipeline_draws(jax.random.PRNGKey(seed), self), **k)

    monkeypatch.setattr(RenderPipeline, "gate_accel_mode", jgate)


def test_eval_cli_accel_proposal_matches_jax_eval(tmp_path, monkeypatch, capsys):
    """``--accel proposal`` (the fast build: 64^3 voxels, one probe
    direction) with the gate on the first target view, on the CPU under
    ``PIXELNERF_ACCEL_CPU_OK=1``, through both CLIs on one checkpoint: the
    same grid line and gate trail (JAX's probe directions, jitter and gate
    draws in the port), metrics within the bar of the dense test; without
    the variable the port evaluates dense, with the root's warning."""
    from pixelnerf_tpu.data import write_synthetic_dvr

    data = write_synthetic_dvr(str(tmp_path / "dvr"), n_objs=3, n_views=3, image_size=32)
    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF)
    (tmp_path / "views.txt").write_text("2\n")
    ck = _object_checkpoint(tmp_path)

    def argv(out):
        return ["-n", "ev", "-c", str(conf), "-F", "dvr", "-D", data, "--checkpoints_path",
                str(ck), "--split", "test", "-P", "0", "--scale", "0.5", "--eval_view_list",
                str(tmp_path / "views.txt"), "-O", str(tmp_path / out), "--accel", "proposal"]

    _jax_probes(monkeypatch)
    monkeypatch.setenv("PIXELNERF_ACCEL_CPU_OK", "1")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["eval/eval.py"] + argv("jax_out"))
    runpy.run_path(str(ROOT / "eval" / "eval.py"), run_name="__main__")
    jlog = capsys.readouterr()
    res = eval_main(argv("port_out") + ["--device", "cpu"])
    log = capsys.readouterr()

    def grid_lines(text):
        return [ln for ln in text.splitlines() if ln.startswith("accel: occupancy")]

    assert grid_lines(log.err) == grid_lines(jlog.err) and len(grid_lines(log.err)) == 1
    jtrail = [ln.strip() for ln in jlog.out.splitlines() if "accel gate:" in ln]
    trail = [ln.strip() for ln in log.out.splitlines() if "accel gate:" in ln]
    assert trail == jtrail and len(trail) == 1, (trail, jtrail)
    (name, label, psnrs), = res["gates"]
    assert label == "proposal" and psnrs["proposal"] >= 30.0
    jj, jp = _journal(tmp_path / "jax_out"), _journal(tmp_path / "port_out")
    assert jp[0][0] == jj[0][0] == name == "obj0002"
    assert abs(float(jp[0][1]) - float(jj[0][1])) <= 0.5
    assert abs(float(jp[0][2]) - float(jj[0][2])) <= 0.02

    monkeypatch.delenv("PIXELNERF_ACCEL_CPU_OK")
    dense = eval_main(argv("dense_out") + ["--device", "cpu"])
    assert "WARNING: --accel proposal ignored on the CPU" in capsys.readouterr().out
    assert dense["gates"] == [] and dense["cnt"] == 1


# ---------------------------------------------------------------------------
# the gen_video CLI against eval/gen_video.py
# ---------------------------------------------------------------------------


def test_dtu_spline_poses_match_jax():
    from pixelnerf_tpu_torch.eval.gen_video import dtu_spline_poses

    root = runpy.run_path(str(ROOT / "eval" / "gen_video.py"), run_name="gen_video")
    for n in (3, 5, 40):
        got, want = dtu_spline_poses(n), root["dtu_spline_poses"](n)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fmt", ["dvr", "dvr_dtu"])
def test_gen_video_cli_matches_jax_gen_video(tmp_path, monkeypatch, fmt):
    """``python -m pixelnerf_tpu_torch.eval.gen_video`` on the CPU (dense,
    as the root CLI renders there) against ``eval/gen_video.py`` on one
    checkpoint: the ring (``-F dvr``) or DTU spline (``-F dvr_dtu``) rays
    equal to 1e-5, the frames within one u8 level with JAX's draws fed, one
    PNG per frame and the source view beside the root's output names."""
    import jax

    from pixelnerf_tpu.data import write_synthetic_dtu, write_synthetic_dvr
    from pixelnerf_tpu_torch.eval.gen_video import main as gen_video_main
    from test_torch_accel import pipeline_draws

    if fmt == "dvr":
        data = write_synthetic_dvr(str(tmp_path / "d"), n_objs=3, n_views=3, image_size=16)
        split, frames_arg, n_frames, hw = "test", "3", 3, (16, 16)
    else:
        data = write_synthetic_dtu(str(tmp_path / "d"), n_scenes=1, n_views=5,
                                   image_size=(12, 16), seed=1)
        split, frames_arg, n_frames, hw = "val", "5", 6, (12, 16)
    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF)
    net = make_model(hocon.parse_string(CONF)["model"], device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(0.1 * torch.randn(blk.fc_1.weight.shape, generator=g))
    ck = tmp_path / "ck"
    checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=str(ck), name="gv"), net)

    def argv(vis):
        return ["-n", "gv", "-c", str(conf), "-F", fmt, "-D", data, "--checkpoints_path",
                str(ck), "--split", split, "-S", "0", "-P", "0", "--num_views", frames_arg,
                "--visual_path", str(tmp_path / vis), "-R", "512"]

    jout, out = [], []
    jrender = JRenderPipeline.render_simple
    render = RenderPipeline.render_simple

    def jspy(self, variables, scene, rays, rng, **kw):
        res = jrender(self, variables, scene, rays, rng, **kw)
        jout.append((np.asarray(rays), res[0]))
        return res

    def spy(self, scene, rays, generator, **kw):  # the root renders with PRNGKey(1)
        res = render(self, scene, rays, generator,
                     draws=pipeline_draws(jax.random.PRNGKey(1), self), **kw)
        out.append((np.asarray(rays), res[0]))
        return res

    monkeypatch.setattr(JRenderPipeline, "render_simple", jspy)
    monkeypatch.setattr(RenderPipeline, "render_simple", spy)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["eval/gen_video.py"] + argv("jax_vis"))
    runpy.run_path(str(ROOT / "eval" / "gen_video.py"), run_name="__main__")
    res = gen_video_main(argv("port_vis") + ["--device", "cpu"])

    assert len(out) == len(jout) == 1
    np.testing.assert_allclose(out[0][0], jout[0][0], rtol=0, atol=1e-5)
    assert res["frames"].shape == (n_frames,) + hw + (3,) and res["accel"] is None
    want = (np.clip(jout[0][1].reshape(-1, *hw, 3), 0, 1) * 255).astype(np.uint8)
    assert np.abs(res["frames"].astype(int) - want.astype(int)).max() <= 1
    name = "video" + ("t" if split == "test" else "v") + "0000_v000"
    jfiles = sorted(os.listdir(tmp_path / "jax_vis" / "gv"))
    files = sorted(os.listdir(tmp_path / "port_vis" / "gv"))
    assert name + "_view.jpg" in jfiles and name + "_view.png" in files
    assert sorted(os.listdir(res["frame_dir"])) == [f"{i:04}.png" for i in range(n_frames)]
    assert res["video"] is not None and os.path.basename(res["video"]) in jfiles
