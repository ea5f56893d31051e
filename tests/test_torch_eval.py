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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        metrics.cmap(b)


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
    base = ["-F", "synthetic", "--checkpoints_path", str(tmp_path / "ck"), "--device", "cpu",
            "-c", "conf/exp/sn64.conf", "-O", str(tmp_path / "o")]
    for extra, what in ((["--accel", "rays"], "slice 5"), (["--write_depth"], "OpenCV"),
                        (["--gpu_id", "0 1"], "slice 7")):
        with pytest.raises(NotImplementedError, match=what):
            eval_main(base + extra)
