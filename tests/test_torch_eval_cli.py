"""The port's remaining eval pieces against the JAX package and the root CLIs,
on the CPU: ``metrics.cmap`` (OpenCV's HOT), ``resize_bilinear_pil``
(Pillow's bilinear), the Blender frame transforms, ``eval --write_depth``,
``python -m pixelnerf_tpu_torch.eval.eval_approx``, ``.eval_real`` and
``.calc_metrics`` against ``eval/eval_approx.py``, ``eval/eval_real.py``,
``eval/eval.py`` and ``eval/calc_metrics.py`` run in-process.

Tolerances, each stated where it is held:
- ``cmap`` equal to OpenCV's at all 256 levels (the same table);
- ``resize_bilinear_pil`` within one u8 level of Pillow (Pillow resizes in
  fixed point; the port's emulation of it is measured bit for bit);
- the CLIs fed JAX's draws (``test_torch_accel.pipeline_draws``): the same
  rays (within 1e-5), the same views, frames within one u8 level, depth
  within 1e-5, PSNR within 1e-3 dB and SSIM within 1e-4;
- ``calc_metrics``: PSNR / SSIM within 1e-6 (the same float64 numpy and
  scipy reductions of the same images), LPIPS within 1e-5 relative (the
  port's VGG against JAX's); ``all_metrics.txt`` byte for byte.
"""

import os
import re
import runpy
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from pixelnerf_tpu.parallel import RenderPipeline as JRenderPipeline
from pixelnerf_tpu.utils import geometry as jgeometry
from pixelnerf_tpu.utils import metrics as jmetrics
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data.resize import resize_bilinear_pil
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.models.pixelnerf import PixelNeRFNet
from pixelnerf_tpu_torch.parallel.pipeline import RenderPipeline
from pixelnerf_tpu_torch.train import checkpoints
from pixelnerf_tpu_torch.utils import geometry, metrics
from test_torch_eval import CONF

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# the numpy pieces: colormap, Pillow's resize, the Blender frame
# ---------------------------------------------------------------------------


def test_cmap_matches_opencv():
    """The HOT table equals ``cv2.applyColorMap`` at every level, and ``cmap``
    of a float image equals the JAX ``cmap`` (OpenCV) exactly."""
    cv2 = pytest.importorskip("cv2")
    levels = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(metrics.HOT,
                                  cv2.applyColorMap(levels, cv2.COLORMAP_HOT)[:, 0, ::-1])
    rng = np.random.default_rng(0)
    for shape in ((23, 17), (23, 17, 1), (23, 17, 3)):  # RGB goes through OpenCV's gray
        img = rng.normal(1.3, 0.4, shape).astype(np.float32)
        got = metrics.cmap(img)
        assert got.shape == (23, 17, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jmetrics.cmap(img))


@pytest.mark.parametrize("shape,size", [
    ((30, 40), (12, 16)),    # shrink
    ((31, 47), (17, 13)),    # shrink, odd sizes
    ((16, 16), (37, 29)),    # enlarge, odd sizes
    ((7, 5), (20, 3)),       # enlarge one axis, shrink the other
    ((300, 400), (75, 100)),  # DTU at --scale 0.25
])
def test_resize_bilinear_pil_matches_pillow(shape, size):
    """Within one u8 level of ``PIL.Image.resize(..., BILINEAR)`` (the
    fixed-point emulation is bit for bit on these sizes)."""
    from PIL import Image

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((size[1], size[0]), Image.BILINEAR))
    got = resize_bilinear_pil(img, size)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(resize_bilinear_pil(img, shape), img)
    with pytest.raises(ValueError, match="uint8"):
        resize_bilinear_pil(img.astype(np.float32), size)


def test_blender_transforms_match_jax():
    for name in ("coord_from_blender", "coord_to_blender"):
        for dtype in (np.float32, np.float64):
            got, want = getattr(geometry, name)(dtype), getattr(jgeometry, name)(dtype)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(geometry.coord_from_blender() @ geometry.coord_to_blender(),
                                  np.eye(4, dtype=np.float32))


# ---------------------------------------------------------------------------
# the CLIs against the root CLIs on one checkpoint, JAX's draws fed
# ---------------------------------------------------------------------------


def _checkpoint(tmp_path, name="ev"):
    """The tiny conf in a file and a checkpoint of its model (live fc_1)."""
    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF)
    net = make_model(hocon.parse_string(CONF)["model"], device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(0.1 * torch.randn(blk.fc_1.weight.shape, generator=g))
    ck = tmp_path / "ck"
    checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=str(ck), name=name), net)
    return conf, ck


def _fed_renders(monkeypatch):
    """Spy both pipelines' ``render_simple``: JAX's calls are recorded as
    (rays, key, rgb, depth); the port's k-th call renders with the draws of
    JAX's k-th key and is recorded as (rays, rgb, depth).  Run the root CLI
    first."""
    from test_torch_accel import pipeline_draws

    jcalls, calls = [], []
    jrender, render = JRenderPipeline.render_simple, RenderPipeline.render_simple

    def jspy(self, variables, scene, rays, rng, **kw):
        res = jrender(self, variables, scene, rays, rng, **kw)
        jcalls.append((np.asarray(rays), rng, np.asarray(res[0]), np.asarray(res[1])))
        return res

    def spy(self, scene, rays, generator, **kw):
        key = jcalls[len(calls)][1]
        res = render(self, scene, rays, generator, draws=pipeline_draws(key, self), **kw)
        calls.append((np.asarray(rays), res[0], res[1]))
        return res

    monkeypatch.setattr(JRenderPipeline, "render_simple", jspy)
    monkeypatch.setattr(RenderPipeline, "render_simple", spy)
    return jcalls, calls


def _run_root(monkeypatch, script, argv):
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(str(ROOT / script), run_name="__main__")


@pytest.mark.parametrize("source", ["0", "-1"])
def test_eval_approx_matches_jax(tmp_path, monkeypatch, capsys, source):
    """``-F dvr --split train --batch_size 3`` over 4 objects (a batch of 3
    and one of 1), from view 0 and from one random view an object: the same
    source images reach the encoder, the same target rays are rendered, and
    with JAX's draws the metrics agree."""
    from pixelnerf_tpu.data import write_synthetic_dvr
    import pixelnerf_tpu.models as jmodels
    from pixelnerf_tpu_torch.eval.eval_approx import main as approx_main

    data = write_synthetic_dvr(str(tmp_path / "dvr"), n_objs=6, n_views=4, image_size=16)
    conf, ck = _checkpoint(tmp_path)

    def args(views):
        return ["-n", "ev", "-c", str(conf), "-F", "dvr", "-D", data, "--checkpoints_path",
                str(ck), "--split", "train", "-P", views, "--batch_size", "3", "-R", "100"]

    argv = args(source)
    jsrc, src = [], []
    make_encode_fn = jmodels.make_encode_fn

    def jmake_encode_fn(net):
        fn = make_encode_fn(net)
        return lambda variables, images, *a, **k: (jsrc.append(np.asarray(images)),
                                                   fn(variables, images, *a, **k))[1]

    monkeypatch.setattr(jmodels, "make_encode_fn", jmake_encode_fn)
    encode = PixelNeRFNet.encode

    def spy_encode(self, images, *a, **k):
        src.append(images.numpy())
        return encode(self, images, *a, **k)

    jcalls, calls = _fed_renders(monkeypatch)
    monkeypatch.chdir(tmp_path)
    _run_root(monkeypatch, "eval/eval_approx.py", argv)
    jout = capsys.readouterr().out
    monkeypatch.setattr(PixelNeRFNet, "encode", spy_encode)
    res = approx_main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out

    assert len(calls) == len(jcalls) == len(src) == len(jsrc) == res["cnt"] == 4
    for a, b in zip(src, jsrc):
        np.testing.assert_array_equal(a, b)
    for (rays, rgb, _), (jrays, _, jrgb, _) in zip(calls, jcalls):
        assert rays.shape == (16 * 16, 8)
        np.testing.assert_allclose(rays, jrays, rtol=0, atol=1e-5)
        assert np.abs(rgb - jrgb).max() <= 1 / 255
    assert all(o[1] != [o[2]] for o in res["objects"])  # a target view is not a source view

    def lines(text, tag):
        return [[float(v) for v in re.findall(r"[-\d.e]+(?=\s|$)", ln)]
                for ln in text.splitlines() if ln.startswith(tag)]

    for tag in ("curr psnr", "final psnr"):
        got, want = lines(out, tag), lines(jout, tag)
        assert len(got) == len(want) == (2 if tag == "curr psnr" else 1)
        for (p, s), (jp, js) in zip(got, want):
            assert abs(p - jp) <= 1e-3 and abs(s - js) <= 1e-4
    assert (res["psnr"], res["ssim"]) == tuple(lines(out, "final psnr")[0])

    with pytest.raises(SystemExit, match="out of range"):
        approx_main(args("0 4") + ["--device", "cpu"])


def test_eval_real_matches_jax(tmp_path, monkeypatch, capsys):
    """A 40 x 30 RGBA ``x_normalize.png`` at ``--size 16 --out_size 16
    --num_views 2 --accel_mode off --no_vid``: the encoder's input within one
    u8 level of Pillow's ``convert("RGB").resize``, the rays within 1e-5, the
    frames within one u8 level with JAX's draws; then the missing-input
    exits."""
    import imageio.v2 as imageio
    from PIL import Image

    import pixelnerf_tpu.models as jmodels
    from pixelnerf_tpu_torch.eval.eval_real import main as real_main

    conf, ck = _checkpoint(tmp_path)
    inp = tmp_path / "in"
    inp.mkdir()
    rgba = np.random.default_rng(0).integers(0, 256, (30, 40, 4), dtype=np.uint8)
    imageio.imwrite(inp / "x_normalize.png", rgba)
    (inp / "notes.txt").write_text("not an input")

    def argv(out):
        return ["-n", "ev", "-c", str(conf), "--checkpoints_path", str(ck), "-I", str(inp),
                "-O", str(tmp_path / out), "--size", "16", "--out_size", "16", "--num_views",
                "2", "--accel_mode", "off", "--no_vid"]

    jsrc = []
    make_encode_fn = jmodels.make_encode_fn

    def jmake_encode_fn(net):
        fn = make_encode_fn(net)
        return lambda variables, images, *a, **k: (jsrc.append(np.asarray(images)),
                                                   fn(variables, images, *a, **k))[1]

    monkeypatch.setattr(jmodels, "make_encode_fn", jmake_encode_fn)
    jcalls, calls = _fed_renders(monkeypatch)
    monkeypatch.chdir(tmp_path)
    _run_root(monkeypatch, "eval/eval_real.py", argv("jax_out"))
    res = real_main(argv("port_out") + ["--device", "cpu"])

    (r,) = res["inputs"]
    pil = np.asarray(Image.open(inp / "x_normalize.png").convert("RGB").resize((21, 16),
                                                                                 Image.BILINEAR))
    assert r["encoder_input"].shape == pil.shape == (16, 21, 3)
    assert np.abs(r["encoder_input"].astype(int) - pil.astype(int)).max() <= 1
    jin = np.rint((jsrc[0][0, 0] + 1.0) / 2.0 * 255.0).astype(int)  # the root's [-1, 1] input
    assert np.abs(r["encoder_input"].astype(int) - jin).max() <= 1
    assert len(calls) == len(jcalls) == 1
    np.testing.assert_allclose(calls[0][0], jcalls[0][0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["rays"], jcalls[0][0], rtol=0, atol=1e-5)
    frames = sorted(os.listdir(tmp_path / "port_out" / "x_normalize_frames"))
    assert frames == sorted(os.listdir(tmp_path / "jax_out" / "x_normalize_frames"))
    assert frames == ["0000.png", "0001.png"] and r["video"] is None and r["accel"] is None
    for i, name in enumerate(frames):
        want = imageio.imread(tmp_path / "jax_out" / "x_normalize_frames" / name)
        assert np.abs(r["frames"][i].astype(int) - want.astype(int)).max() <= 1
        np.testing.assert_array_equal(
            imageio.imread(tmp_path / "port_out" / "x_normalize_frames" / name), r["frames"][i])

    capsys.readouterr()
    for inputs, message in ((tmp_path / "empty", "No input images found"),
                            (inp.parent / "notes", "No processed input images found")):
        inputs.mkdir()
        if inputs.name == "notes":
            (inputs / "x.png").write_bytes(b"")
        a = argv("o")
        a[a.index("-I") + 1] = str(inputs)
        with pytest.raises(SystemExit) as e:
            real_main(a + ["--device", "cpu"])
        assert e.value.code == 1 and message in capsys.readouterr().out


def test_eval_write_depth_matches_jax(tmp_path, monkeypatch):
    """``eval --write_depth`` on one object of a ``-F dvr`` fixture: each
    target view's ``_depth.npy`` within 1e-5 of the root CLI's (which writes
    ``.npy`` when its OpenCV has no EXR; an ``.exr`` is read back instead),
    and the ``_depth_norm.png`` the HOT colormap of that depth: equal to the
    root's PNG."""
    cv2 = pytest.importorskip("cv2")
    import imageio.v2 as imageio

    from pixelnerf_tpu.data import write_synthetic_dvr
    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.eval.eval import main as eval_main

    data = write_synthetic_dvr(str(tmp_path / "dvr"), n_objs=3, n_views=3, image_size=16)
    conf, ck = _checkpoint(tmp_path)

    def argv(out):
        return ["-n", "ev", "-c", str(conf), "-F", "dvr", "-D", data, "--checkpoints_path",
                str(ck), "--split", "test", "-P", "0", "--write_depth", "-O", str(tmp_path / out)]

    jcalls, calls = _fed_renders(monkeypatch)
    monkeypatch.chdir(tmp_path)
    _run_root(monkeypatch, "eval/eval.py", argv("jax_out"))
    res = eval_main(argv("port_out") + ["--device", "cpu"])

    assert res["cnt"] == 1 and len(calls) == len(jcalls) == 1
    jdir, pdir = tmp_path / "jax_out" / "obj0002", tmp_path / "port_out" / "obj0002"
    assert sorted(os.listdir(pdir)) == [f"00000{v}{s}" for v in (1, 2)
                                        for s in (".png", "_depth.npy", "_depth_norm.png")]
    dset = get_split_dataset("dvr", data, want_split="test")
    z_near, z_far = dset.z_near, dset.z_far
    for v in (1, 2):
        got = np.load(pdir / f"00000{v}_depth.npy")
        if (jdir / f"00000{v}_depth.exr").exists():
            want = cv2.imread(str(jdir / f"00000{v}_depth.exr"), cv2.IMREAD_UNCHANGED)
        else:
            want = np.load(jdir / f"00000{v}_depth.npy")
        assert got.shape == want.shape == (16, 16) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        depth = calls[0][2].reshape(2, 16, 16)[v - 1]
        np.testing.assert_array_equal(got, (depth - z_near) / (z_far - z_near))
        png = imageio.imread(pdir / f"00000{v}_depth_norm.png")
        np.testing.assert_array_equal(png, metrics.cmap(got))
        np.testing.assert_array_equal(png, imageio.imread(jdir / f"00000{v}_depth_norm.png"))


def _render_tree(tmp_path, data_root, objs, views, size, seed):
    """Noisy copies of the ground truth (resized by area to ``size`` where it
    differs) as eval's ``<render dir>/<view:06>.png`` files."""
    from pixelnerf_tpu_torch.data.resize import resize_area
    from pixelnerf_tpu_torch.utils.png import read_png, write_png

    rng = np.random.default_rng(seed)
    out = tmp_path / "render"
    for gt_dir, rend_name in objs:
        d = out / rend_name
        d.mkdir(parents=True)
        for v in views:
            name = next(n for n in sorted(os.listdir(gt_dir / "image")) if int(n[:-4]) == v)
            gt = read_png(str(gt_dir / "image" / name))[..., :3].astype(np.float32)
            if gt.shape[:2] != size:
                gt = resize_area(gt, size)
            noisy = np.clip(gt + rng.normal(0, 12, gt.shape), 0, 255).astype(np.uint8)
            write_png(str(d / f"{v:06}.png"), noisy)
    return out


def _metrics_txt(path):
    return {k: float(v) for k, v in (ln.split() for ln in Path(path).read_text().splitlines())}


@pytest.mark.parametrize("fmt", ["dvr", "dvr_dtu"])
def test_calc_metrics_matches_jax(tmp_path, monkeypatch, fmt):
    """The map and reduce steps through both CLIs on one render tree with
    LPIPS from one seeded file: ``-F dvr --multicat`` on an NMR-layout
    fixture (one object rendered at half size: the ground truth resized by
    Pillow's bilinear; ``-P 0``; a viewlist exclusion), ``-F dvr_dtu`` on a
    DTU one with ``--exclude_dtu_bad --dtu_sort --eval_view_list``; the same
    ``metrics.txt`` values and views, and the reduce step's
    ``all_metrics.txt`` byte for byte on the same ``metrics.txt`` files."""
    from pixelnerf_tpu.data import write_synthetic_dtu, write_synthetic_dvr
    from pixelnerf_tpu.eval import lpips as jlpips
    from pixelnerf_tpu_torch.eval import calc_metrics
    from pixelnerf_tpu_torch.eval.lpips import seeded_state

    weights = tmp_path / "vgg.pth"
    torch.save(seeded_state(5), weights)
    if fmt == "dvr":
        data = Path(write_synthetic_dvr(str(tmp_path / "d"), n_objs=4, n_views=4, image_size=32))
        cat = data / "02958343"
        tree = _render_tree(tmp_path, data, [(cat / "obj0000", "02958343_obj0000")],
                            range(4), (32, 32), 0)
        tree2 = _render_tree(tmp_path / "b", data, [(cat / "obj0001", "02958343_obj0001")],
                             range(4), (16, 16), 1)
        shutil.copytree(tree2 / "02958343_obj0001", tree / "02958343_obj0001")
        (tmp_path / "viewlist.txt").write_text("02958343 obj0001 2\n")
        extra = ["--multicat", "--list_name", "softras_train", "-P", "0", "-L",
                 str(tmp_path / "viewlist.txt")]
        want_views = {"02958343_obj0000": 3, "02958343_obj0001": 2}
    else:
        data = Path(write_synthetic_dtu(str(tmp_path / "d"), n_scenes=2, n_views=9,
                                        image_size=(24, 32), seed=1))
        tree = _render_tree(tmp_path, data, [(data / "scan1", "scan1"), (data / "scan2", "scan2")],
                            range(9), (24, 32), 2)
        (tmp_path / "views.txt").write_text("0 1 2 4 8\n")
        extra = ["--exclude_dtu_bad", "--dtu_sort", "--eval_view_list",
                 str(tmp_path / "views.txt"), "-P", "1"]
        want_views = {"scan1": 3, "scan2": 3}  # 0 2 8: not bad, not -P, listed
    jtree = tmp_path / "jax_render"
    shutil.copytree(tree, jtree)
    base = ["-D", str(data), "-F", fmt, "--lpips_weights", str(weights)] + extra

    monkeypatch.setattr(jlpips, "_cached", None)  # the JAX cache ignores the path
    monkeypatch.chdir(tmp_path)
    _run_root(monkeypatch, "eval/calc_metrics.py", base + ["-O", str(jtree)])
    res = calc_metrics.main(base + ["-O", str(tree), "--device", "cpu"])

    assert {os.path.basename(d): n for d, _, n in res["objects"]} == want_views
    for name in want_views:
        got, want = _metrics_txt(tree / name / "metrics.txt"), _metrics_txt(
            jtree / name / "metrics.txt")
        assert abs(got["psnr"] - want["psnr"]) <= 1e-6
        assert abs(got["ssim"] - want["ssim"]) <= 1e-6
        assert got["lpips"] > 1e-3 and abs(got["lpips"] - want["lpips"]) <= 1e-5 * want["lpips"]
    for name in want_views:  # the reduce step on the root's metrics.txt files
        shutil.copyfile(jtree / name / "metrics.txt", tree / name / "metrics.txt")
    again = calc_metrics.main(base + ["-O", str(tree), "-R"])
    assert again["objects"] == []
    text = (jtree / "all_metrics.txt").read_text()
    assert (tree / "all_metrics.txt").read_bytes() == (jtree / "all_metrics.txt").read_bytes()
    assert again["all_metrics"] == text
    if fmt == "dvr":
        assert text.startswith("synthetic car psnr: ") and "\n---\ntotal        psnr: " in text


def test_calc_metrics_without_lpips_weights(tmp_path, monkeypatch, capsys):
    """No ``--lpips_weights`` and no ``LPIPS_WEIGHTS``: LPIPS is ``nan``, as
    the root CLI reports it, and an existing ``metrics.txt`` is kept unless
    ``--overwrite``."""
    from pixelnerf_tpu.data import write_synthetic_dtu
    from pixelnerf_tpu_torch.eval import calc_metrics

    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    data = Path(write_synthetic_dtu(str(tmp_path / "d"), n_scenes=1, n_views=3,
                                    image_size=(12, 16), seed=1))
    tree = _render_tree(tmp_path, data, [(data / "scan1", "scan1")], range(3), (12, 16), 0)
    argv = ["-D", str(data), "-F", "dvr_dtu", "-O", str(tree)]
    res = calc_metrics.main(argv)
    assert "LPIPS disabled" in capsys.readouterr().out
    vals = _metrics_txt(tree / "scan1" / "metrics.txt")
    assert np.isnan(vals["lpips"]) and np.isfinite(vals["psnr"]) and len(res["objects"]) == 1
    assert res["all_metrics"].startswith(" psnr: ") and res["all_metrics"].endswith("lpips: nan")
    assert calc_metrics.main(argv)["objects"] == []
    assert len(calc_metrics.main(argv + ["--overwrite"])["objects"]) == 1


def test_eval_approx_gives_each_object_its_focal(tmp_path, monkeypatch, capsys):
    """Objects of one batch with their own focal (the port's DVR writer,
    ``focal`` per object): the port's ``eval_approx --batch_size 3`` against
    the root CLI at ``--batch_size 1``, where each object is a batch of its
    own and so rendered with its own focal (at a larger batch the root CLI
    takes the first object's: ROADMAP.md, reference gaps).  Two views an
    object and ``-P "0"``, so both CLIs target view 1 whatever their
    batches; JAX's draws fed: the same rays within 1e-5, frames within one
    u8 level, the final PSNR within 1e-3 dB and SSIM within 1e-4."""
    from pixelnerf_tpu_torch.data import get_split_dataset, write_synthetic_dvr
    from pixelnerf_tpu_torch.eval.eval_approx import main as approx_main

    focals = [10.0, 14.5, 12.0, 16.0, 11.0, 13.0]
    data = write_synthetic_dvr(str(tmp_path / "dvr"), n_objs=6, n_views=2, image_size=16,
                               focal=focals)
    dset = get_split_dataset("dvr", data, want_split="train", training=False)
    got_f = [float(np.asarray(dset[i]["focal"]).reshape(-1)[0]) for i in range(len(dset))]
    np.testing.assert_allclose(got_f, focals[:4], rtol=1e-6)  # 4 train objects, own focals
    conf, ck = _checkpoint(tmp_path)

    def args(batch):
        return ["-n", "ev", "-c", str(conf), "-F", "dvr", "-D", data, "--checkpoints_path",
                str(ck), "--split", "train", "-P", "0", "--batch_size", batch, "-R", "100"]

    jcalls, calls = _fed_renders(monkeypatch)
    monkeypatch.chdir(tmp_path)
    _run_root(monkeypatch, "eval/eval_approx.py", args("1"))
    jout = capsys.readouterr().out
    res = approx_main(args("3") + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(calls) == len(jcalls) == res["cnt"] == 4
    assert [o[2] for o in res["objects"]] == [1] * 4
    for i, ((rays, rgb, _), (jrays, _, jrgb, _)) in enumerate(zip(calls, jcalls)):
        own = geometry.gen_rays_np(dset[i]["poses"][1:2], 16, 16, got_f[i], dset.z_near,
                                   dset.z_far).reshape(-1, 8)
        np.testing.assert_allclose(rays, own, rtol=0, atol=1e-5)  # the object's own focal
        np.testing.assert_allclose(rays, jrays, rtol=0, atol=1e-5)
        assert np.abs(rgb - jrgb).max() <= 1 / 255

    def final(text):
        ln = [ln for ln in text.splitlines() if ln.startswith("final psnr")][0]
        return [float(v) for v in re.findall(r"[-\d.e]+(?=\s|$)", ln)]

    (p, s), (jp, js) = final(out), final(jout)
    assert abs(p - jp) <= 1e-3 and abs(s - js) <= 1e-4
