"""The port's data layer against the JAX package's, on the CPU: the PNG reader
and writer, the area and nearest resize, the camera decomposition, every
file-format adapter on the same fixture directories, the fixture writers,
``SyntheticDataset``, ``get_split_dataset``, ``collate`` and the loader's
cache, and per-view intrinsics in the train batch.

Tolerances: decoded pixels bit for bit (against ``imageio.v2.imread``);
``resize_area`` within 2e-6 of ``cv2.INTER_AREA`` on [0, 1] data and
``resize_nearest`` equal to ``cv2.INTER_NEAREST``; K and c2w within 1e-5
relative of the JAX ``decompose_projection`` (OpenCV inside); adapter
samples with the same keys, shapes and dtypes, images equal (within 2e-6
where resized), poses, focal and c within 1e-5 relative, masks and bbox
equal."""

import json
import os
import struct
import zlib

import numpy as np
import pytest

import pixelnerf_tpu.data as jdata
from pixelnerf_tpu.data import base as jbase
from pixelnerf_tpu.data import synthetic as jsynth
from pixelnerf_tpu.utils import geometry as jgeometry
from pixelnerf_tpu_torch import data as pdata
from pixelnerf_tpu_torch.data import base as pbase
from pixelnerf_tpu_torch.data import synthetic as psynth
from pixelnerf_tpu_torch.data.resize import resize_area, resize_nearest
from pixelnerf_tpu_torch.train.trainer import prepare_ray_batch
from pixelnerf_tpu_torch.utils import geometry
from pixelnerf_tpu_torch.utils.png import encode_png, read_png, write_png

imageio = pytest.importorskip("imageio.v2")

# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _picture(shape, seed=0):
    """Smooth gradients plus noise: adaptive encoders pick several filters."""
    rng = np.random.default_rng(seed)
    H, W = shape[:2]
    y, x = np.mgrid[0:H, 0:W]
    C = shape[2] if len(shape) == 3 else 1
    smooth = np.stack([(x * 5 + y * (3 + k) + 40 * k) % 256 for k in range(C)], axis=-1)
    img = (smooth + rng.integers(0, 12, size=(H, W, C))).astype(np.uint8)
    return img if len(shape) == 3 else img[..., 0]


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _hand_png(img, ctype, filters, n_idat=1, palette=None, trns=None, depth=8, interlace=0):
    """A PNG built here, independently of the port's writer: ``filters``
    gives each row's filter type (cycled), the compressed stream is cut into
    ``n_idat`` IDAT chunks."""
    H, W = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(H, W * bpp).astype(np.int64)
    rows = []
    for yy in range(H):
        f = filters[yy % len(filters)]
        cur, up = x[yy], x[yy - 1] if yy else np.zeros_like(x[0])
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            pred = np.empty_like(cur)
            for i in range(cur.size):  # the Paeth predictor as the PNG spec writes it
                a, b, c = left[i], up[i], upleft[i]
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred[i] = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        rows.append(bytes([f]) + bytes(((cur - pred) % 256).astype(np.uint8)))
    stream = zlib.compress(b"".join(rows), 9)
    cut = np.linspace(0, len(stream), n_idat + 1).astype(int)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                                              0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for a, b in zip(cut[:-1], cut[1:]):
        out += _chunk(b"IDAT", stream[a:b])
    return out + _chunk(b"IEND", b"")


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 2), (21, 19, 3), (21, 19, 4),
                                   (64, 64, 3)])
def test_read_png_matches_imageio_on_its_files(tmp_path, shape):
    img = _picture(shape, seed=len(shape))
    path = str(tmp_path / "i.png")
    imageio.imwrite(path, img)
    got, ref = read_png(path), imageio.imread(path)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape == img.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]])
@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_read_png_each_row_filter(tmp_path, filters, ctype, channels):
    """Hand-built files force each filter type (and a mix, row by row), with
    the stream split over three IDAT chunks."""
    img = _picture((9, 11, channels) if channels > 1 else (9, 11), seed=channels)
    path = tmp_path / "f.png"
    path.write_bytes(_hand_png(img, ctype, filters, n_idat=3))
    got = read_png(str(path))
    np.testing.assert_array_equal(got, imageio.imread(str(path)))
    np.testing.assert_array_equal(got, img)


def test_read_png_palette(tmp_path):
    rng = np.random.default_rng(5)
    palette = rng.integers(0, 256, size=(7, 3))
    idx = rng.integers(0, 7, size=(10, 12)).astype(np.uint8)
    for trns in (None, b"\x00\x80\xff"):  # imageio drops tRNS on palette files
        path = tmp_path / "p.png"
        path.write_bytes(_hand_png(idx, 3, [4, 1, 2], n_idat=2, palette=palette, trns=trns))
        got = read_png(str(path))
        np.testing.assert_array_equal(got, imageio.imread(str(path)))
        np.testing.assert_array_equal(got, palette[idx].astype(np.uint8))


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    img = _picture((6, 7, 3))
    good = _hand_png(img, 2, [0])
    cases = {
        "16bit": _hand_png(img.astype(np.uint16) * 257, 2, [0], depth=16),
        "interlaced": _hand_png(img, 2, [0], interlace=1),
        "crc": good[:40] + bytes([good[40] ^ 1]) + good[41:],  # a flipped IDAT byte
        "truncated": good[:-20],
        "notpng": b"GIF89a" + good[6:],
    }
    for name, blob in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=f"{name}.png"):
            read_png(str(path))


def _old_encode_png(rgb):
    """The RGB writer as it was before gray and RGBA: filter 0, one IDAT."""
    H, W, _ = rgb.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), rgb.reshape(H, W * 3)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_round_trip(tmp_path, channels):
    img = _picture((15, 22, channels), seed=channels)
    if channels == 3:
        assert encode_png(img) == _old_encode_png(img)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(imageio.imread(path), want)
    with pytest.raises(ValueError, match="uint8"):
        encode_png(img.astype(np.float32))


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((300, 400), (75, 100)), ((300, 400), (100, 133)),
                                     ((64, 64), (128, 128)), ((64, 64), (100, 100)),
                                     ((37, 51), (20, 13)), ((30, 20), (15, 45))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_matches_opencv(src, dst, channels):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(sum(src) + channels)
    img = rng.uniform(0, 1, size=src + ((channels,) if channels > 1 else ())).astype(np.float32)
    for fn, flag, tol in ((resize_area, cv2.INTER_AREA, 2e-6),
                          (resize_nearest, cv2.INTER_NEAREST, 0.0)):
        ref = cv2.resize(img, (dst[1], dst[0]), interpolation=flag)
        got = fn(img, dst)
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.abs(got - ref).max() <= tol, fn.__name__
    # a trailing channel axis of 1 is kept
    assert resize_area(img[..., None] if channels == 1 else img[..., :1], dst).shape == dst + (1,)


def test_area_enlarge_by_an_integer_is_replication():
    img = np.random.default_rng(0).uniform(size=(16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(resize_area(img, (32, 48)), resize_nearest(img, (32, 48)))


# ---------------------------------------------------------------------------
# camera decomposition
# ---------------------------------------------------------------------------


def _adversarial_projections(n=6, seed=3):
    """The real-DTU failure modes of tests/test_data.py's oracle: off-center
    c, anisotropic focal, negative projective scale, a rotated scale chain."""
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(n):
        c2w = jgeometry.pose_spherical(rng.uniform(-180, 180), rng.uniform(-80, -5),
                                       rng.uniform(1, 3))
        fx = rng.uniform(40, 80)
        K = np.array([[fx, 0, rng.uniform(10, 90)], [0, fx * rng.uniform(0.8, 1.25),
                                                     rng.uniform(5, 70)], [0, 0, 1]])
        w2c_cv = np.diag([1.0, -1, -1, 1]) @ np.linalg.inv(c2w.astype(np.float64))
        P = K @ w2c_cv[:3, :4]
        lam = rng.uniform(0.5, 4.0) * (-1 if trial % 2 else 1)
        th = rng.uniform(0, 2 * np.pi)
        A = np.eye(4)
        A[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                              [0, 0, 1]]) / rng.uniform(0.5, 3.0)
        A[:3, 3] = rng.normal(size=3) * 0.3
        out += [(P, K, c2w), (lam * P, K, c2w), ((lam * P @ A) @ np.linalg.inv(A), K, c2w),
                ((lam * P).astype(np.float32), K, c2w)]
    return out


def test_decompose_projection_matches_jax():
    for P, K, c2w in _adversarial_projections():
        Kj, cj = jbase.decompose_projection(P)
        Kp, cp = pbase.decompose_projection(P)
        assert Kp.dtype == cp.dtype == np.float32 and Kp.shape == (3, 3) and cp.shape == (4, 4)
        np.testing.assert_allclose(Kp, Kj, rtol=1e-5, atol=1e-5 * np.abs(Kj).max())
        np.testing.assert_allclose(cp, cj, rtol=1e-5, atol=1e-5 * np.abs(cj).max())
        np.testing.assert_allclose(Kp, K, rtol=1e-5, atol=2e-3)  # and the construction truth
        np.testing.assert_allclose(cp, c2w, atol=1e-4)
        assert (np.diag(Kp) > 0).all() and abs(np.linalg.det(cp[:3, :3]) - 1) < 1e-5


# ---------------------------------------------------------------------------
# adapters, on fixtures written by the JAX writers
# ---------------------------------------------------------------------------


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(1.0, float(np.abs(b).max())))


def assert_same_sample(got, ref, resized=False):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        g = got[k]
        if k in ("path", "img_id"):
            assert g == r, k
            continue
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, (k, g.shape, r.shape, g.dtype, r.dtype)
        if k == "images":
            assert np.abs(g - r).max() <= (2e-6 if resized else 0.0), k
        elif k in ("masks", "bbox"):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            _close(g, r)


def assert_same_dataset(fmt, root, **kw):
    for split in ("train", "val", "test"):
        ref = jdata.get_split_dataset(fmt, root, want_split=split, **kw)
        got = pdata.get_split_dataset(fmt, root, want_split=split, **kw)
        assert type(got).__name__ == type(ref).__name__ and len(got) == len(ref) > 0
        assert (got.z_near, got.z_far, got.lindisp) == (ref.z_near, ref.z_far, ref.lindisp)
        for i in range(len(ref)):
            assert_same_sample(got[i], ref[i], resized="image_size" in kw or fmt == "srn")
    return got


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Fixture directories written by the JAX package's writers."""
    root = tmp_path_factory.mktemp("jax_fixtures")
    out = {
        "dvr": jsynth.write_synthetic_dvr(str(root / "dvr"), n_objs=3, n_views=3, image_size=24),
        "dtu": jsynth.write_synthetic_dtu(
            str(root / "dtu"), n_scenes=2, n_views=4, image_size=(30, 40), offcenter_c=0.1,
            focal_aniso=1.2, negate_world_mat=True, scale_rot_deg=33.0, seed=1),
        "dtu_plain": jsynth.write_synthetic_dtu(str(root / "dtu_plain"), n_scenes=1, n_views=3,
                                                image_size=(30, 40)),
        "srn": jsynth.write_synthetic_srn(str(root / "srn"), n_objs=2, n_views=3, image_size=64),
        "multi_obj": jsynth.write_synthetic_multi_obj(str(root / "mo"), n_scenes=2, n_views=3,
                                                      image_size=20),
    }
    gen = jsynth.write_synthetic_dvr(str(root / "gen"), n_objs=4, n_views=2, image_size=16)
    cat = os.path.join(gen, "02958343")
    for split, names in (("train", ["obj0001", "obj0003"]), ("val", ["obj0000"]),
                         ("test", ["obj0002"])):
        with open(os.path.join(cat, f"gen_{split}.lst"), "w") as f:
            f.write("\n".join(names) + "\n")
    out["gen"] = gen
    return out


def test_dvr_adapter_matches_jax(fixtures):
    ds = assert_same_dataset("dvr", fixtures["dvr"])
    s = ds[0]
    assert np.ndim(s["focal"]) == 0 and s["c"].shape == (1, 2)


def test_dvr_gen_adapter_matches_jax(fixtures):
    """With ``gen_`` lists, and without them (every object of a category)."""
    with_lists = assert_same_dataset("dvr_gen", fixtures["gen"])
    assert [os.path.basename(p) for p in with_lists.objs] == ["obj0002"]
    without = assert_same_dataset("dvr_gen", fixtures["dvr"])
    assert len(without) == 3


@pytest.mark.parametrize("image_size", [None, (15, 20), (36, 50)])
def test_dvr_dtu_adapter_matches_jax(fixtures, image_size):
    kw = {} if image_size is None else {"image_size": image_size}
    ds = assert_same_dataset("dvr_dtu", fixtures["dtu"], **kw)
    s = ds[0]
    # per-view c (random offsets), one anisotropic focal row
    assert s["c"].shape == (4, 2) and s["focal"].shape == (1, 2)
    assert s["images"].shape[1:3] == (image_size or (30, 40))
    plain = assert_same_dataset("dvr_dtu", fixtures["dtu_plain"], **kw)[0]
    assert plain["c"].shape == (1, 2)


def test_srn_adapter_matches_jax(fixtures):
    """The 64 px release enlarged to the default 128 x 128, and read at 64."""
    ds = assert_same_dataset("srn", fixtures["srn"])
    assert ds[0]["images"].shape == (3, 128, 128, 3)
    assert_same_dataset("srn", fixtures["srn"], image_size=(64, 64))
    assert_same_dataset("srn", fixtures["srn"], world_scale=1.5)


def test_multi_obj_adapter_matches_jax(fixtures):
    ds = assert_same_dataset("multi_obj", fixtures["multi_obj"])
    assert "c" not in ds[0] and np.ndim(ds[0]["focal"]) == 0


def test_image_and_mask_loading_matches_jax(tmp_path):
    """RGBA composited over white, gray repeated to RGB, masks from the alpha
    or the first channel, resized by area and to the nearest pixel."""
    rgba = _picture((20, 30, 4), seed=9)
    gray = _picture((20, 30), seed=10)
    for name, img in (("rgba", rgba), ("gray", gray), ("rgb", rgba[..., :3])):
        path = str(tmp_path / f"{name}.png")
        imageio.imwrite(path, img)
        for size in (None, (10, 15), (40, 60)):
            got, ref = pbase.load_image(path, size), jbase.load_image(path, size)
            assert got.dtype == ref.dtype and np.abs(got - ref).max() <= 4e-6
            np.testing.assert_array_equal(pbase.load_mask(path, size), jbase.load_mask(path, size))
    img = pbase.load_image(str(tmp_path / "rgb.png"))
    np.testing.assert_array_equal(pbase.mask_from_white_background(img),
                                  jbase.mask_from_white_background(img))


# ---------------------------------------------------------------------------
# the port's writers against the JAX writers
# ---------------------------------------------------------------------------


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_files(got_root, ref_root):
    files = _tree(ref_root)
    assert _tree(got_root) == files
    for rel in files:
        g, r = os.path.join(got_root, rel), os.path.join(ref_root, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(read_png(g), imageio.imread(r), err_msg=rel)
        elif rel.endswith(".npz"):
            gz, rz = np.load(g), np.load(r)
            assert sorted(gz.files) == sorted(rz.files), rel
            for k in rz.files:
                np.testing.assert_array_equal(gz[k], rz[k], err_msg=f"{rel}:{k}")
        elif rel.endswith(".json"):
            assert json.load(open(g)) == json.load(open(r)), rel
        else:  # split lists, poses, intrinsics, metadata
            assert open(g).read() == open(r).read(), rel


@pytest.mark.parametrize("kind", ["dvr", "dtu", "srn", "multi_obj"])
def test_writers_match_jax(tmp_path, kind):
    args = {
        "dvr": ("write_synthetic_dvr", dict(n_objs=3, n_views=2, image_size=16)),
        "dtu": ("write_synthetic_dtu", dict(n_scenes=2, n_views=3, image_size=(15, 20),
                                            offcenter_c=0.1, focal_aniso=1.2,
                                            negate_world_mat=True, scale_rot_deg=20.0)),
        "srn": ("write_synthetic_srn", dict(n_objs=1, n_views=2, image_size=16)),
        "multi_obj": ("write_synthetic_multi_obj", dict(n_scenes=1, n_views=2, image_size=16)),
    }[kind]
    name, kw = args
    getattr(psynth, name)(str(tmp_path / "port"), **kw)
    getattr(jsynth, name)(str(tmp_path / "jax"), **kw)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.mark.parametrize("kind", ["sphere", "multi3", "thin", "offcenter", "large", "cluster"])
def test_synthetic_dataset_matches_jax(kind):
    got = psynth.SyntheticDataset(n_objs=2, n_views=2, image_size=(12, 16), scene_kind=kind)
    ref = jsynth.SyntheticDataset(n_objs=2, n_views=2, image_size=(12, 16), scene_kind=kind)
    assert (got.z_near, got.z_far) == (ref.z_near, ref.z_far)
    for i in range(2):
        a, b = got[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    c2w = jgeometry.pose_spherical(30.0, -20.0, 1.4)
    for ss in (1, 2):
        np.testing.assert_array_equal(
            psynth.render_sphere_image(c2w, 10, 8, 9.0, c=(4.0, 5.0), focal_y=11.0, supersample=ss),
            jsynth.render_sphere_image(c2w, 10, 8, 9.0, c=(4.0, 5.0), focal_y=11.0, supersample=ss))
    with pytest.raises(ValueError, match="scene kind"):
        psynth.scene_objects("cube", np.random.default_rng(0))


def test_get_split_dataset_every_format(fixtures):
    roots = {"dvr": fixtures["dvr"], "dvr_gen": fixtures["gen"], "dvr_dtu": fixtures["dtu"],
             "srn": fixtures["srn"], "multi_obj": fixtures["multi_obj"], "synthetic": ""}
    for fmt, root in roots.items():
        got, ref = pdata.get_split_dataset(fmt, root), jdata.get_split_dataset(fmt, root)
        assert isinstance(got, tuple) and len(got) == 3
        assert [type(d).__name__ for d in got] == [type(d).__name__ for d in ref]
        assert [len(d) for d in got] == [len(d) for d in ref]
    with pytest.raises(NotImplementedError, match="Unsupported"):
        pdata.get_split_dataset("llff", "")


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["dvr", "dvr_dtu", "srn", "multi_obj"])
def test_loader_and_collate_match_jax_on_file_formats(fixtures, fmt):
    """Shuffled epochs of 2-object batches and the frozen cache: string
    paths, a scalar focal (dvr, srn, multi_obj), a (1, 2) focal and a
    per-view c (NV, 2) (dvr_dtu)."""
    root = {"dvr": fixtures["gen"], "dvr_dtu": fixtures["dtu"], "srn": fixtures["srn"],
            "multi_obj": fixtures["multi_obj"]}[fmt]
    ds = pdata.get_split_dataset(fmt, root, want_split="train")
    jds = jdata.get_split_dataset(fmt, root, want_split="train")
    cap = 1.2 * pdata.DataLoader._sample_bytes(ds[0]) / 1e6  # room for one sample
    loader = pdata.DataLoader(ds, batch_size=2, shuffle=True, seed=3, cache_mb=cap)
    jloader = jdata.DataLoader(jds, batch_size=2, shuffle=True, seed=3, cache_mb=cap)
    assert len(loader) == len(jloader)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        n = 0
        for a, b in zip(loader, jloader):
            n += 1
            assert sorted(a) == sorted(b) and a["path"] == b["path"] and a["img_id"] == b["img_id"]
            assert all(isinstance(p, str) for p in a["path"])
            for k in b:
                if k not in ("path", "img_id"):
                    assert np.asarray(a[k]).shape == np.asarray(b[k]).shape, k
                    _close(a[k], b[k])
        assert n == len(jloader)
    assert loader._cache_bytes == jloader._cache_bytes and len(loader._cache) == 1
    batch = pdata.collate([ds[0], ds[0]])
    jbatch = jdata.collate([jds[0], jds[0]])
    for k in ("focal", "c"):
        if k in jbatch:
            assert batch[k].shape == jbatch[k].shape and batch[k].dtype == jbatch[k].dtype
    if fmt == "dvr_dtu":
        # objects whose c rows differ in count do not stack: both drop the batch
        one_row = dict(ds[0], c=ds[0]["c"][:1])
        assert pdata.collate([ds[0], one_row]) is None
        assert jdata.collate([jds[0], dict(jds[0], c=jds[0]["c"][:1])]) is None


def test_per_view_intrinsics_in_the_train_batch(fixtures):
    """A per-view c (the DTU fixture's random offsets): each ray uses its own
    view's row, as one-view calls of the JAX ray builder do, and the encoder
    gets the source views' rows, (SB, NS, 2)."""
    ds = pdata.get_split_dataset("dvr_dtu", fixtures["dtu"], want_split="train")
    data = pdata.collate([ds[0], ds[1]])
    assert data["c"].shape == (2, 4, 2) and data["focal"].shape == (2, 1, 2)
    batch = prepare_ray_batch(data, 3, 40, ds.z_near, ds.z_far, False, np.random.default_rng(1))
    assert batch["c"].shape == (2, 3, 2) and batch["focal"].shape == (2, 1, 2)
    rng = np.random.default_rng(1)  # prepare_ray_batch's draws, replayed
    H, W = data["images"].shape[2:4]
    for o in range(2):
        order = rng.choice(4, 3, replace=False)
        flat = rng.integers(0, 4 * H * W, (40,))
        pix = np.stack([flat // (H * W), (flat // W) % H, flat % W], axis=-1)
        np.testing.assert_array_equal(batch["c"][o], data["c"][o][order])
        for r, (v, y, x) in enumerate(pix):
            one = jgeometry.gen_rays_at_np(data["poses"][o][v:v + 1], W, H, data["focal"][o], 0.1,
                                           5.0, np.array([[0, y, x]]), c=data["c"][o][v])
            np.testing.assert_allclose(batch["rays"][o, r], one[0], rtol=1e-6, atol=1e-6)
    # the full-image builder: one row per view, as one-view calls
    poses = data["poses"][0]
    rays = geometry.gen_rays_np(poses, W, H, data["focal"][0], 0.1, 5.0, c=data["c"][0])
    for v in range(4):
        one = jgeometry.gen_rays_np(poses[v:v + 1], W, H, data["focal"][0], 0.1, 5.0,
                                    c=data["c"][0][v])
        np.testing.assert_array_equal(rays[v], np.asarray(one)[0])
    # a shared row leaves the builders as they were: the JAX arrays bit for bit
    plain = pdata.collate([pdata.get_split_dataset("dvr_dtu", fixtures["dtu_plain"],
                                                   want_split="val")[0]])
    np.testing.assert_array_equal(
        geometry.gen_rays_np(plain["poses"][0], 40, 30, plain["focal"][0], 0.1, 5.0,
                             c=plain["c"][0]),
        np.asarray(jgeometry.gen_rays_np(plain["poses"][0], 40, 30, plain["focal"][0], 0.1, 5.0,
                                         c=plain["c"][0])))
