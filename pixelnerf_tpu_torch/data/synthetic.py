"""Synthetic datasets: analytic Lambert-sphere and ellipsoid scenes (numpy
only), the twin of the JAX package's ``data/synthetic.py``.

The scenes are ray traced with the framework's own camera model
(:func:`geometry.gen_rays_np`), kept in memory (``SyntheticDataset``) or
written to disk in the SRN / DVR / DTU / multi-object formats with the
port's PNG writer, so every adapter, CLI and training loop runs end to end
without external data.  The pixels and cameras equal those of the JAX
package's writers.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Tuple

import numpy as np

from ..utils import geometry  # host-side pose constructors (numpy)
from ..utils.png import write_png
from .base import CV_TO_GL, BaseDataset, mask_to_bbox


def _pix_coords(n: int, ss: int) -> np.ndarray:
    """Pixel-coordinate sample positions along one axis: the pixel centers
    (ss=1) or the ss subpixel centers of each pixel (ss>1), in the SAME
    pixel coordinate frame — pixel i spans [i-0.5, i+0.5)."""
    if ss == 1:
        return np.arange(n, dtype=np.float32)
    return (np.arange(n * ss, dtype=np.float32) + 0.5) / ss - 0.5


def _box_down(img: np.ndarray, ss: int) -> np.ndarray:
    """Average ss x ss subpixel blocks back to the target resolution."""
    if ss == 1:
        return img
    h, w = img.shape[0] // ss, img.shape[1] // ss
    return img.reshape(h, ss, w, ss, 3).mean(axis=(1, 3))


def render_sphere_image(
    c2w: np.ndarray,
    width: int,
    height: int,
    focal: float,
    radius: float = 0.5,
    color: Tuple[float, float, float] = (0.8, 0.3, 0.2),
    color2: Tuple[float, float, float] = (0.2, 0.4, 0.9),
    light_dir: Tuple[float, float, float] = (0.4, 0.8, 0.45),
    c: Optional[Tuple[float, float]] = None,
    focal_y: Optional[float] = None,
    supersample: int = 1,
) -> np.ndarray:
    """Ray-trace a two-tone Lambert sphere at the origin -> (H, W, 3) in [0, 1].

    Pure numpy (no device needed): ray math replicates utils.geometry.gen_rays /
    unproj_map exactly so generated cameras are consistent with the framework.
    ``c`` / ``focal_y`` support off-center and anisotropic intrinsics
    (adversarial DTU fixtures).  ``supersample`` traces ss*ss rays per pixel
    and box-averages — the pixel-integrated (anti-aliased) ground truth a
    band-limited volumetric renderer should be scored against.
    """
    ss = int(supersample)
    cx, cy = (width * 0.5, height * 0.5) if c is None else c
    fy = focal if focal_y is None else focal_y
    xs = (_pix_coords(width, ss) - cx) / focal
    ys = (_pix_coords(height, ss) - cy) / fy
    width, height = width * ss, height * ss
    X, Y = np.meshgrid(xs, ys)
    dirs = np.stack([X, -Y, -np.ones_like(X)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    d = dirs @ c2w[:3, :3].T
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    b = np.sum(o * d, axis=-1)
    c_ = np.sum(o * o, axis=-1) - radius**2
    disc = b * b - c_
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = o + t[..., None] * d
    n = p / radius
    l = np.asarray(light_dir, np.float32)
    l = l / np.linalg.norm(l)
    lam = 0.3 + 0.7 * np.maximum(np.sum(n * l, axis=-1), 0.0)
    # two-tone: hemisphere split in object x makes orientation visible
    base = np.where(
        (p[..., :1] > 0), np.asarray(color, np.float32), np.asarray(color2, np.float32)
    )
    img = np.ones((height, width, 3), np.float32)
    img[hit] = (base * lam[..., None])[hit]
    return _box_down(np.clip(img, 0.0, 1.0), ss)


def render_scene_image(
    c2w: np.ndarray,
    width: int,
    height: int,
    focal: float,
    objects,
    light_dir: Tuple[float, float, float] = (0.4, 0.8, 0.45),
    supersample: int = 1,
) -> np.ndarray:
    """Ray-trace a multi-ellipsoid scene -> (H, W, 3) in [0, 1].

    ``objects`` is a list of dicts {center (3,), radii (3,) or scalar, color,
    color2}; nearest-hit compositing with the same Lambert shading and camera
    model as :func:`render_sphere_image`.  Ellipsoids cover the adversarial
    geometry families an occupancy-grid accel is validated on: multi-object
    scenes, thin rods/plates (chair legs), off-center objects,
    large-foreground blobs.
    """
    ss = int(supersample)
    cx, cy = width * 0.5, height * 0.5
    xs = (_pix_coords(width, ss) - cx) / focal
    ys = (_pix_coords(height, ss) - cy) / focal
    width, height = width * ss, height * ss
    X, Y = np.meshgrid(xs, ys)
    dirs = np.stack([X, -Y, -np.ones_like(X)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    d = dirs @ c2w[:3, :3].T
    o = np.broadcast_to(c2w[:3, 3], d.shape).astype(np.float32)

    l = np.asarray(light_dir, np.float32)
    l = l / np.linalg.norm(l)
    img = np.ones((height, width, 3), np.float32)
    best_t = np.full((height, width), np.inf, np.float32)
    for obj in objects:
        ctr = np.asarray(obj["center"], np.float32)
        radii = np.asarray(obj.get("radii", 0.5), np.float32)
        if radii.ndim == 0:
            radii = np.full(3, float(radii), np.float32)
        # unit-sphere space: scale the ray by 1/radii
        op = (o - ctr) / radii
        dp = d / radii
        a = np.sum(dp * dp, axis=-1)
        b = np.sum(op * dp, axis=-1)
        cq = np.sum(op * op, axis=-1) - 1.0
        disc = b * b - a * cq
        hit = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / np.maximum(a, 1e-12)
        hit &= (t > 0) & (t < best_t)
        p = o + t[..., None] * d
        n = (p - ctr) / (radii**2)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        lam = 0.3 + 0.7 * np.maximum(np.sum(n * l, axis=-1), 0.0)
        base = np.where(
            (p[..., :1] > ctr[0]),
            np.asarray(obj.get("color", (0.8, 0.3, 0.2)), np.float32),
            np.asarray(obj.get("color2", (0.2, 0.4, 0.9)), np.float32),
        )
        shaded = base * lam[..., None]
        img[hit] = shaded[hit]
        best_t = np.where(hit, t, best_t)
    return _box_down(np.clip(img, 0.0, 1.0), ss)


def scene_objects(kind: str, rng: np.random.Generator):
    """Adversarial scene-family presets:

    - ``sphere``: the control (one centered sphere)
    - ``multi3``: three separated spheres of varied size (multi-object)
    - ``thin``: a chair-like frame — 4 thin legs + a thin plate seat + small
      back rest; worst case for coarse occupancy grids (sub-voxel structure)
    - ``offcenter``: one small sphere far off-center (fg fraction ~0.05)
    - ``large``: a radius-0.7 blob (fg fraction ~0.5+; pruning nearly useless)
    - ``cluster``: 10 scattered small spheres (fragmented occupancy)
    """
    col = lambda: tuple(rng.uniform(0.1, 0.9, 3).tolist())
    mk = lambda center, radii: dict(
        center=center, radii=radii, color=col(), color2=col()
    )
    if kind == "sphere":
        return [mk((0.0, 0.0, 0.0), float(rng.uniform(0.35, 0.5)))]
    if kind == "multi3":
        return [
            mk((-0.35, -0.1, 0.25), 0.22),
            mk((0.35, 0.05, -0.2), 0.3),
            mk((0.0, 0.33, 0.0), 0.16),
        ]
    if kind == "thin":
        legs = [
            mk((sx * 0.28, -0.25, sz * 0.28), (0.035, 0.3, 0.035))
            for sx in (-1, 1)
            for sz in (-1, 1)
        ]
        seat = mk((0.0, 0.04, 0.0), (0.36, 0.035, 0.36))
        back = mk((0.0, 0.35, -0.3), (0.34, 0.3, 0.03))
        return legs + [seat, back]
    if kind == "offcenter":
        return [mk((0.45, 0.2, -0.3), 0.14)]
    if kind == "large":
        return [mk((0.0, 0.0, 0.0), 0.7)]
    if kind == "cluster":
        pts = rng.uniform(-0.45, 0.45, size=(10, 3))
        return [mk(tuple(p.tolist()), float(rng.uniform(0.06, 0.13))) for p in pts]
    raise ValueError(f"unknown scene kind {kind!r}")


def _object_params(rng: np.random.Generator):
    return dict(
        radius=float(rng.uniform(0.35, 0.5)),
        color=tuple(rng.uniform(0.1, 0.9, 3).tolist()),
        color2=tuple(rng.uniform(0.1, 0.9, 3).tolist()),
    )


def _camera_ring(n_views: int, radius: float = 1.4, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_views):
        theta = 360.0 * i / n_views + rng.uniform(-5, 5)
        phi = rng.uniform(-45.0, -10.0)
        poses.append(geometry.pose_spherical(theta, phi, radius))
    return np.stack(poses)


def _save_png(path: str, img01: np.ndarray) -> None:
    write_png(path, (img01 * 255.0 + 0.5).astype(np.uint8))


def write_synthetic_dvr(
    out_dir: str,
    n_objs: int = 3,
    n_views: int = 8,
    image_size: int = 64,
    focal=None,
    category: str = "02958343",
    seed: int = 0,
) -> str:
    """Write a DVR-format (NMR-style) dataset with softras_* split lists and
    NDC-normalized cameras.npz projections.  ``focal``: one for every object
    (default 0.85 * image_size), or a sequence of one an object."""
    if focal is None:
        focal = 0.85 * image_size
    focals = list(focal) if np.ndim(focal) else [focal] * n_objs
    cat_dir = os.path.join(out_dir, category)
    os.makedirs(cat_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    W = H = image_size
    obj_names = []
    for oi in range(n_objs):
        name = f"obj{oi:04d}"
        obj_names.append(name)
        obj_dir = os.path.join(cat_dir, name)
        img_dir = os.path.join(obj_dir, "image")
        os.makedirs(img_dir, exist_ok=True)
        params = _object_params(rng)
        poses = _camera_ring(n_views, seed=seed * 1000 + oi)
        cams = {}
        focal = focals[oi]
        for vi in range(n_views):
            img = render_sphere_image(poses[vi], W, H, focal, **params)
            _save_png(os.path.join(img_dir, f"{vi:04d}.png"), img)
            # CV projection in NDC: K_ndc = diag(f/(W/2), f/(H/2), 1), c at center
            K = np.array(
                [
                    [focal / (W / 2.0), 0, 0],
                    [0, focal / (H / 2.0), 0],
                    [0, 0, 1],
                ],
                np.float64,
            )
            w2c_gl = np.linalg.inv(poses[vi].astype(np.float64))
            w2c_cv = np.diag([1.0, -1.0, -1.0, 1.0]) @ w2c_gl
            cams[f"world_mat_{vi}"] = (K @ w2c_cv[:3, :4]).astype(np.float32)
            cams[f"camera_mat_{vi}"] = K.astype(np.float32)
        np.savez(os.path.join(obj_dir, "cameras.npz"), **cams)

    n_train = max(1, n_objs - 2)
    splits = {
        "train": obj_names[:n_train],
        "val": obj_names[n_train : n_train + 1] or obj_names[:1],
        "test": obj_names[n_train + 1 :] or obj_names[:1],
    }
    for split, names in splits.items():
        with open(os.path.join(cat_dir, f"softras_{split}.lst"), "w") as f:
            f.write("\n".join(names) + "\n")
    with open(os.path.join(out_dir, "metadata.yaml"), "w") as f:
        f.write(f"{category}:\n  name: synthetic car\n")
    return out_dir


def write_synthetic_dtu(
    out_dir: str,
    n_scenes: int = 2,
    n_views: int = 8,
    image_size: Tuple[int, int] = (75, 100),
    seed: int = 0,
    offcenter_c: float = 0.0,
    focal_aniso: float = 1.0,
    negate_world_mat: bool = False,
    scale_rot_deg: float = 0.0,
) -> str:
    """Write a DTU-style (rs_dtu_4) dataset: scan directories directly under
    datadir, pixel-unit CV projections ``world_mat_N`` with a ``scale_mat_N``
    normalization, `mask/` images, and a ``new_val.lst`` split.

    Adversarial-camera knobs (decomposition hardening — the classic real-DTU
    failure modes):

    :param offcenter_c: principal point offset as a fraction of W/H (per-view
        random sign), instead of the image center
    :param focal_aniso: fy = focal * focal_aniso (anisotropic intrinsics)
    :param negate_world_mat: store odd views' projections scaled by a NEGATIVE
        constant (projectively identical; breaks naive RQ sign handling)
    :param scale_rot_deg: rotate the normalization frame inside scale_mat by
        this angle (nontrivial scale_mat chain, not a pure similarity shift)

    Also writes per-scene ``meta.json`` with the ground-truth sphere geometry
    in the normalized frame, for independent geometric oracles in tests.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    H, W = image_size
    focal = 0.9 * W
    fy = focal * focal_aniso
    scene_names = []
    for si in range(n_scenes):
        name = f"scan{si + 1}"
        scene_names.append(name)
        scene_dir = os.path.join(out_dir, name)
        img_dir = os.path.join(scene_dir, "image")
        mask_dir = os.path.join(scene_dir, "mask")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(mask_dir, exist_ok=True)
        params = _object_params(rng)
        poses = _camera_ring(n_views, radius=1.6, seed=seed * 77 + si)
        # DTU scenes live in an arbitrary world frame; scale_mat maps the
        # normalized frame back to it (P_norm = world_mat @ scale_mat)
        s = 2.5
        shift = np.array([0.3, -0.2, 0.1], np.float64)
        scale_mat = np.eye(4, dtype=np.float64)
        scale_mat[:3, :3] *= 1.0 / s
        scale_mat[:3, 3] = -shift / s
        if scale_rot_deg:
            th = math.radians(scale_rot_deg)
            Rz = np.array(
                [
                    [math.cos(th), -math.sin(th), 0],
                    [math.sin(th), math.cos(th), 0],
                    [0, 0, 1],
                ],
                np.float64,
            )
            # rotate the normalized frame: scale_mat maps normalized -> world
            scale_mat[:3, :3] = scale_mat[:3, :3] @ Rz
            # cameras/sphere stay defined in the (now rotated) normalized
            # frame, so images are unchanged; only the matrix chain differs
        inv_scale = np.linalg.inv(scale_mat)
        cams = {}
        intr = []
        for vi in range(n_views):
            cx = W / 2.0 + (
                offcenter_c * W * rng.choice([-1.0, 1.0]) if offcenter_c else 0.0
            )
            cy = H / 2.0 + (
                offcenter_c * H * rng.choice([-1.0, 1.0]) if offcenter_c else 0.0
            )
            K = np.array(
                [[focal, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64
            )
            intr.append([focal, fy, cx, cy])
            img = render_sphere_image(
                poses[vi], W, H, focal, c=(cx, cy), focal_y=fy, **params
            )
            _save_png(os.path.join(img_dir, f"{vi:06d}.png"), img)
            mask = (np.linalg.norm(img - img[0, 0], axis=-1) > 0.02).astype(
                np.float32
            )
            _save_png(os.path.join(mask_dir, f"{vi:06d}.png"), mask[..., None].repeat(3, -1))
            w2c_gl = np.linalg.inv(poses[vi].astype(np.float64))
            w2c_cv = np.diag([1.0, -1.0, -1.0, 1.0]) @ w2c_gl
            P_pix = K @ w2c_cv[:3, :4]  # projection in the normalized frame
            # store the un-normalized projection; loaders recover P_pix via
            # world_mat @ scale_mat
            world_mat = P_pix @ inv_scale
            if negate_world_mat and vi % 2 == 1:
                world_mat = -2.2 * world_mat  # projectively identical
            cams[f"world_mat_{vi}"] = world_mat.astype(np.float32)
            cams[f"scale_mat_{vi}"] = scale_mat.astype(np.float32)
        np.savez(os.path.join(scene_dir, "cameras.npz"), **cams)
        with open(os.path.join(scene_dir, "meta.json"), "w") as f:
            json.dump(
                {
                    "sphere_radius": params["radius"],
                    "sphere_center": [0.0, 0.0, 0.0],
                    "cam_radius": 1.6,
                    "intrinsics": intr,
                },
                f,
            )

    with open(os.path.join(out_dir, "new_val.lst"), "w") as f:
        f.write("\n".join(scene_names) + "\n")
    return out_dir


def write_synthetic_srn(
    out_dir: str,
    n_objs: int = 2,
    n_views: int = 10,
    image_size: int = 64,
    focal: float = None,
    category: str = "car",
    seed: int = 0,
) -> str:
    """Write an SRN-format dataset (<cat>_<split>/<obj>/{rgb,pose,intrinsics})."""
    if focal is None:
        focal = 0.85 * image_size
    rng = np.random.default_rng(seed)
    W = H = image_size
    for split, count in (("train", n_objs), ("val", 1), ("test", 1)):
        split_dir = os.path.join(out_dir, f"{category}_{split}")
        for oi in range(count):
            obj_dir = os.path.join(split_dir, f"obj{oi:04d}")
            os.makedirs(os.path.join(obj_dir, "rgb"), exist_ok=True)
            os.makedirs(os.path.join(obj_dir, "pose"), exist_ok=True)
            params = _object_params(rng)
            poses = _camera_ring(n_views, seed=seed * 7777 + oi)
            for vi in range(n_views):
                img = render_sphere_image(poses[vi], W, H, focal, **params)
                _save_png(os.path.join(obj_dir, "rgb", f"{vi:06d}.png"), img)
                pose_cv = poses[vi] @ CV_TO_GL  # loader re-applies CV_TO_GL
                np.savetxt(
                    os.path.join(obj_dir, "pose", f"{vi:06d}.txt"),
                    pose_cv.reshape(1, 16),
                )
            with open(os.path.join(obj_dir, "intrinsics.txt"), "w") as f:
                f.write(f"{focal} {W/2.0} {H/2.0} 0.\n0. 0. 0.\n1.\n{H} {W}\n")
    return out_dir


def write_synthetic_multi_obj(
    out_dir: str, n_scenes: int = 2, n_views: int = 8, image_size: int = 64, seed: int = 0
) -> str:
    """Write NeRF-format transforms.json scenes (multi_obj layout)."""
    W = H = image_size
    focal = 0.85 * image_size
    camera_angle_x = 2.0 * math.atan(0.5 * W / focal)
    rng = np.random.default_rng(seed)
    for split in ("train", "val", "test"):
        for si in range(n_scenes if split == "train" else 1):
            scene_dir = os.path.join(out_dir, split, f"scene{si:04d}")
            os.makedirs(scene_dir, exist_ok=True)
            params = _object_params(rng)
            poses = _camera_ring(n_views, seed=seed * 31 + si)
            frames = []
            for vi in range(n_views):
                img = render_sphere_image(poses[vi], W, H, focal, **params)
                fname = f"r_{vi:03d}.png"
                _save_png(os.path.join(scene_dir, fname), img)
                frames.append(
                    {
                        "file_path": f"./{fname}",
                        "transform_matrix": poses[vi].tolist(),
                    }
                )
            with open(os.path.join(scene_dir, "transforms.json"), "w") as f:
                json.dump(
                    {"camera_angle_x": camera_angle_x, "frames": frames}, f
                )
    return out_dir


class SyntheticDataset(BaseDataset):
    """In-memory ray-traced dataset (no disk IO) for fast tests and benchmarks.

    ``scene_kind`` selects a geometry family from :func:`scene_objects`
    ("sphere" default, one centered sphere; "multi3"/"thin"/"offcenter"/
    "large"/"cluster" are the adversarial scenes).  ``image_size`` is a
    square side or an (H, W) pair (a DTU-like (76, 100) is non-square).
    Object ``index`` is a pure function of ``(seed, index)``."""

    def __init__(
        self,
        n_objs: int = 4,
        n_views: int = 8,
        image_size=64,
        focal: float = None,
        seed: int = 0,
        scene_kind: str = "sphere",
        z_range=None,
    ):
        self.n_objs = n_objs
        self.n_views = n_views
        if isinstance(image_size, (tuple, list)):
            self.height, self.width = int(image_size[0]), int(image_size[1])
        else:
            self.height = self.width = int(image_size)
        self.image_size = max(self.height, self.width)
        self.focal = focal if focal is not None else 0.85 * min(
            self.height, self.width
        )
        self.seed = seed
        self.scene_kind = scene_kind
        # depth span must cover the scene family: the centered sphere fits
        # [0.8, 1.8] from the radius-1.4 camera ring, but the adversarial
        # scenes place objects up to ~0.95 from the origin (scene_objects),
        # depths 0.45..2.35, and clipping them makes ground-truth pixels
        # that no sample along the ray can explain.
        if z_range is not None:
            self.z_near, self.z_far = float(z_range[0]), float(z_range[1])
        elif scene_kind == "sphere":
            self.z_near, self.z_far = 0.8, 1.8
        else:
            self.z_near, self.z_far = 0.45, 2.4
        self.lindisp = False

    def __len__(self) -> int:
        return self.n_objs

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed * 997 + index)
        if self.scene_kind == "sphere":
            params = _object_params(rng)
            render = lambda pose: render_sphere_image(
                pose, self.width, self.height, self.focal, **params
            )
        else:
            objs = scene_objects(self.scene_kind, rng)
            render = lambda pose: render_scene_image(
                pose, self.width, self.height, self.focal, objs
            )
        poses = _camera_ring(self.n_views, seed=self.seed * 131 + index)
        H, W = self.height, self.width
        images, masks, bboxes = [], [], []
        for vi in range(self.n_views):
            img01 = render(poses[vi])
            img = img01 * 2.0 - 1.0
            mask = (~np.all(img01 > 0.996, axis=-1)).astype(np.float32)[..., None]
            images.append(img)
            masks.append(mask)
            bboxes.append(mask_to_bbox(mask))
        return {
            "path": f"synthetic/{index}",
            "img_id": index,
            "images": np.stack(images).astype(np.float32),
            "poses": poses.astype(np.float32),
            "masks": np.stack(masks).astype(np.float32),
            "bbox": np.stack(bboxes).astype(np.float32),
            "focal": np.float32(self.focal),
        }
