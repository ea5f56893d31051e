"""DVR-format dataset adapter: NMR ShapeNet 64x64 (``dvr`` / ``dvr_gen``) and
DTU (``dvr_dtu``), as the JAX package reads them.

On-disk layout:

    <datadir>/<category>/<object>/
        image/NNNN.png            renders (64x64 white background for NMR)
        mask/NNNN.png             optional binary masks
        cameras.npz               world_mat_N (3x4 or 4x4 CV projection K[R|t]),
                                  optional camera_mat_N (NDC scale), scale_mat_N
    <datadir>/<category>/softras_train.lst | softras_val.lst | softras_test.lst
    <datadir>/metadata.yaml       category id -> name (multicat eval)

``dvr_gen`` reads ``gen_`` split lists (the unseen-category split).  DTU
(``sub_format="dtu"``) has scan directories directly under datadir, a
``new_val.lst`` style split, a black background, and projections normalized
by ``scale_mat`` where present.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from .base import (
    BaseDataset,
    decompose_projection,
    load_image,
    load_mask,
    mask_from_white_background,
    mask_to_bbox,
)
from .resize import resize_area


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _image_dirs(parent: str) -> List[str]:
    """The directories under ``parent`` that hold an ``image`` directory."""
    return sorted(d for d in glob.glob(os.path.join(parent, "*"))
                  if os.path.isdir(os.path.join(d, "image")))


class DVRDataset(BaseDataset):
    def __init__(
        self,
        path: str,
        stage: str = "train",
        list_prefix: str = "softras_",
        sub_format: str = "shapenet",
        image_size: Optional[Tuple[int, int]] = None,
        scale_focal: bool = True,
        max_imgs: int = 100000,
    ):
        """:param list_prefix: 'softras_' (NMR) | 'gen_' (unseen-category splits)
        :param sub_format: 'shapenet' | 'dtu'
        :param scale_focal: NMR cameras are in NDC [-1, 1]; scale focal/c by W/2
        """
        self.base_path = path
        self.stage = stage
        self.sub_format = sub_format
        self.image_size = image_size
        self.scale_focal = scale_focal
        self.max_imgs = max_imgs

        self.objs: List[str] = []
        if sub_format == "dtu":
            # scan dirs directly under datadir, split by <list_prefix><stage>.lst
            # or new_<stage>.lst; else every scan
            split_file = next((c for c in (os.path.join(path, f"{list_prefix}{stage}.lst"),
                                           os.path.join(path, f"new_{stage}.lst"))
                               if os.path.exists(c)), None)
            if split_file is not None:
                self.objs = [os.path.join(path, o) for o in _read_list(split_file)]
            else:
                self.objs = _image_dirs(path)
            self.z_near, self.z_far = 0.1, 5.0
        else:
            cats = sorted(d for d in glob.glob(os.path.join(path, "*")) if os.path.isdir(d))
            for cat_dir in cats:
                split_file = os.path.join(cat_dir, f"{list_prefix}{stage}.lst")
                if os.path.exists(split_file):
                    self.objs.extend(os.path.join(cat_dir, o) for o in _read_list(split_file))
                else:
                    self.objs.extend(_image_dirs(cat_dir))
            self.z_near, self.z_far = 1.2, 4.0
        self.lindisp = False

    def __len__(self) -> int:
        return len(self.objs)

    def __getitem__(self, index: int) -> dict:
        obj_dir = self.objs[index]
        img_paths = sorted(glob.glob(os.path.join(obj_dir, "image", "*")))[: self.max_imgs]
        mask_dir = os.path.join(obj_dir, "mask")
        mask_paths = (sorted(glob.glob(os.path.join(mask_dir, "*")))[: self.max_imgs]
                      if os.path.isdir(mask_dir) else None)
        cams = np.load(os.path.join(obj_dir, "cameras.npz"))

        images, poses, masks, bboxes = [], [], [], []
        focals, cs = [], []
        for i, img_path in enumerate(img_paths):
            img = load_image(img_path)
            H0, W0 = img.shape[:2]
            if self.image_size is not None and (H0, W0) != tuple(self.image_size):
                img = resize_area(img, self.image_size)
            H, W = img.shape[:2]

            idx = int(os.path.splitext(os.path.basename(img_path))[0])
            P = np.asarray(cams[f"world_mat_{idx}"], dtype=np.float64)[:3, :4]
            scale_key = f"scale_mat_{idx}"
            if scale_key in cams:
                P = P @ np.asarray(cams[scale_key], dtype=np.float64)
            K, c2w = decompose_projection(P)

            fx, fy = K[0, 0], K[1, 1]
            cx, cy = K[0, 2], K[1, 2]
            if self.scale_focal and self.sub_format != "dtu":
                # NMR projections are in NDC: x_ndc = fx * X/Z + cx with the
                # image spanning [-1, 1] -> pixel focal f * W/2, c at the centre
                fx = fx * W / 2.0
                fy = fy * H / 2.0
                cx = cx * W / 2.0 + W / 2.0
                cy = cy * H / 2.0 + H / 2.0
            elif (H, W) != (H0, W0):
                # resized on load (DTU): K is in the original pixel units --
                # rescale it to the loaded resolution
                fx, cx = fx * W / W0, cx * W / W0
                fy, cy = fy * H / H0, cy * H / H0

            if mask_paths is not None and i < len(mask_paths):
                mask = load_mask(mask_paths[i], size=self.image_size)
            else:
                mask = mask_from_white_background(img)

            images.append(img)
            poses.append(c2w)
            masks.append(mask)
            bboxes.append(mask_to_bbox(mask))
            focals.append([fx, fy])
            cs.append([cx, cy])

        focals = np.asarray(focals, dtype=np.float32)
        cs = np.asarray(cs, dtype=np.float32)
        # Shape discipline (encode reads a 1-D focal / c as per-view scalars):
        # a scalar when isotropic and constant, else (1, 2) or (NV, 2)
        if np.allclose(focals, focals[0], atol=1e-4):
            focal = (np.float32(focals[0, 0]) if abs(focals[0, 0] - focals[0, 1]) < 1e-4
                     else focals[:1])
        else:
            focal = focals
        c = cs[:1] if np.allclose(cs, cs[0], atol=1e-4) else cs

        return {
            "path": obj_dir,
            "img_id": index,
            "images": np.stack(images).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "masks": np.stack(masks).astype(np.float32),
            "bbox": np.stack(bboxes).astype(np.float32),
            "focal": focal.astype(np.float32),
            "c": c.astype(np.float32),
        }
