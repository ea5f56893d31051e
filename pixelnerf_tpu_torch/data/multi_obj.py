"""Multi-object scene adapter (format ``multi_obj``): NeRF-style
``transforms.json`` scenes, as the JAX package reads them.

Layout:

    <datadir>/<split>/<scene>/
        transforms.json     {"camera_angle_x": fov, "frames": [{"file_path",
                             "transform_matrix"}, ...]}
        *.png               renders (RGBA or white background)

Blender camera poses follow the NeRF / OpenGL convention (the camera looks
down -z) and are used as they are.
"""

from __future__ import annotations

import glob
import json
import math
import os

import numpy as np

from .base import BaseDataset, load_image, mask_from_white_background, mask_to_bbox


class MultiObjectDataset(BaseDataset):
    def __init__(self, path: str, stage: str = "train"):
        self.base_path = path
        stage_dir = os.path.join(path, stage)
        if not os.path.isdir(stage_dir):
            stage_dir = path
        self.scenes = sorted(os.path.dirname(p)
                             for p in glob.glob(os.path.join(stage_dir, "*", "transforms.json")))
        if not self.scenes and os.path.exists(os.path.join(stage_dir, "transforms.json")):
            self.scenes = [stage_dir]
        self.z_near, self.z_far = 0.8, 3.5
        self.lindisp = False

    def __len__(self) -> int:
        return len(self.scenes)

    def __getitem__(self, index: int) -> dict:
        scene_dir = self.scenes[index]
        with open(os.path.join(scene_dir, "transforms.json")) as f:
            meta = json.load(f)

        images, poses, masks, bboxes = [], [], [], []
        for frame in meta["frames"]:
            img_path = os.path.join(scene_dir, os.path.basename(frame["file_path"]))
            if not os.path.exists(img_path) and not os.path.splitext(img_path)[1]:
                img_path += ".png"
            img = load_image(img_path)
            mask = mask_from_white_background(img)
            images.append(img)
            poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))
            masks.append(mask)
            bboxes.append(mask_to_bbox(mask))

        W = images[0].shape[1]
        focal = 0.5 * W / math.tan(0.5 * float(meta["camera_angle_x"]))
        return {
            "path": scene_dir,
            "img_id": index,
            "images": np.stack(images).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "masks": np.stack(masks).astype(np.float32),
            "bbox": np.stack(bboxes).astype(np.float32),
            "focal": np.float32(focal),
        }
