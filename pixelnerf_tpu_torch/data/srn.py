"""SRN chairs / cars dataset adapter (format ``srn``), as the JAX package
reads it.

On-disk layout (the public SRN release):

    <datadir>/<category>_<split>/<object>/
        rgb/NNNNNN.png          white-background renders
        pose/NNNNNN.txt         16 floats, row-major 4x4 camera-to-world
        intrinsics.txt          "f cx cy 0." on the first line, "H W" on the last

SRN poses use a CV-style camera (z forward); right-multiplying by
diag(1, -1, -1, 1) gives the GL convention.  z bounds: cars 0.8-1.8,
chairs 1.25-2.75.  Images are resized by area to ``image_size`` (128 x 128
unless asked otherwise), enlarging the 64 px release.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import BaseDataset, CV_TO_GL, load_image, mask_from_white_background, mask_to_bbox


class SRNDataset(BaseDataset):
    def __init__(self, path: str, stage: str = "train", image_size=(128, 128),
                 world_scale: float = 1.0):
        self.base_path = path
        self.stage = stage
        self.image_size = tuple(image_size)
        self.world_scale = float(world_scale)

        cands = sorted(glob.glob(os.path.join(path, f"*_{stage}")))
        if len(cands) == 0 and os.path.isdir(os.path.join(path, stage)):
            cands = [os.path.join(path, stage)]
        if len(cands) == 0:
            raise FileNotFoundError(f"No SRN '<cat>_{stage}' directory under {path!r}")
        self.split_dir = cands[0]
        is_chair = "chair" in os.path.basename(self.split_dir)
        # the SRN chairs train set nests one extra level
        nested = os.path.join(self.split_dir, os.path.basename(self.split_dir))
        if is_chair and stage == "train" and os.path.isdir(nested):
            self.split_dir = nested

        self.objs = sorted(d for d in glob.glob(os.path.join(self.split_dir, "*"))
                           if os.path.isdir(os.path.join(d, "rgb")))
        if is_chair:
            self.z_near, self.z_far = 1.25, 2.75
        else:
            self.z_near, self.z_far = 0.8, 1.8
        self.lindisp = False

    def __len__(self) -> int:
        return len(self.objs)

    def __getitem__(self, index: int) -> dict:
        obj_dir = self.objs[index]
        rgb_paths = sorted(glob.glob(os.path.join(obj_dir, "rgb", "*")))
        pose_paths = sorted(glob.glob(os.path.join(obj_dir, "pose", "*")))
        if len(rgb_paths) != len(pose_paths):
            raise ValueError(f"{obj_dir}: {len(rgb_paths)} images but {len(pose_paths)} poses")

        with open(os.path.join(obj_dir, "intrinsics.txt")) as f:
            focal, cx, cy, _ = map(float, f.readline().split())

        images, poses, masks, bboxes = [], [], [], []
        for rgb_path, pose_path in zip(rgb_paths, pose_paths):
            img = load_image(rgb_path, size=self.image_size)
            pose = np.loadtxt(pose_path, dtype=np.float32).reshape(4, 4) @ CV_TO_GL
            if self.world_scale != 1.0:
                pose[:3, 3] *= self.world_scale
            mask = mask_from_white_background(img)
            images.append(img)
            poses.append(pose)
            masks.append(mask)
            bboxes.append(mask_to_bbox(mask))

        return {
            "path": obj_dir,
            "img_id": index,
            "images": np.stack(images).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "masks": np.stack(masks).astype(np.float32),
            "bbox": np.stack(bboxes).astype(np.float32),
            "focal": np.float32(focal * self.world_scale),
            # (1, 2): encode reads a 1-D c as per-view scalars
            "c": np.array([[cx, cy]], dtype=np.float32),
        }
