"""A 360-degree novel-view video of each real image of a directory, on the
card:

    python -m pixelnerf_tpu_torch.eval.eval_real [-n srn_car] [-c conf/exp/srn.conf] \\
        [-I input] [-O output] [--size 128] [--out_size "128"] [--focal 131.25] \\
        [--radius 1.3] [--num_views 24] [--accel_mode auto|off|rays|proposal|samples] \\
        [--no_vid | --gif] [--device cpu]

The counterpart of the repository's ``eval/eval_real.py``, with its flags
and defaults.  Each ``<input>/*_normalize.png`` (a segmented, centred object
from ``scripts/preproc.py``; RGBA loses its alpha and gray is repeated, as
``PIL``'s ``convert("RGB")`` does) is resized so that its shorter side is
``--size`` (Pillow's bilinear filter, in numpy), encoded under a dummy pose
at ``--radius`` on the z axis, and rendered along a Blender-frame spherical
path of ``--num_views`` frames in the u8 wire format.  On the card the render
is pruned by an occupancy grid built over every frame's rays: ``auto`` (the
default) tries ``proposal`` and keeps it if frame 0 agrees with a dense
render of the same draws to 30 dB, else steps down to ``rays``; ``off``
composites every sample.  A CPU device renders dense, as the root CLI does.

Writes ``<output>/<name>_frames/NNNN.png`` with the port's PNG writer, and
the ``<name>_vid.mp4`` (``.gif`` with ``--gif`` or without ffmpeg) only when
``imageio`` imports.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from ..config.args import PROJECT_ROOT
from ..train.cli import IMPLS

# the rays a render step, as the root CLI renders
RAY_BATCH = 80000


def extra_args(parser):
    parser.add_argument("--input", "-I", type=str, default=os.path.join(PROJECT_ROOT, "input"),
                        help="Image directory")
    parser.add_argument("--output", "-O", type=str, default=os.path.join(PROJECT_ROOT, "output"),
                        help="Output directory")
    parser.add_argument("--size", type=int, default=128,
                        help="Input image size: its shorter side is scaled to this")
    parser.add_argument("--out_size", type=str, default="128",
                        help="Output image size, either 1 or 2 numbers (w h)")
    parser.add_argument("--focal", type=float, default=131.25, help="Focal length")
    parser.add_argument("--radius", type=float, default=1.3, help="Camera distance")
    parser.add_argument("--z_near", type=float, default=0.8)
    parser.add_argument("--z_far", type=float, default=1.8)
    parser.add_argument("--elevation", "-e", type=float, default=0.0, help="Elevation angle")
    parser.add_argument("--num_views", type=int, default=24, help="Number of video frames")
    parser.add_argument("--fps", type=int, default=15, help="FPS of video")
    parser.add_argument("--gif", action="store_true", help="Store gif instead of mp4")
    parser.add_argument("--no_vid", action="store_true", help="Only write image frames")
    parser.add_argument("--accel_mode", type=str, default="auto",
                        choices=["auto", "off", "rays", "proposal", "samples"],
                        help="occupancy-grid pruning of the render: 'auto' (default) tries "
                        "'proposal' and self-gates it against a dense render of frame 0 (below "
                        "30 dB it uses 'rays'); 'proposal' forces grid-guided sampling in place of "
                        "the coarse pass (ungated); 'off' composites every sample")
    parser.add_argument("--mlp_impl", type=str, default="auto", choices=tuple(IMPLS),
                        help="field implementation: 'auto' uses the CUDA kernels on the card and "
                        "plain torch elsewhere; 'pallas'/'cuda' forces the kernels; 'xla'/'torch' "
                        "the plain field")
    return parser


def read_rgb(path: str) -> np.ndarray:
    """An 8-bit PNG as (H, W, 3) uint8 RGB: alpha dropped, gray repeated."""
    from ..utils.png import read_png

    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):  # gray, gray + alpha
        img = img[..., :1]
    return np.ascontiguousarray(np.broadcast_to(img[..., :3], img.shape[:2] + (3,)))


def encoder_input(path: str, size: int) -> np.ndarray:
    """The image at ``path`` as RGB, its shorter side resized to ``size`` by
    Pillow's bilinear filter -> (h, w, 3) uint8."""
    from ..data.resize import resize_bilinear_pil

    image = read_rgb(path)
    h, w = image.shape[:2]
    scale = size / min(w, h)
    return resize_bilinear_pil(image, (round(h * scale), round(w * scale)))


def spherical_rays(num_views: int, elevation: float, radius: float, W: int, H: int, focal,
                   z_near: float, z_far: float) -> np.ndarray:
    """The rays (num_views * H * W, 8) of a spherical path around the
    origin, its poses taken from the Blender frame."""
    from ..utils import geometry

    from_blender = geometry.coord_from_blender()
    poses = np.stack([from_blender @ geometry.pose_spherical(angle, elevation, radius)
                      for angle in np.linspace(-180, 180, num_views + 1)[:-1]])
    return geometry.gen_rays_np(poses, W, H, focal, z_near, z_far).reshape(-1, 8)


def main(argv=None) -> dict:
    """Render every input.  Returns ``{"inputs": [{"path", "encoder_input":
    (h, w, 3) uint8, "frames": (F, H, W, 3) uint8, "frame_dir", "video"
    (None without imageio or with --no_vid), "accel": None | (mode, frame-0
    PSNR or None)}, ...], "rays": (F * H * W, 8)}``; exits with status 1
    when the input directory holds no ``*_normalize.png``."""
    from ..config.args import parse_args
    from ..device import resolve_device
    from ..models.pixelnerf import make_model
    from ..parallel.pipeline import RenderPipeline
    from ..render.renderer import NeRFRenderer
    from ..train import checkpoints
    from ..utils.jax_convert import load_pretrained_backbone
    from ..utils.png import write_png
    from .gen_video import write_video

    args, conf = parse_args(extra_args, default_expname="srn_car", default_data_format="srn",
                            argv=argv)
    args.resume = True
    device = resolve_device(args.device)

    z_near, z_far = args.z_near, args.z_far
    focal = np.float32(args.focal)
    sz = list(map(int, args.out_size.split()))
    if len(sz) == 1:
        H = W = sz[0]
    else:
        assert len(sz) == 2
        W, H = sz

    print("Generating rays")
    rays = spherical_rays(args.num_views, args.elevation, args.radius, W, H, focal, z_near, z_far)

    inputs_all = os.listdir(args.input) if os.path.isdir(args.input) else []
    inputs = [os.path.join(args.input, x) for x in inputs_all if x.endswith("_normalize.png")]
    os.makedirs(args.output, exist_ok=True)
    if len(inputs) == 0:
        if len(inputs_all) == 0:
            print("No input images found, please place an image into ./input")
        else:
            print("No processed input images found, did you run 'scripts/preproc.py'?")
        sys.exit(1)

    cam_pose = np.eye(4, dtype=np.float32)
    cam_pose[2, -1] = args.radius
    print("SET DUMMY CAMERA")
    print(cam_pose)

    net = make_model(conf["model"], mlp_impl=IMPLS[args.mlp_impl], device=device)
    if not os.path.exists(checkpoints.checkpoint_path(args)):
        load_pretrained_backbone(net, conf["model"])
    checkpoints.load_weights(args, net)
    renderer = NeRFRenderer.from_conf(conf["renderer"], eval_batch_size=args.ray_batch_size)
    pipeline = RenderPipeline(net, renderer)
    master = torch.Generator().manual_seed(0)  # one seed a render, drawn in order

    results = []
    for i, image_path in enumerate(inputs):
        print("IMAGE", i + 1, "of", len(inputs), "@", image_path)
        image = encoder_input(image_path, args.size)
        img = image.astype(np.float32) / 255.0 * 2.0 - 1.0  # [-1, 1]
        with torch.no_grad():
            scene = net.encode(torch.as_tensor(img[None, None], device=device),
                               torch.as_tensor(cam_pose[None, None], device=device),
                               torch.as_tensor(focal, device=device))

        accel = None
        if args.accel_mode != "off" and device.type != "cpu":
            auto = args.accel_mode == "auto"
            pipeline.set_accel_mode("proposal" if auto else args.accel_mode)
            pipeline.build_accel(scene, rays, ray_batch_size=RAY_BATCH)
            accel = (args.accel_mode, None) if pipeline.accel is not None else None
            if auto and pipeline.accel is not None:
                # frame-0 self-gate: dense and pruned from the same draws
                frame0 = rays[: H * W]
                seed = int(torch.randint(0, 2**62, (1,), generator=master))
                grid, chunk = pipeline.accel, pipeline.accel_chunk
                pipeline.accel = pipeline.accel_chunk = None
                rgb_d, _ = pipeline.render_simple(
                    scene, frame0, torch.Generator(device=device).manual_seed(seed),
                    ray_batch_size=RAY_BATCH)
                pipeline.accel, pipeline.accel_chunk = grid, chunk
                rgb_p, _ = pipeline.render_simple(
                    scene, frame0, torch.Generator(device=device).manual_seed(seed),
                    ray_batch_size=RAY_BATCH)
                mse = float(np.mean((rgb_p - rgb_d) ** 2))
                psnr = -10.0 * math.log10(max(mse, 1e-12))
                if psnr < 30.0:
                    pipeline.set_accel_mode("rays")
                    print(f"accel auto: proposal failed self-gate ({psnr:.1f} dB); using ray "
                          "compaction")
                    accel = ("rays", psnr)
                else:
                    print(f"accel auto: proposal passes self-gate ({psnr:.1f} dB)")
                    accel = ("proposal", psnr)
        print("Rendering", args.num_views * H * W, "rays")
        seed = int(torch.randint(0, 2**62, (1,), generator=master))
        rgb, _ = pipeline.render_simple(scene, rays, torch.Generator(device=device).manual_seed(seed),
                                        ray_batch_size=RAY_BATCH,
                                        pack="u8")  # frames are quantized by the writer anyway
        frames = (np.clip(rgb.reshape(args.num_views, H, W, 3), 0, 1) * 255).astype(np.uint8)

        im_name = os.path.basename(os.path.splitext(image_path)[0])
        frame_dir = os.path.join(args.output, im_name + "_frames")
        os.makedirs(frame_dir, exist_ok=True)
        for fi in range(args.num_views):
            write_png(os.path.join(frame_dir, "{:04}.png".format(fi)), frames[fi])
        vid_path = None
        if not args.no_vid:
            vid_path = write_video(os.path.join(args.output, im_name + "_vid"), frames, args.fps,
                                   args.gif)
            if vid_path is not None:
                print("Wrote to", vid_path)
        results.append(dict(path=image_path, encoder_input=image, frames=frames,
                            frame_dir=frame_dir, video=vid_path, accel=accel))
    return {"inputs": results, "rays": rays}


if __name__ == "__main__":
    main()
