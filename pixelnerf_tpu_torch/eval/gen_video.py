"""Render a novel-view video of one object, on the card:

    python -m pixelnerf_tpu_torch.eval.gen_video -n <exp> -c conf/exp/<x>.conf -D <datadir> \\
        -F <format> -S <subset> [--split test] -P "<source view ids>" [--num_views 40] \\
        [--elevation -10] [--scale 1.0] [--radius 0.0] [--fps 30] [-R <ray batch>] \\
        [--no_accel | --accel_mode auto|rays|proposal|samples] [--device cpu]

The counterpart of the repository's ``eval/gen_video.py``, with its flags and
defaults: a ring of ``pose_spherical`` poses around the object (the DTU
spline path on ``dvr_dtu`` data), the source views encoded, and every frame
rendered in the u8 wire format.  On the card the render is pruned by an
occupancy grid built over every frame's rays; ``--accel_mode auto`` (the
default) starts at ``proposal`` and walks the quality gate on frame 0 (seed
7) before it renders, ``--no_accel`` composites every sample.  A CPU device
renders dense, as the root CLI does.

Writes ``<visual_path>/<name>/video<t|v>NNNN_vNNN...``: each frame as a PNG
under ``..._frames/``, the source views side by side as ``..._view.png``
(the port's PNG writer), and the ``.mp4`` (or a ``.gif`` without ffmpeg)
only when ``imageio`` imports.

Several ``--gpu_id``s render on one rank each (``parallel.launch``; a
repeated id shares a card): every chunk of rays is split over a ray mesh of
the ranks, and rank 0 writes the files.
"""

from __future__ import annotations

import os
import sys
import warnings

import numpy as np
import torch

from ..train.cli import IMPLS


def extra_args(parser):
    parser.add_argument("--subset", "-S", type=int, default=0, help="Subset in data to use")
    parser.add_argument("--split", type=str, default="train",
                        help="Split of data to use train | val | test")
    parser.add_argument("--source", "-P", type=str, default="64",
                        help="Source view(s) in image, in increasing order. -1 to do random")
    parser.add_argument("--num_views", type=int, default=40,
                        help="Number of video frames (rotated views)")
    parser.add_argument("--elevation", type=float, default=-10.0,
                        help="Elevation angle (negative is above)")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="Video scale relative to input size")
    parser.add_argument("--radius", type=float, default=0.0,
                        help="Distance of camera from origin, default is average of z_far, z_near")
    parser.add_argument("--fps", type=int, default=30, help="FPS of video")
    parser.add_argument("--mlp_impl", type=str, default="auto", choices=tuple(IMPLS),
                        help="field implementation: 'auto' uses the CUDA kernels on the card and "
                        "plain torch elsewhere; 'pallas'/'cuda' forces the kernels; 'xla'/'torch' "
                        "the plain field")
    parser.add_argument("--no_accel", action="store_true",
                        help="Disable the per-scene occupancy-grid pruning and composite every "
                        "sample like the reference")
    parser.add_argument("--accel_mode", type=str, default="auto",
                        choices=["auto", "rays", "proposal", "samples"],
                        help="Occupancy-pruning strategy: 'auto' (default) tries 'proposal' and "
                        "self-gates it on frame 0 (dense against pruned; below 30 dB it steps "
                        "down proposal+8, proposal+16, rays, dense); 'rays' skips verified-empty "
                        "rays, 'proposal' forces grid-guided importance sampling in place of the "
                        "coarse pass (ungated), 'samples' compacts single samples")
    return parser


def dtu_spline_poses(num_views: int) -> np.ndarray:
    """The DTU camera path: a periodic cubic spline through five keyframe
    quaternions (from IDR) at a fixed distance 2, ``(num_views // 5) * 6``
    poses (B, 4, 4) float32."""
    from scipy.interpolate import CubicSpline

    from ..utils.geometry import quat_to_rot

    t_in = np.array([0, 2, 3, 5, 6], dtype=np.float32)
    pose_quat = np.array([
        [0.9698, 0.2121, 0.1203, -0.0039],
        [0.7020, 0.1578, 0.4525, 0.5268],
        [0.6766, 0.3176, 0.5179, 0.4161],
        [0.9085, 0.4020, 0.1139, -0.0025],
        [0.9698, 0.2121, 0.1203, -0.0039],
    ], dtype=np.float32)
    n_inter = max(num_views // 5, 1)
    t_out = np.linspace(t_in[0], t_in[-1], n_inter * int(t_in[-1])).astype(np.float32)
    scales = np.full(5, 2.0, dtype=np.float32)
    s_new = CubicSpline(t_in, scales, bc_type="periodic")(t_out)
    q_new = CubicSpline(t_in, pose_quat, bc_type="periodic")(t_out)
    q_new = q_new / np.linalg.norm(q_new, axis=1, keepdims=True)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(t_out), 1, 1))
    for pose, quat, scale in zip(poses, q_new, s_new):
        R = quat_to_rot(quat[None])[0]
        pose[:3, :3] = R
        pose[:3, 3] = R[:, 2] * scale
    return poses


def write_video(stem: str, frames: np.ndarray, fps: int, gif: bool = False):
    """``stem.mp4`` (``stem.gif`` when asked or without ffmpeg) of (F, H, W,
    3) uint8 frames through ``imageio``; None when ``imageio`` is not
    installed."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        print("imageio is not installed: the frames are the output")
        return None
    if not gif:
        try:
            imageio.mimwrite(stem + ".mp4", frames, fps=fps, quality=8)
            return stem + ".mp4"
        except Exception as e:  # no ffmpeg -> a gif
            warnings.warn(f"mp4 write failed ({e}); writing gif instead")
    imageio.mimwrite(stem + ".gif", frames, duration=1000.0 / fps)
    return stem + ".gif"


def main(argv=None) -> dict:
    """Render the video.  Returns ``{"frames": (F, H, W, 3) uint8,
    "frame_dir", "view", "video" (None without imageio), "accel": None |
    (settled rung, {rung: PSNR}) | the forced mode}``."""
    from ..config.args import parse_args
    from ..data import get_split_dataset
    from ..device import resolve_device
    from ..models.pixelnerf import make_model
    from ..parallel import launch
    from ..parallel.mesh import make_ray_mesh
    from ..parallel.pipeline import RenderPipeline
    from ..render.renderer import NeRFRenderer
    from ..train import checkpoints
    from ..utils import geometry
    from ..utils.jax_convert import load_pretrained_backbone
    from ..utils.png import write_png

    argv = sys.argv[1:] if argv is None else list(argv)
    args, conf = parse_args(extra_args, argv=argv)
    if args.spawn_ranks:
        return launch.spawn(main, args.gpu_id, torch.device(args.device).type, argv)
    args.resume = True
    device = resolve_device(args.device)

    dset = get_split_dataset(args.dataset_format, args.datadir, want_split=args.split,
                             training=False)
    data = dset[args.subset]
    print("Data instance loaded:", data["path"])
    images = data["images"]  # (NV, H, W, 3) in [-1, 1]
    poses = data["poses"]
    focal = np.asarray(data["focal"], dtype=np.float32)
    c = data.get("c")
    NV, H, W, _ = images.shape
    if args.scale != 1.0:
        Ht, Wt = int(H * args.scale), int(W * args.scale)
        if abs(Ht / args.scale - H) > 1e-10 or abs(Wt / args.scale - W) > 1e-10:
            warnings.warn(f"Inexact scaling, please check {args.scale} times ({H}, {W}) "
                          "is integral")
        H, W = Ht, Wt

    source = np.array(list(map(int, args.source.split())), dtype=np.int64)
    assert not (source >= NV).any()
    if len(source) == 1 and source[0] == -1:
        src_view = launch.broadcast_object(np.random.default_rng().integers(0, NV, (1,)))
    else:
        src_view = source

    net = make_model(conf["model"], mlp_impl=IMPLS[args.mlp_impl], device=device)
    if not os.path.exists(checkpoints.checkpoint_path(args)):
        load_pretrained_backbone(net, conf["model"])
    checkpoints.load_weights(args, net)
    renderer = NeRFRenderer.from_conf(conf["renderer"], lindisp=dset.lindisp,
                                      eval_batch_size=args.ray_batch_size)
    # a decent sampling resolution for video
    if renderer.n_coarse < 64:
        renderer.n_coarse = 64
        renderer.n_fine = 128

    z_near, z_far = dset.z_near, dset.z_far
    print("Generating rays")
    if getattr(dset, "sub_format", None) == "dtu":
        print("Using DTU camera trajectory")
        render_poses = dtu_spline_poses(args.num_views)
        args.num_views = render_poses.shape[0]
    else:
        print("Using default (360 loop) camera trajectory")
        radius = args.radius
        if radius == 0.0:
            radius = (z_near + z_far) * 0.5
            print("> Using default camera radius", radius)
        render_poses = np.stack([geometry.pose_spherical(angle, args.elevation, radius)
                                 for angle in np.linspace(-180, 180, args.num_views + 1)[:-1]])
    # the frames take the first source view's intrinsics where they differ by view
    render_focal = geometry.view_rows(focal, src_view[0])
    render_c = geometry.view_rows(c, src_view[0]) if c is not None else None
    rays = geometry.gen_rays_np(
        render_poses, W, H, np.asarray(render_focal, np.float32) * args.scale, z_near, z_far,
        c=np.asarray(render_c, np.float32) * args.scale if render_c is not None else None,
    ).reshape(-1, 8)

    print("Encoding source view(s)")
    with torch.no_grad():
        scene = net.encode(
            torch.as_tensor(images[src_view][None], device=device),
            torch.as_tensor(poses[src_view][None], device=device),
            torch.as_tensor(geometry.view_rows(focal, src_view), device=device),
            c=(torch.as_tensor(geometry.view_rows(c, src_view), device=device)
               if c is not None else None))
    n_ranks = launch.world_size()
    pipeline = RenderPipeline(net, renderer, mesh=make_ray_mesh(n_ranks) if n_ranks > 1 else None)

    # one grid over every frame's rays; the CPU renders dense (the build is
    # a large field-probe pass that only pays off at the card's rates)
    accel = None
    if not args.no_accel and device.type != "cpu":
        auto = args.accel_mode == "auto"
        pipeline.set_accel_mode("proposal" if auto else args.accel_mode)
        pipeline.build_accel(scene, rays, ray_batch_size=args.ray_batch_size)
        accel = args.accel_mode
        if auto and pipeline.accel is not None:
            label, psnrs = pipeline.gate_accel_mode(scene, rays[: H * W], 7,
                                                    ray_batch_size=args.ray_batch_size)
            trail = ", ".join(f"{k} {v:.1f} dB" for k, v in psnrs.items())
            print(f"accel auto: self-gate settled on {label} ({trail})")
            accel = (label, psnrs)

    print("Rendering", args.num_views * H * W, "rays")
    rgb, _ = pipeline.render_simple(scene, rays, torch.Generator(device=device).manual_seed(1),
                                    ray_batch_size=args.ray_batch_size, pack="u8")
    frames = np.clip(np.asarray(rgb).reshape(-1, H, W, 3), 0.0, 1.0)
    frames_u8 = (frames * 255).astype(np.uint8)

    print("Writing video")
    vid_name = "{:04}".format(args.subset)
    if args.split == "test":
        vid_name = "t" + vid_name
    elif args.split == "val":
        vid_name = "v" + vid_name
    vid_name += "_v" + "_".join("{:03}".format(int(x)) for x in src_view)
    out_dir = os.path.join(args.visual_path, args.name)
    frame_dir = os.path.join(out_dir, "video" + vid_name + "_frames")
    view_path = os.path.join(out_dir, "video" + vid_name + "_view.png")
    vid_path = None
    if launch.is_main():
        os.makedirs(frame_dir, exist_ok=True)
        for i, frame in enumerate(frames_u8):
            write_png(os.path.join(frame_dir, "{:04}.png".format(i)), frame)
        write_png(view_path,
                  np.hstack(list(((images[src_view] * 0.5 + 0.5) * 255).astype(np.uint8))))
        vid_path = write_video(os.path.join(out_dir, "video" + vid_name), frames_u8, args.fps)
        print("Wrote to", vid_path or frame_dir, "view:", view_path)
    launch.barrier()
    return {"frames": frames_u8, "frame_dir": frame_dir, "view": view_path, "video": vid_path,
            "accel": accel}


if __name__ == "__main__":
    main()
