"""Training entry point: ``python -m pixelnerf_tpu_torch.train``, or
``pixelnerf_tpu_torch.train.main(argv)`` in-process.

The JAX package's ``train/train.py`` on the card:

    python -m pixelnerf_tpu_torch.train -n <exp> -c conf/exp/<x>.conf -F synthetic \\
        [-B 4] [-V 1] [--epochs N] [-R 128] [--resume] [--profile_dir D] [--device cpu]

The same flags and defaults; ``--mlp_impl`` takes the JAX names
``auto | pallas | xla`` (or ``auto | cuda | torch``), and the model is built
with ``diff_mode=True`` so the field's inputs stay dense and its backward is
the hand-written kernel on the card.  The encoder follows the backbone
contract of ``utils.jax_convert.load_pretrained_backbone``.  At the end the
weights are written to ``pixel_nerf_latest``.

Every ``train.vis_interval`` epochs :class:`PixelNeRFTrainer` renders one
held-out view of the first test batch from one source view (``--fixed_test``:
source 0, target 1) and writes the root CLI's grid, one row per head:
``[source | ground truth | depth | rgb | alpha]``.

Several ``--gpu_id``s train on one rank each (``parallel.launch``; a
repeated id shares a card) over the root CLI's mesh: data = gcd(ranks,
``-B``) ranks split the object batch, rays = ranks / data split each
object's rays, and ``-R`` is rounded up to a multiple of rays.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from ..parallel import launch
from ..parallel.mesh import make_train_mesh
from ..parallel.pipeline import RenderPipeline
from ..utils import geometry, metrics
from .trainer import Trainer

IMPLS = {"auto": "auto", "pallas": "cuda", "xla": "torch", "cuda": "cuda", "torch": "torch"}


def extra_args(parser):
    parser.add_argument("--batch_size", "-B", type=int, default=4, help="Object batch size ('SB')")
    parser.add_argument("--nviews", "-V", type=str, default="1",
                        help="Number of source views; '1 2' to use 1 or 2 at random")
    parser.add_argument("--freeze_enc", action="store_true", default=None,
                        help="Freeze encoder weights and only train the MLP")
    parser.add_argument("--no_bbox_step", type=int, default=100000,
                        help="Step to stop using bbox sampling")
    parser.add_argument("--fixed_test", action="store_true", default=None,
                        help="Freeze the test view for visualization")
    parser.add_argument("--use_amp", action="store_true", default=None)
    parser.add_argument("--no_amp", action="store_true", default=None)
    parser.add_argument("--check_gradients", action="store_true", default=None)
    parser.add_argument("--grad_clip", type=float, default=1.0)
    parser.add_argument("--debug_nans", action="store_true", default=None,
                        help="torch.autograd anomaly detection (NaN sanitizer)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace (host and card) of train steps 3-5 "
                        "to <profile_dir>/trace.json (chrome trace format)")
    parser.add_argument("--mlp_impl", type=str, default="auto", choices=tuple(IMPLS),
                        help="field implementation: 'auto' uses the CUDA kernels (forward and "
                        "backward) on the card and plain torch elsewhere; 'pallas'/'cuda' "
                        "forces the kernels; 'xla'/'torch' the plain field")
    return parser


def vis_render(net, renderer, images: np.ndarray, poses: np.ndarray, focal, c, src_view,
               target: int, z_near: float, z_far: float, seed: int, ray_batch_size: int,
               draws=None) -> dict:
    """Render view ``target`` of one object from its views ``src_view``:
    ``RenderPipeline.render`` with weights, a generator seeded ``seed``
    (``draws`` in its place).  Under ``torch.no_grad`` the model takes its
    eval routes (the fused gather, the deferred code), also when built for
    training.

    :param images: (NV, H, W, 3) in [-1, 1]; ``poses`` (NV, 4, 4)
    :param focal, c: shared, or one row per view (NV, 2)
    """
    dev = next(net.parameters()).device
    H, W = images.shape[1:3]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def rows(x, views):
        return None if x is None else geometry.view_rows(x, views)

    rays = geometry.gen_rays_np(poses[target:target + 1], W, H, rows(focal, [target]), z_near,
                                z_far, c=rows(c, [target])).reshape(-1, 8)
    with torch.no_grad(), net.eval_routes():
        scene = net.encode(put(images[src_view][None]), put(poses[src_view][None]),
                           put(rows(focal, src_view)),
                           c=None if c is None else put(rows(c, src_view)))
        return RenderPipeline(net, renderer).render(
            scene, rays, torch.Generator(device=dev).manual_seed(seed),
            ray_batch_size=ray_batch_size, want_weights=True, draws=draws)


def vis_grid(out: dict, images: np.ndarray, src_view, target: int):
    """The root CLI's vis grid: a row ``[src | gt | cmap(depth) | rgb |
    cmap(alpha)]`` a head -> (uint8 (heads * H, 5 * W, 3), PSNR of the last
    head's rgb against the target)."""
    H, W = images.shape[1:3]
    gt = images[target] * 0.5 + 0.5
    src = images[src_view[0]] * 0.5 + 0.5

    def row(head):
        rgb = np.clip(head["rgb"].reshape(H, W, 3), 0, 1)
        depth = metrics.cmap(head["depth"].reshape(H, W)).astype(np.float32) / 255.0
        alpha = metrics.cmap(head["weights"].reshape(H, W, -1).sum(-1)).astype(np.float32) / 255.0
        return np.hstack([src, gt, depth, rgb, alpha]), rgb

    rows = [row(out["coarse"])] + ([row(out["fine"])] if "fine" in out else [])
    grid = np.vstack([r[0] for r in rows])
    return (grid * 255).astype(np.uint8), metrics.psnr(rows[-1][1], gt)


class PixelNeRFTrainer(Trainer):
    """The train CLI's trainer: :class:`Trainer` with the vis grid."""

    def vis_step(self, data):
        """The grid of the batch's first object: source view 0 and target 1
        under ``--fixed_test``, else the ends of a permutation drawn from the
        trainer's rng."""
        images, poses = data["images"][0], data["poses"][0]
        c = data.get("c")
        if getattr(self.args, "fixed_test", False):
            src_view, target = np.array([0]), min(1, images.shape[0] - 1)
        else:
            perm = self.rng.permutation(images.shape[0])
            src_view, target = perm[:1], int(perm[-1])
        out = vis_render(self.net, self.renderer, images, poses, np.asarray(data["focal"][0]),
                         None if c is None else np.asarray(c[0]), src_view, target, self.z_near,
                         self.z_far, int(self.global_step), self.args.ray_batch_size * 16)
        return vis_grid(out, images, src_view, target)


def mesh_choice(n_dev: int, batch_size: int, ray_batch_size: int, platform: str):
    """The root CLI's training mesh over ``n_dev`` ranks: the object batch
    over data = gcd(n_dev, ``-B``) ranks, each object's rays over the rays =
    n_dev / data left, ``-R`` rounded up to a multiple of rays -> (data,
    ``-R``, the lines the CLI prints)."""
    dp = math.gcd(n_dev, batch_size)
    rp = n_dev // dp
    lines = []
    if ray_batch_size % rp != 0:
        ray_batch_size = -(-ray_batch_size // rp) * rp
        lines.append(f"NOTE: ray_batch_size rounded up to {ray_batch_size} "
                     f"(multiple of rays axis {rp})")
    lines.append(f"Training mesh: data={dp} x rays={rp} over {n_dev} {platform} device(s)")
    return dp, ray_batch_size, lines


def main(argv=None):
    from ..config.args import parse_args
    from ..data import get_split_dataset
    from ..device import resolve_device
    from ..models.pixelnerf import make_model
    from ..render.renderer import NeRFRenderer
    from . import checkpoints
    from ..utils.jax_convert import load_pretrained_backbone

    argv = sys.argv[1:] if argv is None else list(argv)
    args, conf = parse_args(extra_args, training=True, default_ray_batch_size=128, argv=argv)
    if args.spawn_ranks:
        launch.spawn(_main_in_rank, args.gpu_id, torch.device(args.device).type, argv)
        return None
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
        print("NaN debugging enabled (autograd anomaly detection)")
    use_amp = conf.get_bool("train.use_amp", True)
    if args.use_amp:
        use_amp = True
    if args.no_amp:
        use_amp = False
    args.use_amp = use_amp
    device = resolve_device(args.device)

    dset, val_dset, _ = get_split_dataset(args.dataset_format, args.datadir)
    print(f"dset z_near {dset.z_near}, z_far {dset.z_far}, lindisp {dset.lindisp}")
    net = make_model(conf["model"], mlp_impl=IMPLS[args.mlp_impl], device=device,
                     generator=torch.Generator().manual_seed(0),
                     stop_encoder_grad=bool(args.freeze_enc), diff_mode=True)
    renderer = NeRFRenderer.from_conf(conf["renderer"], lindisp=dset.lindisp,
                                      eval_batch_size=args.ray_batch_size)
    # pretrained backbone first, unless a resumed checkpoint overwrites it
    managed_latest = os.path.join(args.checkpoints_path, args.name, "latest.ckpt")
    if not (args.resume and (os.path.exists(checkpoints.checkpoint_path(args))
                             or os.path.exists(managed_latest))):
        load_pretrained_backbone(net, conf["model"])
    checkpoints.load_weights(args, net, opt_init=True)

    mesh = None
    n_dev = launch.world_size()
    if n_dev > 1:
        dp, args.ray_batch_size, lines = mesh_choice(n_dev, args.batch_size,
                                                     args.ray_batch_size, device.type)
        print("\n".join(lines))
        mesh = make_train_mesh(n_dev, data_parallel=dp)

    trainer = PixelNeRFTrainer(net, dset, val_dset, renderer, args, conf, mesh=mesh)
    trainer.start()
    if launch.is_main():
        checkpoints.save_weights(args, net)
    launch.barrier()
    return trainer


def _main_in_rank(argv) -> None:
    """One rank of a several-id run (``launch.spawn``'s target); its event
    writer is closed before the process ends."""
    trainer = main(argv)
    if trainer.writer is not None:
        trainer.writer.close()

