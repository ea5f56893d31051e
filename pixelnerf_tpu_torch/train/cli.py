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
"""

from __future__ import annotations

import os

import torch

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


def main(argv=None):
    from ..config.args import parse_args
    from ..data import get_split_dataset
    from ..device import resolve_device
    from ..models.pixelnerf import make_model
    from ..render.renderer import NeRFRenderer
    from . import checkpoints
    from .trainer import Trainer
    from ..utils.jax_convert import load_pretrained_backbone

    args, conf = parse_args(extra_args, training=True, default_ray_batch_size=128, argv=argv)
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

    trainer = Trainer(net, dset, val_dset, renderer, args, conf)
    trainer.start()
    checkpoints.save_weights(args, net)
    return trainer

