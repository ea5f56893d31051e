"""Approximate evaluation, on the card: one random target view per object,
the objects batched by the data loader:

    python -m pixelnerf_tpu_torch.eval.eval_approx -n <exp> -c conf/exp/<x>.conf -D <datadir> \\
        -F <format> [--split val] [-P "64"] [--batch_size 4] [--seed 1234] [--coarse] \\
        [--device cpu]

The counterpart of the repository's ``eval/eval_approx.py``, with its flags
and defaults: per batch, the source views (``-P``, or ``-1`` for one random
view an object) and a random non-source target view an object are drawn
from ``numpy.random.default_rng(--seed)`` in the root CLI's order, so both
CLIs pick the same views; each object is encoded and its target view
rendered, and the running and final PSNR / SSIM are printed.  Each object's
rays and encoder take its own focal and principal point (a row per view
where the views' differ), where the root CLI gives every object of a batch
the first object's focal and the image centre.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..train.cli import IMPLS


def extra_args(parser):
    parser.add_argument("--split", type=str, default="val", help="Split of data to use")
    parser.add_argument("--source", "-P", type=str, default="64",
                        help="Source view(s), increasing order. -1 for random 1 view")
    parser.add_argument("--batch_size", type=int, default=4, help="Batch size")
    parser.add_argument("--seed", type=int, default=1234, help="Seed for target view selection")
    parser.add_argument("--coarse", action="store_true", help="Coarse network as fine")
    parser.add_argument("--mlp_impl", type=str, default="auto", choices=tuple(IMPLS),
                        help="field implementation: 'auto' uses the CUDA kernels on the card and "
                        "plain torch elsewhere; 'pallas'/'cuda' forces the kernels; 'xla'/'torch' "
                        "the plain field")
    return parser


def main(argv=None) -> dict:
    """Run the evaluation.  Returns ``{"objects": [(path, source views,
    target view, psnr, ssim), ...], "psnr", "ssim": the final means,
    "cnt"}``."""
    from ..config.args import parse_args
    from ..data import DataLoader, get_split_dataset
    from ..device import resolve_device
    from ..models.pixelnerf import make_model
    from ..parallel.pipeline import RenderPipeline
    from ..render.renderer import NeRFRenderer
    from ..train import checkpoints
    from ..utils import geometry, metrics
    from ..utils.jax_convert import load_pretrained_backbone

    args, conf = parse_args(extra_args, argv=argv)
    args.resume = True
    device = resolve_device(args.device)

    dset = get_split_dataset(args.dataset_format, args.datadir, want_split=args.split,
                             training=False)
    loader = DataLoader(dset, batch_size=args.batch_size, shuffle=False)

    net = make_model(conf["model"], mlp_impl=IMPLS[args.mlp_impl], device=device)
    if not os.path.exists(checkpoints.checkpoint_path(args)):
        load_pretrained_backbone(net, conf["model"])
    checkpoints.load_weights(args, net)
    renderer = NeRFRenderer.from_conf(conf["renderer"], eval_batch_size=args.ray_batch_size)
    if renderer.n_coarse < 64:
        renderer.n_coarse = 64
    if args.coarse:
        renderer.n_coarse = 64
        renderer.n_fine = 0
    pipeline = RenderPipeline(net, renderer)

    z_near, z_far = dset.z_near, dset.z_far
    rng = np.random.default_rng(args.seed)
    # one generator split per object, as the root CLI splits its key
    master = torch.Generator().manual_seed(args.seed)
    source = np.array(list(map(int, args.source.split())), dtype=np.int64)
    NS = len(source)
    random_source = NS == 1 and source[0] == -1

    total_psnr = total_ssim = 0.0
    objects = []
    for data in loader:
        images = data["images"]  # (SB, NV, H, W, 3)
        poses = data["poses"]
        SB, NV, H, W, _ = images.shape
        if random_source:
            src_view = rng.integers(0, NV, (SB, 1))
        else:
            if (source < 0).any() or (source >= NV).any():
                raise SystemExit(f"source view(s) {source.tolist()} out of range for a {NV}-view "
                                 f"dataset; pass -P with views in [0, {NV})")
            src_view = np.broadcast_to(source[None], (SB, NS)).copy()
        # a random non-source target view an object
        dest_view = rng.integers(0, NV - NS, (SB, 1))
        for i in range(NS):
            dest_view += dest_view >= src_view[:, i:i + 1]

        for sb in range(SB):
            focal = np.asarray(data["focal"][sb], np.float32)
            c = np.asarray(data["c"][sb], np.float32) if "c" in data else None
            src, dest = src_view[sb], dest_view[sb]
            rays = geometry.gen_rays_np(
                poses[sb, dest], W, H, geometry.view_rows(focal, dest), z_near, z_far,
                c=geometry.view_rows(c, dest) if c is not None else None).reshape(-1, 8)
            with torch.no_grad():
                scene = net.encode(
                    torch.as_tensor(images[sb, src][None], device=device),
                    torch.as_tensor(poses[sb, src][None], device=device),
                    torch.as_tensor(geometry.view_rows(focal, src), device=device),
                    c=(torch.as_tensor(geometry.view_rows(c, src), device=device)
                       if c is not None else None))
            gen = torch.Generator(device=device).manual_seed(
                int(torch.randint(0, 2**62, (1,), generator=master)))
            rgb, _ = pipeline.render_simple(scene, rays, gen, ray_batch_size=args.ray_batch_size)
            rgb = np.clip(rgb.reshape(H, W, 3), 0.0, 1.0)
            gt = images[sb, dest[0]] * 0.5 + 0.5
            ssim = metrics.ssim(rgb, gt, data_range=1.0)
            psnr = metrics.psnr(rgb, gt)
            total_ssim += ssim
            total_psnr += psnr
            objects.append((data["path"][sb], src.tolist(), int(dest[0]), psnr, ssim))
        cnt = len(objects)
        print("curr psnr", total_psnr / cnt, "ssim", total_ssim / cnt)
    cnt = len(objects)
    psnr, ssim = (total_psnr / cnt, total_ssim / cnt) if cnt else (float("nan"), float("nan"))
    print("final psnr", psnr, "ssim", ssim)
    return {"objects": objects, "psnr": psnr, "ssim": ssim, "cnt": cnt}


if __name__ == "__main__":
    main()
