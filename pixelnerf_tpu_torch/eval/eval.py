"""Quantitative evaluation over a dataset split, on the card:

    python -m pixelnerf_tpu_torch.eval.eval -n <exp> -c conf/exp/<x>.conf -F synthetic \\
        --split test -P "0" [-O eval_out] [--max_objs N] [--device cpu]

The counterpart of the repository's ``eval/eval.py``, with its flags and
defaults: per object, the source views of a fixed ``-P`` list or of the
``-L`` viewlist, a render of every target view (``--eval_view_list`` picks
them; ``--include_src`` keeps the source views), PSNR and SSIM against the
ground truth, a PNG per view (and a side-by-side with ``--write_compare``),
and the ``finish.txt`` journal, one ``name psnr ssim 1`` line per object,
from which a second run resumes.  Weights come from
``<checkpoints_path>/<name>/pixel_nerf_latest``; without that file the model
keeps its seeded init, with the backbone under the pretrained-weights
contract.  ``--mlp_impl`` takes the JAX names (``auto | pallas | xla``) or
``auto | cuda | torch``.  ``PIXELNERF_DEFER_CODE=1`` renders through the
forward kernels' in-register positional code.

``--scale`` renders at a multiple of the data's resolution; the
ground-truth compare then resizes the ground truth to the render by area, as
``eval/eval.py`` does with OpenCV.  A focal or principal point with a row per
view (the DVR adapter's (NV, 2) when views differ) gives the encoder the
source views' rows and each target view's rays its own row.

``--accel rays|proposal`` builds an occupancy grid per object over its
target views' rays (``--accel_build fast``: 64^3 voxels and one probe
direction; ``full``: 96^3 and four) and, unless ``--no_accel_gate``, walks
the quality gate on the first target view (seed 11) before it renders.  On
a CPU device the accel is ignored, with a warning, unless
``PIXELNERF_ACCEL_CPU_OK=1``; on the card it always runs when asked.

``--write_depth`` writes each view's depth, normalized as ``(d - z_near) /
(z_far - z_near)``, as ``<view>_depth.npy`` (what the root CLI writes when
its OpenCV has no EXR) and as ``<view>_depth_norm.png`` in the HOT colormap.

Several ``--gpu_id``s render on one rank each (``parallel.launch``; a
repeated id shares a card): every chunk of rays is split over a ray mesh of
the ranks, every rank computes the metrics, and rank 0 alone writes the
images and the journal.
"""

from __future__ import annotations

import os
import sys
import warnings

import numpy as np
import torch

from ..train.cli import IMPLS


def extra_args(parser):
    parser.add_argument("--split", type=str, default="test", help="Split of data to use")
    parser.add_argument("--source", "-P", type=str, default="64",
                        help="Source view(s) for each object; or use -L viewlist")
    parser.add_argument("--eval_view_list", type=str, default=None, help="Path to eval view list")
    parser.add_argument("--coarse", action="store_true", help="Coarse network as fine")
    parser.add_argument("--no_compare_gt", action="store_true",
                        help="Skip GT comparison and only render images")
    parser.add_argument("--multicat", action="store_true",
                        help="Prepend category id to object id (multi-category models)")
    parser.add_argument("--viewlist", "-L", type=str, default="",
                        help="Path to source view list e.g. src_dvr.txt; overrides -P")
    parser.add_argument("--output", "-O", type=str, default="eval", help="Output directory")
    parser.add_argument("--include_src", action="store_true",
                        help="Include source views in calculation")
    parser.add_argument("--scale", type=float, default=1.0, help="Render scale relative to input")
    parser.add_argument("--write_depth", action="store_true",
                        help="Write depth image (.npy and a HOT-colormap PNG)")
    parser.add_argument("--write_compare", action="store_true", help="Write GT comparison image")
    parser.add_argument("--free_pose", action="store_true",
                        help="Poses may change between objects (regenerate rays per object)")
    parser.add_argument("--max_objs", type=int, default=0,
                        help="Evaluate at most this many objects (0 = all)")
    parser.add_argument("--mlp_impl", type=str, default="auto", choices=tuple(IMPLS),
                        help="field implementation: 'auto' uses the CUDA kernels on the card and "
                        "plain torch elsewhere; 'pallas'/'cuda' forces the kernels; 'xla'/'torch' "
                        "the plain field")
    parser.add_argument("--accel", type=str, default="off", choices=["off", "rays", "proposal"],
                        help="occupancy-grid pruning: 'rays' skips verified-empty rays, "
                        "'proposal' also samples the fine pass from the grid in place of the "
                        "coarse field pass (fine head only); 'off' composites every sample")
    parser.add_argument("--accel_build", type=str, default="fast", choices=["fast", "full"],
                        help="per-object grid-build budget: 'fast' 64^3 voxels under one view "
                        "direction, 'full' 96^3 under four")
    parser.add_argument("--no_accel_gate", action="store_true",
                        help="skip the per-object self-gate (the first target view rendered "
                        "dense and pruned; below 30 dB it walks proposal -> proposal+8 -> "
                        "proposal+16 -> rays -> dense)")
    return parser


def _read_finished(path: str):
    """(object names, psnr sum, ssim sum, count) of a finish.txt journal."""
    with open(path) as f:
        lines = [x.strip().split() for x in f.readlines()]
    lines = [x for x in lines if len(x) == 4]
    return ({x[0] for x in lines}, sum(float(x[1]) for x in lines),
            sum(float(x[2]) for x in lines), sum(int(x[3]) for x in lines))


def main(argv=None) -> dict:
    """Run the evaluation.  Returns ``{"objects": [(name, psnr, ssim), ...]``
    for the objects rendered by this call, ``"psnr"``, ``"ssim"``: the running
    means over the journal, ``"cnt"``: its object count, and ``"gates"``:
    ``[(name, settled rung, {rung: PSNR}), ...]`` of the accel gates run}."""
    from ..config.args import parse_args
    from ..data import get_split_dataset
    from ..data.resize import resize_area
    from ..device import resolve_device
    from ..models.pixelnerf import make_model
    from ..parallel import launch
    from ..parallel.mesh import make_ray_mesh
    from ..parallel.pipeline import RenderPipeline
    from ..render.renderer import NeRFRenderer
    from ..train import checkpoints
    from ..utils import geometry, metrics
    from ..utils.jax_convert import load_pretrained_backbone
    from ..utils.png import write_png

    argv = sys.argv[1:] if argv is None else list(argv)
    args, conf = parse_args(extra_args, argv=argv)
    if args.coarse and args.accel == "proposal":
        raise SystemExit("--accel proposal renders only the fine head; "
                         "it cannot be combined with --coarse")
    if args.spawn_ranks:
        return launch.spawn(main, args.gpu_id, torch.device(args.device).type, argv)
    args.resume = True
    device = resolve_device(args.device)
    use_accel = args.accel != "off"
    if (use_accel and device.type == "cpu"
            and os.environ.get("PIXELNERF_ACCEL_CPU_OK", "0") != "1"):
        print(f"WARNING: --accel {args.accel} ignored on the CPU backend (the grid build is a "
              "large field-probe pass that only pays off at accelerator rates); evaluating dense")
        use_accel = False

    dset = get_split_dataset(args.dataset_format, args.datadir, want_split=args.split,
                             training=False)
    output_dir = args.output.strip()
    # every rank reads the journal; rank 0 alone writes
    has_output = len(output_dir) > 0
    writes = has_output and launch.is_main()

    total_psnr, total_ssim, cnt = 0.0, 0.0, 0
    finished = set()
    finish_file = None
    if has_output:
        os.makedirs(output_dir, exist_ok=True)
        finish_path = os.path.join(output_dir, "finish.txt")
        if os.path.exists(finish_path):
            finished, total_psnr, total_ssim, cnt = _read_finished(finish_path)
            if cnt > 0:
                print("resume psnr", total_psnr / cnt, "ssim", total_ssim / cnt)
            else:
                total_psnr = total_ssim = 0.0
        launch.barrier()  # every rank has read the journal before rank 0 appends
        if writes:
            finish_file = open(finish_path, "a", buffering=1)
        print("Writing images to", output_dir)
    try:
        renderer = NeRFRenderer.from_conf(conf["renderer"], lindisp=dset.lindisp,
                                          eval_batch_size=args.ray_batch_size)
        if renderer.n_coarse < 64:
            renderer.n_coarse = 64
        if args.coarse:
            renderer.n_coarse = 64
            renderer.n_fine = 0  # coarse-only output
        z_near, z_far = dset.z_near, dset.z_far

        use_source_lut = len(args.viewlist) > 0
        if use_source_lut:
            print("Using views from list", args.viewlist)
            with open(args.viewlist) as f:
                tmp = [x.strip().split() for x in f.readlines()]
            source_lut = {x[0] + "/" + x[1]: np.array(list(map(int, x[2:])), dtype=np.int64)
                          for x in tmp}
            source = None
        else:
            source = np.array(sorted(map(int, args.source.split())), dtype=np.int64)

        NV = dset[0]["images"].shape[0]
        if args.eval_view_list is not None:
            with open(args.eval_view_list) as f:
                eval_views = np.array(list(map(int, f.readline().split())))
            target_view_mask_init = np.zeros(NV, dtype=bool)
            target_view_mask_init[eval_views] = True
        else:
            target_view_mask_init = np.ones(NV, dtype=bool)

        net = pipeline = None
        all_rays = novel_view_idxs = src_view_mask = target_view_mask = None
        total_objs = len(dset)
        # one generator split per rendered object, as the JAX CLI splits its key
        master = torch.Generator().manual_seed(0)
        rendered, gates = [], []

        for obj_idx in range(total_objs):
            if args.max_objs > 0 and obj_idx >= args.max_objs:
                break
            data = dset[obj_idx]
            dpath = data["path"]
            obj_basename = os.path.basename(dpath)
            cat_name = os.path.basename(os.path.dirname(dpath))
            obj_name = cat_name + "_" + obj_basename if args.multicat else obj_basename
            print("OBJECT", obj_idx, "OF", total_objs, "PROGRESS", obj_idx / total_objs * 100.0,
                  "%", dpath)
            if has_output and obj_name in finished:
                print("(skip)")
                continue

            images = data["images"]  # (NV, H, W, 3)
            NV, H, W, _ = images.shape
            if args.scale != 1.0:
                Ht, Wt = int(H * args.scale), int(W * args.scale)
                if abs(Ht / args.scale - H) > 1e-10 or abs(Wt / args.scale - W) > 1e-10:
                    warnings.warn(f"Inexact scaling, please check {args.scale} x ({H},{W})")
                H, W = Ht, Wt
            focal = np.asarray(data["focal"], dtype=np.float32)
            c = data.get("c")
            poses = data["poses"]

            if all_rays is None or use_source_lut or args.free_pose:
                if use_source_lut:
                    source = source_lut[cat_name + "/" + obj_basename]
                src_view_mask = np.zeros(NV, dtype=bool)
                src_view_mask[source] = True
                target_view_mask = target_view_mask_init.copy()
                if not args.include_src:
                    target_view_mask &= ~src_view_mask
                novel_view_idxs = np.nonzero(target_view_mask)[0]
                all_rays = geometry.gen_rays_np(
                    poses[target_view_mask], W, H,
                    geometry.view_rows(focal, target_view_mask) * args.scale, z_near, z_far,
                    c=(geometry.view_rows(c, target_view_mask) * args.scale
                       if c is not None else None),
                ).reshape(-1, 8)

            n_gen_views = len(novel_view_idxs)
            if net is None:
                net = make_model(conf["model"], mlp_impl=IMPLS[args.mlp_impl], device=device)
                if not os.path.exists(checkpoints.checkpoint_path(args)):
                    load_pretrained_backbone(net, conf["model"])
                checkpoints.load_weights(args, net)
                n_ranks = launch.world_size()
                pipeline = RenderPipeline(net, renderer,
                                          mesh=make_ray_mesh(n_ranks) if n_ranks > 1 else None)
                if use_accel:
                    pipeline.set_accel_mode(args.accel)

            with torch.no_grad():
                scene = net.encode(
                    torch.as_tensor(images[src_view_mask][None], device=device),
                    torch.as_tensor(poses[src_view_mask][None], device=device),
                    torch.as_tensor(geometry.view_rows(focal, src_view_mask), device=device),
                    c=(torch.as_tensor(geometry.view_rows(c, src_view_mask), device=device)
                       if c is not None else None))
            obj_gen = torch.Generator(device=device).manual_seed(
                int(torch.randint(0, 2**62, (1,), generator=master)))
            if use_accel:
                # one grid a object over all its target views
                pipeline.set_accel_mode(args.accel)
                pipeline.build_accel(scene, all_rays, ray_batch_size=args.ray_batch_size,
                                     **(dict(resolution=64, n_dir_probes=1)
                                        if args.accel_build == "fast" else {}))
                if not args.no_accel_gate and pipeline.accel is not None:
                    label, psnrs = pipeline.gate_accel_mode(
                        scene, all_rays[: H * W], 11, ray_batch_size=args.ray_batch_size)
                    trail = ", ".join(f"{k} {v:.1f} dB" for k, v in psnrs.items())
                    print(f"  accel gate: {trail} -> {label}")
                    gates.append((obj_name, label, psnrs))
            all_rgb, all_depth = pipeline.render_simple(scene, all_rays, obj_gen,
                                                        ray_batch_size=args.ray_batch_size)
            all_depth = ((all_depth - z_near) / (z_far - z_near)).reshape(n_gen_views, H, W)
            all_rgb = np.clip(all_rgb.reshape(n_gen_views, H, W, 3), 0.0, 1.0)

            obj_out_dir = os.path.join(output_dir, obj_name)
            if writes:
                os.makedirs(obj_out_dir, exist_ok=True)
                for i in range(n_gen_views):
                    view = int(novel_view_idxs[i])
                    write_png(os.path.join(obj_out_dir, "{:06}.png".format(view)),
                              (all_rgb[i] * 255).astype(np.uint8))
                    if args.write_depth:
                        base = os.path.join(obj_out_dir, "{:06}".format(view))
                        np.save(base + "_depth.npy", all_depth[i])
                        write_png(base + "_depth_norm.png", metrics.cmap(all_depth[i]))

            curr_psnr = curr_ssim = 0.0
            if not args.no_compare_gt:
                rgb_gt_all = (images * 0.5 + 0.5)[target_view_mask]
                if rgb_gt_all.shape[1:3] != all_rgb.shape[1:3]:
                    # --scale != 1: the ground truth resized to the render
                    rgb_gt_all = np.stack([resize_area(g, all_rgb.shape[1:3]) for g in rgb_gt_all])
                for view_idx in range(n_gen_views):
                    curr_ssim += metrics.ssim(all_rgb[view_idx], rgb_gt_all[view_idx],
                                              data_range=1.0)
                    curr_psnr += metrics.psnr(all_rgb[view_idx], rgb_gt_all[view_idx])
                    if args.write_compare and writes:
                        out_im = np.hstack((all_rgb[view_idx], rgb_gt_all[view_idx]))
                        write_png(os.path.join(obj_out_dir, "{:06}_compare.png".format(
                            int(novel_view_idxs[view_idx]))), (out_im * 255).astype(np.uint8))
            curr_psnr /= n_gen_views
            curr_ssim /= n_gen_views
            total_psnr += curr_psnr
            total_ssim += curr_ssim
            cnt += 1
            rendered.append((obj_name, curr_psnr, curr_ssim))
            if not args.no_compare_gt:
                print("curr psnr", curr_psnr, "ssim", curr_ssim, "running psnr", total_psnr / cnt,
                      "running ssim", total_ssim / cnt)
            if finish_file is not None:
                finish_file.write(f"{obj_name} {curr_psnr} {curr_ssim} 1\n")
    finally:
        if finish_file is not None:
            finish_file.close()

    if cnt > 0:
        print("final psnr", total_psnr / cnt, "ssim", total_ssim / cnt)
    return {"objects": rendered, "psnr": total_psnr / cnt if cnt else float("nan"),
            "ssim": total_ssim / cnt if cnt else float("nan"), "cnt": cnt, "gates": gates}


if __name__ == "__main__":
    main()
