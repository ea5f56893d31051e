"""Metrics over rendered outputs, LPIPS on the card:

    python -m pixelnerf_tpu_torch.eval.calc_metrics -D <datadir> -O <eval output> \\
        [-F dvr|dvr_gen|dvr_dtu|srn|nerf] [--multicat] [-P "<views>"] [-L <viewlist>] \\
        [--exclude_dtu_bad] [--lpips_weights <file>] [-R] [--dtu_sort] [--device cpu]

The counterpart of the repository's ``eval/calc_metrics.py``, with its flags
and defaults.  The map step writes each rendered object's ``metrics.txt``
(PSNR and SSIM over its views against the ground truth, and LPIPS in batches
of ``--lpips_batch_size``; ``nan`` without LPIPS weights), skipping the
views excluded by ``-P``, the ``-L`` viewlist, ``--exclude_dtu_bad`` and
``--eval_view_list``, and objects that have a ``metrics.txt`` unless
``--overwrite``.  A render at another size than its ground truth (``eval
--scale``) is compared with the ground truth resized by Pillow's bilinear
filter, as the root CLI does.  The reduce step (alone with ``-R``) writes
``all_metrics.txt`` in the root CLI's byte format: one row a category of
``--metadata`` with ``--multicat``, and the total.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import warnings

import numpy as np

METRIC_NAMES = ["psnr", "ssim", "lpips"]
# views with bad ground truth in the DTU capture rig
DTU_BAD_VIEWS = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Calculate metrics for rendered images.")
    parser.add_argument("--datadir", "-D", type=str, required=True, help="Dataset directory")
    parser.add_argument("--output", "-O", type=str, default="eval",
                        help="Root of rendered output (from eval.py)")
    parser.add_argument("--dataset_format", "-F", type=str, default="dvr", help="nerf | srn | dvr")
    parser.add_argument("--list_name", type=str, default="softras_test",
                        help="Filter list prefix for DVR")
    parser.add_argument("--gpu_id", type=int, default=0, help="Device id (single device only)")
    parser.add_argument("--device", type=str, default=None,
                        help="device of LPIPS: cuda:<gpu_id> (default) or cpu")
    parser.add_argument("--overwrite", action="store_true", help="overwrite metrics.txt")
    parser.add_argument("--exclude_dtu_bad", action="store_true",
                        help="exclude hardcoded DTU bad views")
    parser.add_argument("--multicat", action="store_true",
                        help="Prepend category id to object id")
    parser.add_argument("--viewlist", "-L", type=str, default="",
                        help="Source-view list to exclude")
    parser.add_argument("--eval_view_list", type=str, default=None)
    parser.add_argument("--primary", "-P", type=str, default="", help="Views to exclude")
    parser.add_argument("--lpips_batch_size", type=int, default=32)
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--reduce_only", "-R", action="store_true", help="skip the map step")
    parser.add_argument("--metadata", type=str, default="metadata.yaml",
                        help="category metadata for --multicat")
    parser.add_argument("--dtu_sort", action="store_true", help="Sort using DTU scene order")
    args = parser.parse_args(argv)
    if args.device is None:
        args.device = f"cuda:{args.gpu_id}"
    if args.dataset_format in ("dvr", "dvr_gen", "dvr_dtu"):
        # dvr_gen / dvr_dtu share the DVR layout on disk
        if args.dataset_format == "dvr_dtu" and args.list_name == "softras_test":
            args.list_name = "new_val"
        args.list_file, args.img_dir_name = args.list_name + ".lst", "image"
    elif args.dataset_format == "srn":
        args.list_file, args.img_dir_name = "", "rgb"
    elif args.dataset_format == "nerf":
        warnings.warn("test split not implemented for NeRF synthetic data format")
        args.list_file, args.img_dir_name = "", ""
    else:
        raise NotImplementedError("Not supported data format " + args.dataset_format)
    return args


def load_metadata(args) -> dict:
    """The category metadata: JSON, or the minimal YAML subset
    ``cat:\\n  name: ...``."""
    with open(osp.join(args.datadir, args.metadata)) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        meta, cur = {}, None
        for line in text.splitlines():
            if not line.strip() or line.strip().startswith("#"):
                continue
            if not line.startswith(" "):
                cur = line.split(":")[0].strip()
                meta[cur] = {}
            elif cur is not None and ":" in line:
                k, v = line.strip().split(":", 1)
                meta[cur][k.strip()] = v.strip()
        return meta


def load_image(path: str) -> np.ndarray:
    """A PNG as float32 [0, 1] RGB."""
    from ..utils.png import read_png

    return read_png(path).astype(np.float32)[..., :3] / 255.0


def run_map(args) -> list:
    """Write each rendered object's ``metrics.txt``; returns the objects
    written, ``[(render dir, {metric: value}, views compared), ...]``."""
    from ..data.resize import resize_bilinear_pil
    from ..utils import metrics as M

    try:
        from .lpips import lpips_fn

        lpips = lpips_fn(args.lpips_weights, device=args.device)
        print("LPIPS enabled")
    except FileNotFoundError as e:
        print(f"LPIPS disabled: {e}")
        lpips = None

    exclude_lut = {}
    if args.viewlist:
        # viewlist rows: `<cat> <obj> <view view ...>`
        print("Excluding views from list", args.viewlist)
        with open(args.viewlist) as f:
            for row in f:
                cat_id, obj_id, *views = row.split()
                exclude_lut[f"{cat_id}/{obj_id}"] = [int(v) for v in views]
    base_exclude_views = [int(v) for v in args.primary.split()]
    if args.exclude_dtu_bad:
        base_exclude_views += DTU_BAD_VIEWS
    eval_views = None
    if args.eval_view_list is not None:
        with open(args.eval_view_list) as f:
            eval_views = [int(v) for v in f.readline().split()]
        print("Only using views", eval_views)

    def split_members(cat_root):
        members = sorted(x for x in os.listdir(cat_root) if osp.isdir(osp.join(cat_root, x)))
        if args.list_file and osp.exists(osp.join(cat_root, args.list_file)):
            with open(osp.join(cat_root, args.list_file)) as f:
                keep = {ln.strip() for ln in f}
            members = [x for x in members if x in keep]
        return members

    # (ground-truth object dir, render dir): `<cat>_<obj>` under --multicat,
    # `<obj>` otherwise, as eval names its outputs
    cat_ids = sorted(os.listdir(args.datadir)) if args.multicat else ["."]
    all_objs, total_objs = [], 0
    print("CATEGORICAL SUMMARY")
    for cat_id in cat_ids:
        cat_root = osp.join(args.datadir, cat_id)
        if not osp.isdir(cat_root):
            continue
        n_cat = 0
        for obj_id in split_members(cat_root):
            rend_dir = osp.join(args.output, f"{cat_id}_{obj_id}" if args.multicat else obj_id)
            n_cat += 1
            if osp.exists(rend_dir):
                all_objs.append((osp.join(cat_root, obj_id), rend_dir))
        print(cat_id, "TOTAL", n_cat, "AVAILABLE",
              sum(1 for g, _ in all_objs if g.startswith(cat_root + osp.sep)))
        total_objs += n_cat
    print(">>> USING", len(all_objs), "OF", total_objs, "OBJECTS")

    def eligible_pairs(gt_dir, rend_dir):
        im_root = osp.join(gt_dir, args.img_dir_name) if args.img_dir_name else gt_dir
        skip = set(base_exclude_views)
        skip.update(exclude_lut.get(osp.basename(rend_dir).replace("_", "/"), []))
        for im_name in sorted(os.listdir(im_root)):
            stem, ext = osp.splitext(im_name)
            if ext not in (".jpg", ".png"):
                continue
            view = int(stem)
            rend_file = osp.join(rend_dir, f"{view:06}.png")
            if view in skip or not osp.exists(rend_file):
                continue
            if eval_views is not None and view not in eval_views:
                continue
            pred = load_image(rend_file)
            gt = load_image(osp.join(im_root, im_name))
            if pred.shape != gt.shape:
                # a render of eval --scale: the ground truth at its size
                gt = resize_bilinear_pil((gt * 255.0).astype(np.uint8),
                                         pred.shape[:2]).astype(np.float32) / 255.0
            yield pred, gt

    written = []
    for gt_dir, rend_dir in all_objs:
        out_path = osp.join(rend_dir, "metrics.txt")
        if osp.exists(out_path) and not args.overwrite:
            continue
        pairs = list(eligible_pairs(gt_dir, rend_dir))
        if not pairs:
            continue
        vals = {"psnr": float(np.mean([M.psnr(p, g) for p, g in pairs])),
                "ssim": float(np.mean([M.ssim(p, g, data_range=1.0) for p, g in pairs])),
                "lpips": float("nan")}
        if lpips is not None:
            preds = np.stack([p for p, _ in pairs]) * 2.0 - 1.0  # LPIPS takes [-1, 1]
            gts = np.stack([g for _, g in pairs]) * 2.0 - 1.0
            B = args.lpips_batch_size
            vals["lpips"] = float(np.concatenate(
                [lpips(preds[s:s + B], gts[s:s + B]) for s in range(0, len(pairs), B)]).mean())
        with open(out_path, "w") as f:
            f.write(f"psnr {vals['psnr']}\nssim {vals['ssim']}\nlpips {vals['lpips']}")
        written.append((rend_dir, vals, len(pairs)))
    return written


def _metric_cells(avg: dict) -> str:
    """The value columns of an ``all_metrics.txt`` row: `` psnr: x.xxxxxx
    ssim: ... lpips: ...``."""
    return "".join(f" {name}: {avg[name]:.6f}" for name in METRIC_NAMES)


def _metric_means(records) -> dict:
    return {name: float(np.mean([r[name] for r in records])) for name in METRIC_NAMES}


def run_reduce(args):
    """Aggregate every ``metrics.txt`` under the render root into
    ``all_metrics.txt``; returns its text (None when there is none)."""
    root = args.output
    obj_dirs = sorted(d for d in (osp.join(root, x) for x in os.listdir(root)
                                  if not x.startswith("_"))
                      if osp.isdir(d) and osp.isfile(osp.join(d, "metrics.txt")))
    if args.dtu_sort:
        obj_dirs.sort(key=lambda d: int(osp.basename(d)[4:]))  # scanNNN
    print(">>> PROCESSING", len(obj_dirs), "OBJECTS")
    if not obj_dirs:
        return None

    records = []
    for d in obj_dirs:
        with open(osp.join(d, "metrics.txt")) as f:
            records.append((d, {key: float(val) for key, val in (ln.split() for ln in f
                                                                 if ln.strip())}))
    if len(records) < 100:
        for d, vals in records:
            print(d, " ".join(repr(vals[n]) for n in METRIC_NAMES if n in vals))

    lines, total_prefix = [], ""
    if args.multicat:
        meta = load_metadata(args)
        by_cat = {}
        for d, vals in records:
            by_cat.setdefault(osp.basename(d).split("_")[0], []).append(vals)
        for cat in sorted(meta):
            if cat in by_cat:
                label = meta[cat].get("name", cat).split(",")[0]
                lines.append(f"{label:<12s}{_metric_cells(_metric_means(by_cat[cat]))}"
                             f" n_inst: {len(by_cat[cat])}")
        total_prefix = f"---\n{'total':<12s}"
    overall = _metric_means([vals for _, vals in records])
    for name in METRIC_NAMES:
        print(name, overall[name])
    lines.append(total_prefix + _metric_cells(overall))

    text = "\n".join(lines)
    out_path = osp.join(root, "all_metrics.txt")
    with open(out_path, "w") as f:
        f.write(text)
    print("WROTE", out_path)
    print(text)
    return text


def main(argv=None) -> dict:
    """The map step (unless ``-R``), then the reduce step.  Returns
    ``{"objects": run_map's list, "all_metrics": run_reduce's text}``."""
    args = parse_args(argv)
    objects = []
    if not args.reduce_only:
        print(">>> Compute")
        objects = run_map(args)
    print(">>> Reduce")
    return {"objects": objects, "all_metrics": run_reduce(args)}


if __name__ == "__main__":
    main()
