"""How the backward kernels' checks hold as sn64's tower deepens and its
code widens, and how far bf16 alone moves one train step, on one CUDA card.

    python3 scripts/torch_deep_checks.py --depths 7 8 12 16 32 62
    python3 scripts/torch_deep_checks.py --depths 5 --d_in 144 510 --full
    python3 scripts/torch_deep_checks.py --depths 8 16 62 --hidden 512 384 192 --faults
    python3 scripts/torch_deep_checks.py --seeds 0 1 2 3 --blocks 8 16 62 --views 1 3
    python3 scripts/torch_deep_checks.py --depths 7 8 --hidden 512 320 192 200 \
        --draws 0 1 2 3 4 5 6 7

``--depths``: ``chip_smoke.backward_gate`` (rows 5a / 5b against their
plain versions, each reading against the independent plain route held to
its bar beside what bf16 alone reads) on sn64's fine tower (latent C 512 in
blocks 0-2, the views' mean at block 3, seeded weights ~ N(0, 1 / fan_in))
at each depth (past the forward's deepest tower at a view count: that
tower, 62 blocks at one view and 61 at NS > 1 at sn64's other widths), each
``--hidden`` width (512 by default) and each ``--d_in`` code width (42,
sn64's, by default; 144 and 510 take kin 144 and 512), from one view (2 x
1000 points) and from three (SB 2 x 333), and with ``--full`` also at the
train step's fine pass (SB 4 x 12,288 from 1 and 3 views), without exiting
on a failure.  ``--draws``: the tower's weights and the inputs drawn from
each of these seeds; then one summary line a width, code width, depth and view
count: the gates passed, the least corr against the independent plain
backward, the least corr of bf16 alone and the largest share of a drift
bar over the draws.  ``--faults``: at each width, depth and view count, a
tower with a 144-column code (draw 0) through the gate clean and with each
of ``chip_smoke.planted_faults`` handed in as the kernels' output, which
the gate must fail.

``--seeds``: ``chip_smoke.step_parity`` with its ``plain_amp`` yardstick
(the guards against the plain f32 step where the plain route under AMP
meets them, else within ``PARITY_MARGIN`` of its readings) on sn64's conf
with both heads at each of ``--blocks`` (the forward's deepest at a view
count past it) and the weights of ``chip_smoke.live_state`` (the density
shaped to occupy half the points), at each of ``--views``, on the rays
drawn from each seed, without exiting on a failure.

Each check logs chip_smoke's line and prints one JSON line of its readings.
Needs one CUDA card; builds the libraries at first use.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def deepest_tower(H: int, NS: int, C: int = 512, kin: int = 48) -> int:
    """The most blocks of sn64's tower at width H (the latent in blocks 0-2,
    the views' mean at block 3) whose programs and plan the forward and the
    backward kernels' mirrored limits take at NS views, whatever depth the
    route rule trains to: at sn64's other widths 62 at one view and 61 at
    NS > 1 (the forward's stored program)."""
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv

    L = rf.library_width(H)
    lim, dlim = rf.tile_limits(L), rv.DATA_LIMITS[L]
    for nb in range(dlim.max_blocks, 0, -1):
        pre = nb if NS == 1 else rf.blocks_per_view(nb, NS, 3)
        try:
            rf.check_dense_widths(kin, L, C, 3, nb, 4, lim)
            if NS > 1 and rf.dense_steps(nb, 3, NS, pre, C) > lim.max_steps:
                continue
            rv.check_data_program(nb, 3, NS, pre, dlim, C)
            rv.weight_plan(kin, L, C, nb, 3, NS, pre, 64, rv.WEIGHT_LIMITS[L], 132)
        except ValueError:
            continue
        return nb
    raise ValueError(f"no tower at d_hidden {H} fits")


def gates(depths, widths, full: bool, draws, d_ins, faults: bool, dev) -> None:
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    if depths:  # every library at once, one nvcc each
        rf.build_all(widths=tuple(sorted({rf.library_width(H) for H in widths})))
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    summary = {}

    def gate(H, nb, d_in, draw, NS, sb, B_obj, with_faults):
        tw = cs.bwd_tower(512, d_in, dev, cs.SEED + 19 + 1000 * draw, H, nb)[1]
        gi = torch.Generator(device=dev).manual_seed(cs.SEED + 18 + 1000 * draw)
        x, z, g = cs.bwd_inputs(cs.wide_code(d_in), gi, 512, NS, sb, B_obj)
        r = cs.backward_gate(tw, x, z, g, NS, sb, n_sms, {},
                             f"deep sweep d_hidden {H}, {nb} blocks, d_in {d_in}, draw {draw}",
                             check=False, faults=with_faults)
        print(json.dumps({"gate": nb, "hidden": H, "d_in": d_in, "views": NS, "draw": draw,
                          "points": sb * B_obj, **r}), flush=True)
        return r

    for H in widths:
        for depth in depths:
            for NS, sb, B_obj in cs.NARROW_BWD_SHAPES[: 4 if full else 2]:
                nb = min(depth, deepest_tower(H, NS))
                for d_in in d_ins:
                    for draw in draws:
                        r = gate(H, nb, d_in, draw, NS, sb, B_obj, False)
                        summary.setdefault((H, d_in, nb, NS), []).append(r)
                if faults:
                    r = gate(H, nb, 144, draws[0], NS, sb, B_obj, True)
                    print(json.dumps({"faults": nb, "hidden": H, "views": NS, "ok": r["ok"],
                                      "caught": r["caught"], "stash_fault": r["stash_fault"]}), flush=True)
    for (H, d_in, nb, NS), rs in summary.items():
        print(json.dumps({"summary": nb, "hidden": H, "d_in": d_in, "views": NS,
                          "draws": len(rs), "passed": sum(r["ok"] for r in rs),
                          "least_ind_corr": min(r["ind_corr"] for r in rs),
                          "least_bf16_corr": min(r["bf16_corr"] for r in rs),
                          "largest_drift_share": max(r["drift_share"] for r in rs),
                          "ind_corr": [round(r["ind_corr"], 6) for r in rs]}), flush=True)


def parities(seeds, blocks, views, dev) -> None:
    from pixelnerf_tpu_torch import entry

    base = entry.load_conf(pretrained=False)
    for depth in blocks:
        for nviews in views:
            nb = min(depth, deepest_tower(512, nviews))
            conf = cs.narrow_conf(base, 512, nb)
            state = cs.live_state(conf, dev, keep=cs.SHOW_KEEPS[1])
            for seed in seeds:
                r = cs.step_parity(conf, state, nviews, dev, f"deep sweep {nb} blocks",
                                   seed=seed, yardstick="plain_amp", check=False)
                print(json.dumps({"parity": nb, "views": nviews, "seed": seed, "ok": r["ok"],
                                  "gaps": r["gaps"], "grad_norm": r["grad_norm"]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", type=int, nargs="*", default=[])
    ap.add_argument("--hidden", type=int, nargs="*", default=[512])
    ap.add_argument("--full", action="store_true", help="the gates at the fine pass too")
    ap.add_argument("--draws", type=int, nargs="*", default=[0],
                    help="seeds of the gates' tower and inputs")
    ap.add_argument("--d_in", type=int, nargs="*", default=[42],
                    help="code widths of the gates' towers (6 + 6 F: F frequencies)")
    ap.add_argument("--faults", action="store_true",
                    help="the planted faults at each width, depth and view count")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--blocks", type=int, nargs="*", default=[5, 7])
    ap.add_argument("--views", type=int, nargs="*", default=[1, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_deep_checks: needs a CUDA card")
    os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # a random encoder: no weights needed
    dev = torch.device("cuda")
    gates(args.depths, args.hidden, args.full, args.draws, args.d_in, args.faults, dev)
    parities(args.seeds, args.blocks, args.views, dev)


if __name__ == "__main__":
    main()
