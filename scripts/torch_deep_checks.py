"""How the backward kernels' checks hold as sn64's tower deepens, and how far
bf16 alone moves one train step, on one CUDA card.

    python3 scripts/torch_deep_checks.py --depths 7 9 12 16 24 32 49
    python3 scripts/torch_deep_checks.py --depths 5 7 --hidden 384 64 --full
    python3 scripts/torch_deep_checks.py --seeds 0 1 2 3 --blocks 5 7 --views 1 3
    python3 scripts/torch_deep_checks.py --depths 6 7 --hidden 512 320 192 200 \
        --draws 0 1 2 3 4 5 6 7

``--depths``: ``chip_smoke.backward_gate`` (rows 5a / 5b against their
plain versions, with what bf16 alone does beside it) on sn64's fine tower
(latent C 512 in blocks 0-2, the views' mean at block 3, seeded weights ~
N(0, 1 / fan_in)) at each depth and each ``--hidden`` width (512 by
default), from one view (2 x 1000 points) and from three (SB 2 x 333), and
with ``--full`` also at the train step's fine pass (SB 4 x 12,288 from 1
and 3 views), without exiting on a failure.  ``--draws``: the tower's
weights and the inputs drawn from each of these seeds (0: the tower
chip_smoke's deep gate holds, its inputs drawn first); then one summary
line a width, depth and view count: the gates passed, and the least corr
against the independent plain backward and the least corr of bf16 alone
over the draws.

``--seeds``: ``chip_smoke.step_parity`` against the ``kernel_plain``
yardstick (the kernel route, its plain versions on the card under the same
AMP, the plain route under AMP and in f32) on sn64's conf with both heads at
each of ``--blocks`` and the weights of ``chip_smoke.live_state``, at each
of ``--views``, on the rays drawn from each seed, without exiting on a
failure.

Each check logs chip_smoke's line and prints one JSON line of its readings.
Needs one CUDA card; builds the backward libraries at first use.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def gates(depths, widths, full: bool, draws, dev) -> None:
    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.models.code import PositionalEncoding
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    if depths:  # every library at once, one nvcc each
        rf.build_all(widths=tuple(sorted({rf.library_width(H) for H in widths})))
    conf = entry.load_conf(pretrained=False)
    code = PositionalEncoding.from_conf(conf["model.code"], d_in=3)
    d_in = code.d_out + 3
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    summary = {}
    for H in widths:
        for nb in depths:
            for draw in draws:
                tw = cs.bwd_tower(512, d_in, dev, cs.SEED + 19 + 1000 * draw, H, nb)[1]
                gi = torch.Generator(device=dev).manual_seed(cs.SEED + 18 + 1000 * draw)
                for NS, sb, B_obj in cs.NARROW_BWD_SHAPES[: 4 if full else 2]:
                    x, z, g = cs.bwd_inputs(code, gi, 512, NS, sb, B_obj)
                    r = cs.backward_gate(tw, x, z, g, NS, sb, n_sms, {},
                                         f"deep sweep d_hidden {H}, {nb} blocks, draw {draw}",
                                         check=False)
                    print(json.dumps({"gate": nb, "hidden": H, "views": NS, "draw": draw,
                                      "points": sb * B_obj, **r}), flush=True)
                    summary.setdefault((H, nb, NS), []).append(r)
                del tw
    for (H, nb, NS), rs in summary.items():
        print(json.dumps({"summary": nb, "hidden": H, "views": NS, "draws": len(rs),
                          "passed": sum(r["ok"] for r in rs),
                          "least_ind_corr": min(r["ind_corr"] for r in rs),
                          "least_bf16_corr": min(r["bf16_corr"] for r in rs),
                          "ind_corr": [round(r["ind_corr"], 6) for r in rs]}), flush=True)


def parities(seeds, blocks, views, dev) -> None:
    from pixelnerf_tpu_torch import entry

    base = entry.load_conf(pretrained=False)
    for nb in blocks:
        conf = cs.narrow_conf(base, 512, nb)
        state = cs.live_state(conf, dev)
        for nviews in views:
            for seed in seeds:
                r = cs.step_parity(conf, state, nviews, dev, f"deep sweep {nb} blocks",
                                   seed=seed, yardstick="kernel_plain", check=False)
                print(json.dumps({"parity": nb, "views": nviews, "seed": seed, "ok": r["ok"],
                                  "gaps": r["gaps"], "grad_norm": r["grad_norm"]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", type=int, nargs="*", default=[])
    ap.add_argument("--hidden", type=int, nargs="*", default=[512])
    ap.add_argument("--full", action="store_true", help="the gates at the fine pass too")
    ap.add_argument("--draws", type=int, nargs="*", default=[0],
                    help="seeds of the gates' tower and inputs")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--blocks", type=int, nargs="*", default=[5, 7])
    ap.add_argument("--views", type=int, nargs="*", default=[1, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_deep_checks: needs a CUDA card")
    os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # a random encoder: no weights needed
    dev = torch.device("cuda")
    gates(args.depths, args.hidden, args.full, args.draws, dev)
    parities(args.seeds, args.blocks, args.views, dev)


if __name__ == "__main__":
    main()
