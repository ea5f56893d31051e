"""Run-to-run spread of ``chip_smoke.py``'s accel quick-train on the card.

    python3 scripts/torch_accel_quicktrain.py [--seeds 0 1 2 3] [--repeat_steps 200]
        [--recipes NOISE0:LR_PEAK ...]

First the recipe's first ``--repeat_steps`` steps twice from the same seed,
with torch's deterministic algorithms off and then on: whether the two runs'
losses and weights agree bit for bit, and the first step whose loss differs.
Then the whole recipe (deterministic, as ``chip_smoke.py`` runs it) from each
seed, for each recipe of ``--recipes`` (the sigma noise's std at step 0 and
the cosine's peak lr; ``chip_smoke.py``'s by default): the losses, the dense 16-frame ring render's foreground (phase 13's
``>= 0.03`` check) and the coarse head's own on frame 0, the full build's
occupancy and the gate's rungs from ``proposal`` at 30 dB -- what phase 13
reads from that seed.  A line per run; the last line is one JSON object of
them all.  Needs one CUDA card.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--repeat_steps", type=int, default=200, help="0: no repeat check")
    ap.add_argument("--recipes", nargs="+", default=[f"{cs.ACCEL_TRAIN_NOISE:g}:{cs.ACCEL_TRAIN_LR:g}"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.data.synthetic import SyntheticDataset
    from pixelnerf_tpu_torch.device import resolve_device
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    dev = resolve_device("cuda")
    rf.build_all()
    conf = entry.load_conf(pretrained=False)
    ds = SyntheticDataset(n_objs=1, n_views=8, image_size=cs.FRAME, seed=0)
    sample = ds[0]
    out = {"card": torch.cuda.get_device_name(0), "repeat": {}, "recipes": {}}

    for det in (False, True) if args.repeat_steps > 0 else ():
        runs = [cs.quick_train(conf, dev, sample, ds.z_near, ds.z_far,
                               steps=(args.repeat_steps, 0), deterministic=det)
                for _ in range(2)]
        (s0, l0, *_), (s1, l1, *_, nondet) = runs
        first = next((i for i, (a, b) in enumerate(zip(l0, l1)) if a != b), None)
        same = first is None and all(torch.equal(s0[k], s1[k]) for k in s0)
        out["repeat"]["deterministic" if det else "default"] = dict(
            steps=args.repeat_steps, weights_and_losses_bit_identical=same,
            first_differing_step=first, last_losses=(l0[-1], l1[-1]), no_deterministic_op=nondet)
        print(f"repeat, deterministic algorithms {det}: {json.dumps(out['repeat'])}", flush=True)

    gen = lambda: torch.Generator(device=dev).manual_seed(1)  # noqa: E731
    for recipe, seed in ((r, s) for r in args.recipes for s in args.seeds):
        noise0, lr_peak = (float(v) for v in recipe.split(":"))
        t0 = time.perf_counter()
        state, losses, step_s, _, _ = cs.quick_train(conf, dev, sample, ds.z_near, ds.z_far,
                                                     seed=seed, noise0=noise0, lr_peak=lr_peak)
        train_s = time.perf_counter() - t0
        net, scene, rays, pipe = cs.accel_ring(conf, dev, state, sample, ds)
        rgb_dense, _ = pipe.render_simple(scene, rays, gen(), ray_batch_size=cs.ACCEL_CHUNK,
                                          pack="u8")
        fg = cs.foreground(torch.from_numpy(rgb_dense))
        fg_coarse = cs.coarse_foreground(pipe, scene,
                                         torch.from_numpy(rays[:cs.FRAME * cs.FRAME]).to(dev),
                                         gen())
        pipe.set_accel_mode("proposal")
        grid = pipe.build_accel(scene, rays, eps_alpha=cs.ACCEL_EPS_ALPHA,
                                ray_batch_size=cs.ACCEL_CHUNK)
        occupancy = pipe.accel_stats.get("occupancy") if grid is not None else None
        label, psnrs = ("no grid", {}) if grid is None else pipe.gate_accel_mode(
            scene, rays, 1, rgb_dense, ray_batch_size=cs.ACCEL_CHUNK, pack="u8")
        res = out["recipes"].setdefault(recipe, {})[seed] = dict(
            loss_first=losses[0], loss_cosine_end=losses[cs.ACCEL_TRAIN_STEPS - 1],
            loss_last=losses[-1], ms_a_step=[1e3 * s for s in step_s], train_s=train_s,
            foreground=fg, coarse_foreground_frame0=fg_coarse, occupancy=occupancy,
            gate=label, psnrs=psnrs,
            foreground_and_gate_pass=fg >= 0.03 and label not in ("dense", "no grid"))
        print(f"recipe {recipe} (noise0:lr_peak), seed {seed}: {json.dumps(res)}", flush=True)
        del net, scene, pipe, grid, state
    print(json.dumps(out))


if __name__ == "__main__":
    main()
