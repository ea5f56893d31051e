"""How far bf16 rounding alone moves a rendered frame, beside the forward kernels.

    python3 scripts/torch_frame_bf16.py [--widths 512 1024] [--seeds 0 1 2 3]

For each tower width and seed, sn64's conf with both heads at that width
(``chip_smoke.narrow_conf``), seeded weights with every block live and the
density shaped so that frame 0 shows the object (``chip_smoke.live_heads``,
``show_object``), renders ring frame 0 from view 0 on the fused gather three
ways: on the kernel route, on the plain f32 route, and on the kernels' plain
versions at bf16 operands ("bf16 alone", ``chip_smoke.bf16_alone``). It
prints one line for each with the three PSNRs between them. The kernel route
reading as bf16 alone does against the f32 route, and far above it against
bf16 alone, says that the gap to f32 is the rounding, not the kernels. Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pixelnerf_tpu_torch import entry  # noqa: E402
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_frame_bf16: needs a CUDA card")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rf.build_all(("fwd",), tuple(sorted({rf.library_width(H) for H in args.widths})))
    conf = entry.load_conf(pretrained=False)
    for seed in args.seeds:
        cs.SEED = seed  # the weights' and the render's generators
        src = entry.source_view(cs.FRAME, seed)
        rays = entry.ring_rays(src, 1)[: cs.RAYS_PER_STEP]
        for H in args.widths:
            c = cs.narrow_conf(conf, H)
            models = cs.live_heads(conf, c, dev)

            def frame(m):
                return cs.render_frame0(m, c, src, (0,), {}, rays, dev)[0]

            keep = cs.show_object(models, src, (0,), rays, frame)
            ref, out = frame(models["torch"]), frame(models["auto"])
            with cs.bf16_alone():
                alone = frame(models["auto"])
            print(f"d_hidden {H}, seed {seed}, frame 0 from view 0 (fused gather; {keep:.3g} of "
                  f"the points occupied): kernel route vs plain f32 {cs.psnr(out, ref):.3f} dB, "
                  f"bf16 alone vs plain f32 {cs.psnr(alone, ref):.3f} dB, kernel route vs bf16 "
                  f"alone {cs.psnr(out, alone):.3f} dB; foreground {cs.foreground(out):.4f}",
                  flush=True)
            del models
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
