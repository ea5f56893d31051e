"""Step time of the PyTorch port's train CLI in several checkouts, in turns.

    python3 scripts/torch_train_step_ab.py --views 1 --steps 12 --rounds 2 DIR_A DIR_B

Each run is a process of its own, started in one checkout: it builds that
checkout's kernels, runs ``pixelnerf_tpu_torch.train.main`` (the train CLI,
``-c conf/exp/sn64.conf -F synthetic -B 4 -R 128``, random encoder) for
``--steps`` steps and reports the host time of each synchronized step
(``Trainer.step_seconds``).  A round runs the checkouts in the order given,
then in reverse (A B B A), so that a drift of the card or of the host falls
on both alike.  Every run's line is printed as it ends; the last line is one
JSON object with, per checkout, the mean ms/step over steps 3 on of each run.
Needs a CUDA card and the checkouts' kernels to build there.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile


def child(views: int, steps: int) -> None:
    """One run in the checkout of the working directory."""
    sys.path.insert(0, os.getcwd())
    os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # no backbone weights needed
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.train import main as train_main

    rf.build_all()
    with tempfile.TemporaryDirectory() as ck:
        trainer = train_main(["-n", "ab", "-c", "conf/exp/sn64.conf", "-F", "synthetic", "-B", "4",
                              "-V", str(views), "-R", "128", "--epochs", str(steps),
                              "--checkpoints_path", ck])
    print(json.dumps({"steps_ms": [1e3 * s for s in trainer.step_seconds]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--views", type=int, default=1)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.views, args.steps)
    if not args.checkouts:
        ap.error("name at least one checkout")
    dirs = [os.path.abspath(d) for d in args.checkouts]
    order = [d for _ in range(args.rounds) for d in dirs + dirs[::-1]]
    runs = {d: [] for d in dirs}
    for i, d in enumerate(order):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--views",
                              str(args.views), "--steps", str(args.steps)], cwd=d,
                             capture_output=True, text=True, timeout=args.timeout)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{"steps_ms"')]
        if out.returncode != 0 or not lines:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"run {i} in {d} failed ({out.returncode})")
        steps = json.loads(lines[-1])["steps_ms"]
        mean = sum(steps[2:]) / len(steps[2:])
        runs[d].append(mean)
        print(f"run {i}: {d} -V {args.views}: {mean:.3f} ms per step over steps 3-{len(steps)}; "
              f"steps {[round(s, 2) for s in steps]}", flush=True)
    print(json.dumps({"views": args.views, "steps": args.steps,
                      "ms_per_step": {d: runs[d] for d in dirs}}))


if __name__ == "__main__":
    main()
