"""Step time of the PyTorch port's train CLI in several checkouts, in turns,
or (``--kernels``) the times of its field kernels, or (``--render``) its
render's rays/s.

    python3 scripts/torch_train_step_ab.py --views 1 --steps 12 --rounds 2 DIR_A DIR_B
    python3 scripts/torch_train_step_ab.py --kernels --rounds 2 DIR_A DIR_B
    python3 scripts/torch_train_step_ab.py --render --views 1 --rounds 2 DIR_A DIR_B
    python3 scripts/torch_train_step_ab.py --frame0 --rounds 2 DIR_A DIR_B

Each run is a process of its own, started in one checkout: it builds that
checkout's kernels, runs ``pixelnerf_tpu_torch.train.main`` (the train CLI,
``-c conf/exp/sn64.conf -F synthetic -B 4 -R 128``, random encoder) for
``--steps`` steps and reports the host time of each synchronized step
(``Trainer.step_seconds``).  A round runs the checkouts in the order given,
then in reverse (A B B A), so that a drift of the card or of the host falls
on both alike.  Every run's line is printed as it ends; the last line is one
JSON object with, per checkout, the mean ms/step over steps 3 on of each run.

With ``--kernels`` a run times, on the sn64 fine head (seeded weights, live
fc_1) and seeded inputs, the dense forward (``resnetfc_dense``) at a render
fine pass (4096 rays x 96 = 393,216 points) and at the -V 1 train step's
fine pass (4 x 128 x 96 = 49,152), the backward's data kernel
(``resnetfc_bwd_data``) and its weights kernel (``resnetfc_bwd_weights``,
on the data kernel's workspace) at -V 1 and -V 3 (SB 4 x NS 3 x 12,288
rows) there,
the fused gather (``resnetfc_gather``, 4 bilinear taps padded to 8 into a
1024 x 512 bf16 table) at the render's fine and coarse passes (393,216 and
262,144 points), the multi-view dense forward (``resnetfc_dense_mv``)
from 3 views at the render's fine pass (393,216 output points) and at the
-V 3 train step's (SB 4 x 12,288), and the multi-view gather
(``resnetfc_gather_mv``, two 1024 x 512 bf16 tables) from 2 views at the
render's fine and coarse passes (393,216 and 262,144 output points): CUDA
events around 5 calls after one warm-up, ms a call.  The script is the same for every checkout; only the
kernels differ.  The last line then holds, per checkout, each kernel's times
run by run.
With ``--render`` a run times ``chip_smoke.py``'s 3-frame sn64 ring render
(12,288 rays, encode included) from ``--views`` source views: the median of
10 synchronized calls after one warm-up, rays/s; the last line holds, per
checkout, each run's median.
With ``--frame0`` a run times ring frame 0 alone (encode + render, 4096
rays a step) as ``chip_smoke.py``'s render phases do, on every route of
``FRAME0_ROUTES`` taken in turns within each of 10 rounds after one
warm-up round: the gather and the dense route from one view, the deferred
code from one view, on the dense route and from two views, and the
multi-view gather from two views; the last line holds, per checkout, each
route's median rays/s run by run.
With ``--model TEXT`` every run reads sn64's conf with TEXT (HOCON) added
to its ``model`` block, e.g. ``--model 'use_global_encoder = true'`` for the
global encoder's train step or ``--model 'mlp_coarse { d_hidden = 256 },
mlp_fine { d_hidden = 256 }'`` for a narrow tower's frame 0.
Needs a CUDA card and the checkouts' kernels to build there.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def conf_path(model: str, tmp: str) -> str:
    """The working directory's ``conf/exp/sn64.conf``, or with ``model``
    (HOCON) added to its model block, a conf in ``tmp`` that includes it."""
    if not model:
        return "conf/exp/sn64.conf"
    path = os.path.join(tmp, "ab.conf")
    with open(path, "w") as fh:
        fh.write(f'include required("{os.path.abspath("conf/exp/sn64.conf")}")\n'
                 f"model {{ {model} }}\n")
    return path


def child(views: int, steps: int, model: str) -> None:
    """One run in the checkout of the working directory."""
    sys.path.insert(0, os.getcwd())
    os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # no backbone weights needed
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.train import main as train_main

    rf.build_all()
    with tempfile.TemporaryDirectory() as ck:
        trainer = train_main(["-n", "ab", "-c", conf_path(model, ck), "-F", "synthetic", "-B",
                              "4", "-V", str(views), "-R", "128", "--epochs", str(steps),
                              "--checkpoints_path", ck])
    print(json.dumps({"steps_ms": [1e3 * s for s in trainer.step_seconds]}), flush=True)


KERNEL_CASES = ("dense_393216", "dense_49152", "bwd_data_v1_49152", "bwd_data_v3_49152",
                "bwd_weights_v1_49152", "bwd_weights_v3_49152", "gather_393216", "gather_262144", "dense_mv_v3_393216", "dense_mv_v3_49152",
                "gather_mv_v2_393216", "gather_mv_v2_262144")


def child_kernels() -> None:
    """One kernel run in the checkout of the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_taps

    rf.build_all()
    dev = torch.device("cuda")
    net = entry.build_model(entry.load_conf(pretrained=False), dev, mlp_impl="auto", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for blk in net.mlp_fine.blocks:  # fc_1 starts at zero, which would leave fc_0 unused
            blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
    mlp = net.mlp_fine
    tw, nb, cl = mlp.tower(dev), mlp.n_blocks, mlp.combine_layer
    gd = torch.Generator(device=dev).manual_seed(2)

    def inputs(rows):
        z = torch.randn(rows, mlp.d_latent, device=dev, generator=gd).bfloat16()
        x = torch.randn(rows, mlp.d_in, device=dev, generator=gd)
        return z, x

    def ms(fn, reps=5):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {}
    with torch.no_grad():
        for B in (393216, 49152):
            z, x = inputs(B)
            out[f"dense_{B}"] = ms(lambda: rf.resnetfc_dense(z, x, tw, nb))
        for NS, sb in ((1, 1), (3, 4)):
            B = 49152
            z, x = inputs(NS * B)
            gc = torch.randn(mlp.d_out, B, device=dev, generator=gd)
            kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
            out[f"bwd_data_v{NS}_{B}"] = ms(lambda: rv.bwd_data(gc, z, x, tw, nb, False, **kw))
            data = rv.bwd_data(gc, z, x, tw, nb, False, **kw)
            out[f"bwd_weights_v{NS}_{B}"] = ms(lambda: rv.bwd_weights(z, data, tw, nb))
            del data
        table = torch.randn(1024, mlp.d_latent, device=dev, generator=gd).bfloat16()
        for B in (393216, 262144):
            _, x = inputs(B)
            uv = torch.rand(B, 2, device=dev, generator=gd) * 2 - 1
            idx, w = (t.contiguous() for t in bilinear_taps(uv, 32, 32, pad_taps_to=8))
            out[f"gather_{B}"] = ms(lambda: rf.resnetfc_gather(idx, w, table, x, tw, nb))
        for B, sb in ((393216, 1), (49152, 4)):
            z, x = inputs(3 * B)
            out[f"dense_mv_v3_{B}"] = ms(lambda: rf.resnetfc_dense_mv(z, x, tw, nb, 3, cl, sb))
        tables = torch.randn(2, 1024, mlp.d_latent, device=dev, generator=gd).bfloat16()
        for B in (393216, 262144):
            _, x = inputs(2 * B)
            uv = torch.rand(2 * B, 2, device=dev, generator=gd) * 2 - 1
            idx, w = (t.contiguous() for t in bilinear_taps(uv, 32, 32, pad_taps_to=8))
            out[f"gather_mv_v2_{B}"] = ms(lambda: rf.resnetfc_gather_mv(idx, w, tables, x, tw, nb,
                                                                         cl))
    print(json.dumps({"kernel_ms": out, "card": torch.cuda.get_device_name(0)}), flush=True)


def child_render(views: int, reps: int = 10) -> None:
    """One render run in the checkout of the working directory: the sn64
    ring of ``chip_smoke.py``'s render phases (3 frames of 64 x 64, seeded
    weights, random encoder) from ``views`` source views, one warm-up call,
    then ``reps`` synchronized calls of ``entry.render_ring`` (encode +
    render) on the host clock."""
    sys.path.insert(0, os.getcwd())
    import torch

    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    rf.build_all()
    dev = torch.device("cuda")
    conf = entry.load_conf(pretrained=False)
    net = entry.build_model(conf, dev, mlp_impl="auto", seed=0)
    src = entry.source_view(64, 0, list(range(views)))
    rays = entry.ring_rays(src, 3)
    rates = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entry.render_ring(net, conf, src, rays, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        if i:
            rates.append(rays.shape[0] / (time.perf_counter() - t0))
    print(json.dumps({"rays_per_s": rates, "card": torch.cuda.get_device_name(0)}), flush=True)


# route -> (source views, environment)
FRAME0_ROUTES = {
    "v1_gather": ((0,), {}),
    "v1_dense": ((0,), {"PIXELNERF_FUSED_GATHER_MAX_ROWS": "0"}),
    "v1_code": ((0,), {"PIXELNERF_DEFER_CODE": "1"}),
    "v1_dense_code": ((0,), {"PIXELNERF_FUSED_GATHER_MAX_ROWS": "0", "PIXELNERF_DEFER_CODE": "1"}),
    "v2_gather_mv": ((0, 1), {}),
    "v2_code": ((0, 1), {"PIXELNERF_DEFER_CODE": "1"}),
}


def child_frame0(model: str, reps: int = 10) -> None:
    """One frame-0 run in the checkout of the working directory: every
    route of ``FRAME0_ROUTES`` in turns, one warm-up round, then ``reps``
    rounds of synchronized calls of ``entry.render_ring`` on frame 0."""
    sys.path.insert(0, os.getcwd())
    import torch

    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    rf.build_all()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        conf = entry.load_conf(pretrained=False, path=conf_path(model, tmp))
    net = entry.build_model(conf, dev, mlp_impl="auto", seed=0)
    src = entry.source_view(64, 0, [0, 1])
    rays = entry.ring_rays(src, 3)[:64 * 64]
    rates = {k: [] for k in FRAME0_ROUTES}
    for i in range(reps + 1):
        for name, (views, env) in FRAME0_ROUTES.items():
            os.environ.update(env)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                entry.render_ring(net, conf, src, rays,
                                  torch.Generator(device=dev).manual_seed(0), 64 * 64,
                                  views=views)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                for k in env:
                    del os.environ[k]
            if i:
                rates[name].append(rays.shape[0] / dt)
    print(json.dumps({"frame0_rays_per_s": rates, "card": torch.cuda.get_device_name(0)}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--views", type=int, default=1)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", action="store_true", help="time the field kernels, not steps")
    ap.add_argument("--render", action="store_true",
                    help="time the 3-frame ring render from --views source views, not steps")
    ap.add_argument("--frame0", action="store_true",
                    help="time ring frame 0 on each render route, not steps")
    ap.add_argument("--model", default="",
                    help="HOCON added to sn64.conf's model block (train steps and --frame0)")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        if args.render:
            return child_render(args.views)
        if args.frame0:
            return child_frame0(args.model)
        return child_kernels() if args.kernels else child(args.views, args.steps, args.model)
    if not args.checkouts:
        ap.error("name at least one checkout")
    dirs = [os.path.abspath(d) for d in args.checkouts]
    order = [d for _ in range(args.rounds) for d in dirs + dirs[::-1]]
    runs = {d: [] for d in dirs}
    mode = (["--kernels"] if args.kernels else ["--render", "--views", str(args.views)]
            if args.render else ["--frame0", "--model", args.model] if args.frame0
            else ["--views", str(args.views), "--steps", str(args.steps), "--model", args.model])
    head = ('{"kernel_ms"' if args.kernels else '{"rays_per_s"' if args.render
            else '{"frame0_rays_per_s"' if args.frame0 else '{"steps_ms"')
    for i, d in enumerate(order):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", *mode], cwd=d,
                             capture_output=True, text=True, timeout=args.timeout)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith(head)]
        if out.returncode != 0 or not lines:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"run {i} in {d} failed ({out.returncode})")
        if args.kernels:
            res = json.loads(lines[-1])
            runs[d].append(res["kernel_ms"])
            print(f"run {i}: {d}: {json.dumps(res)}", flush=True)
            continue
        if args.frame0:
            res = json.loads(lines[-1])["frame0_rays_per_s"]
            med = {k: sorted(v)[len(v) // 2] for k, v in res.items()}
            runs[d].append(med)
            print(f"run {i}: {d}: frame 0 medians (rays/s) {json.dumps(med)}", flush=True)
            continue
        if args.render:
            rates = sorted(json.loads(lines[-1])["rays_per_s"])
            runs[d].append(rates[len(rates) // 2])
            print(f"run {i}: {d} {args.views} view(s): median {rates[len(rates) // 2]:.1f} rays/s "
                  f"of {[round(r, 1) for r in rates]}", flush=True)
            continue
        steps = json.loads(lines[-1])["steps_ms"]
        mean = sum(steps[2:]) / len(steps[2:])
        runs[d].append(mean)
        print(f"run {i}: {d} -V {args.views}: {mean:.3f} ms per step over steps 3-{len(steps)}; "
              f"steps {[round(s, 2) for s in steps]}", flush=True)
    if args.kernels:
        print(json.dumps({"kernel_ms": {d: {k: [r[k] for r in runs[d]] for k in KERNEL_CASES}
                                        for d in dirs}}))
        return
    if args.frame0:
        print(json.dumps({"model": args.model, "frame0_median_rays_per_s": {
            d: {k: [r[k] for r in runs[d]] for k in FRAME0_ROUTES} for d in dirs}}))
        return
    if args.render:
        print(json.dumps({"views": args.views, "median_rays_per_s": {d: runs[d] for d in dirs}}))
        return
    print(json.dumps({"views": args.views, "steps": args.steps, "model": args.model,
                      "ms_per_step": {d: runs[d] for d in dirs}}))


if __name__ == "__main__":
    main()
