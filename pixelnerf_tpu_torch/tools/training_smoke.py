"""End-to-end training smoke test with phase timing: the root
``test_training.py`` on the port -- the full train setup (the port's parser,
dataset, model and :class:`..train.trainer.Trainer`) and a few steps, timing
the host's batch preparation and the step (``Trainer.step_seconds``: forward,
backward and update, synchronized) apart, with the resident set read from
``/proc/self/status`` (``VmRSS``).

Run: python -m pixelnerf_tpu_torch.tools.training_smoke [-F synthetic|dvr|srn] [-D datadir]
     [-c conf/exp/sn64.conf] [--steps 3] [-R 128] [-B 2] [--device cpu]
Defaults to the built-in synthetic dataset so it works with no downloads; the
model keeps its seeded init (no backbone weights are read).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
import types

import numpy as np

from ._rss import rss_mb


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_format", "-F", type=str, default="synthetic")
    parser.add_argument("--datadir", "-D", type=str, default="data")
    parser.add_argument("--conf", "-c", type=str, default="conf/exp/sn64.conf")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--ray_batch_size", "-R", type=int, default=128)
    parser.add_argument("--batch_size", "-B", type=int, default=2)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    print("=" * 60)
    print("TRAINING SMOKE TEST")
    print(f"  backend rss at start: {rss_mb():.0f} MB")
    print("=" * 60)

    import torch

    from ..config.hocon import parse_file
    from ..data import get_split_dataset
    from ..data.loader import DataLoader
    from ..device import resolve_device
    from ..models.pixelnerf import make_model
    from ..render.renderer import NeRFRenderer, RenderConfig
    from ..train.trainer import Trainer
    from .check_config import resolve

    device = resolve_device(args.device)
    t0 = time.time()
    conf = parse_file(resolve(args.conf))
    dset = get_split_dataset(args.dataset_format, args.datadir, want_split="train")
    print(f"[setup] dataset: {len(dset)} objects ({time.time() - t0:.1f}s)")

    net = make_model(conf["model"], device=device, generator=torch.Generator().manual_seed(0),
                     diff_mode=True)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[setup] model: {n_params:,} params, rss {rss_mb():.0f} MB")

    cfg = RenderConfig(
        n_coarse=conf.get_int("renderer.n_coarse", 64),
        n_fine=conf.get_int("renderer.n_fine", 32),
        n_fine_depth=conf.get_int("renderer.n_fine_depth", 16),
        white_bkgd=bool(conf.get_float("renderer.white_bkgd", True)),
    )
    prep_times, losses = [], []
    with tempfile.TemporaryDirectory() as out:
        targs = types.SimpleNamespace(
            name="training_smoke", checkpoints_path=out, visual_path=out, logs_path=out,
            epochs=1, lr=1e-4, gamma=1.0, ray_batch_size=args.ray_batch_size, nviews="1",
            batch_size=args.batch_size, resume=False, no_bbox_step=100000)
        trainer = Trainer(net, dset, dset, NeRFRenderer(cfg), targs, conf)
        loader = DataLoader(dset, batch_size=args.batch_size, shuffle=True)
        it = iter(loader)
        for i in range(args.steps):
            try:
                data = next(it)
            except StopIteration:
                it = iter(loader)
                data = next(it)
            t0 = time.time()
            batch = trainer._prep(data, is_train=True)
            prep_times.append(time.time() - t0)
            loss = trainer._device_train_step(trainer._to_device(batch))["t"]
            losses.append(float(loss))
            print(f"[step {i}] prep {prep_times[-1] * 1e3:.0f} ms, "
                  f"fwd+bwd+update {trainer.step_seconds[-1] * 1e3:.0f} ms, "
                  f"loss {losses[-1]:.5f}, rss {rss_mb():.0f} MB")
        if trainer.writer is not None:
            trainer.writer.close()
    step_times = trainer.step_seconds

    print("=" * 60)
    steady = np.mean(step_times[1:]) if len(step_times) > 1 else float("nan")
    print(f"RESULT: compile+first step {step_times[0]:.1f}s; steady state {steady:.2f}s/step")
    ok = all(np.isfinite(losses))
    print("losses finite:", ok)
    print("SMOKE TEST", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
