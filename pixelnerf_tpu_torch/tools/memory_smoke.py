"""Data-layer smoke test: load samples and iterate DataLoader batches while
watching the process's resident set for leaks -- the root ``test_memory.py``
on the port's loader.  The resident set is read from ``/proc/self/status``
(``VmRSS``).

Run: python -m pixelnerf_tpu_torch.tools.memory_smoke [-F synthetic|srn|dvr] [-D datadir] [--iters 20]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ._rss import rss_mb


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_format", "-F", type=str, default="synthetic")
    parser.add_argument("--datadir", "-D", type=str, default="data")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--leak_mb", type=float, default=200.0)
    args = parser.parse_args(argv)

    from ..data import DataLoader, get_split_dataset

    print("=" * 60)
    print("DATA / MEMORY SMOKE TEST  (Ctrl-C to abort a hang)")
    print("=" * 60)

    dset = get_split_dataset(args.dataset_format, args.datadir, want_split="train")
    print(f"dataset: {len(dset)} objects, rss {rss_mb():.0f} MB")

    t0 = time.time()
    sample = dset[0]
    print(f"single sample: images {sample['images'].shape} "
          f"[{sample['images'].min():.2f}, {sample['images'].max():.2f}] "
          f"({time.time() - t0:.2f}s)")
    if not np.isfinite(sample["images"]).all():
        raise ValueError("the first sample's images are not finite")

    ok = True
    for bs in (1, 2):
        loader = DataLoader(dset, batch_size=bs, shuffle=True)
        base = rss_mb()
        n = 0
        t0 = time.time()
        while n < args.iters:
            for _ in loader:
                n += 1
                if n >= args.iters:
                    break
            loader.set_epoch(loader.epoch + 1)
        dt = time.time() - t0
        grown = rss_mb() - base
        print(f"batch_size {bs}: {n} batches in {dt:.2f}s "
              f"({dt / max(n, 1) * 1e3:.0f} ms/batch), rss growth {grown:+.0f} MB")
        if grown > args.leak_mb:
            print(f"  LEAK SUSPECTED: rss grew by more than {args.leak_mb} MB")
            ok = False

    print("MEMORY TEST", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
