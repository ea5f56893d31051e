"""Training monitor: sliding-window loss / PSNR statistics, ETA, quality
advisories and a convergence check (the JAX package's ``train/monitor.py``,
which imports no JAX; the port keeps its own copy).

A standalone utility: the trainer does not call it; it serves interactive
use and notebooks.  One preallocated numpy buffer per metric, grown
geometrically: window statistics are reductions over a slice, and the full
history that ``check_convergence`` reads is one flat array.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np


class _Series:
    """Append-only float series with O(1) amortized growth and a windowed
    view.  ``tail(k)`` returns the last ``k`` values (possibly fewer)."""

    def __init__(self, capacity: int = 1024):
        self._buf = np.empty(capacity, np.float64)
        self._n = 0

    def append(self, value: float) -> None:
        if self._n == self._buf.size:
            self._buf = np.concatenate([self._buf, np.empty_like(self._buf)])
        self._buf[self._n] = float(value)
        self._n += 1

    def __len__(self) -> int:
        return self._n

    def tail(self, k: int) -> np.ndarray:
        return self._buf[max(self._n - k, 0) : self._n]

    def slice(self, start: int, stop: int) -> np.ndarray:
        return self._buf[max(start, 0) : min(stop, self._n)]


class TrainingMonitor:
    """Tracks per-iteration loss and PSNR; reports window statistics, wall
    time / ETA, and quality-band advisories."""

    # (lower-bound dB, advisory) checked top-down; first match wins
    _BANDS = (
        (30.0, "mean PSNR above 30 dB — excellent reconstruction quality"),
        (25.0, "mean PSNR above 25 dB — within the expected range"),
        (15.0, None),  # unremarkable middle band: no advisory
        (10.0, "warning: mean PSNR under 15 dB — training may need "
               "hyperparameter adjustment"),
        (-np.inf, "warning: mean PSNR under 10 dB — likely a data or model "
                  "wiring problem"),
    )

    def __init__(self, window_size: int = 100):
        self.window = int(window_size)
        self._loss = _Series()
        self._psnr = _Series()
        self._t0 = time.time()

    def update(self, loss: float, psnr: float) -> None:
        self._loss.append(loss)
        self._psnr.append(psnr)

    def get_stats(self) -> Dict[str, float]:
        """Window statistics over the last ``window_size`` updates (empty
        dict before the first update — callers guard on truthiness)."""
        if len(self._loss) == 0:
            return {}
        loss_w = self._loss.tail(self.window)
        psnr_w = self._psnr.tail(self.window)
        return {
            "loss_mean": float(loss_w.mean()),
            "loss_std": float(loss_w.std()),
            "psnr_mean": float(psnr_w.mean()),
            "psnr_std": float(psnr_w.std()),
            "psnr_max": float(psnr_w.max()),
            "psnr_min": float(psnr_w.min()),
        }

    def print_stats(
        self, epoch: int, iteration: int, total_iterations: int
    ) -> None:
        stats = self.get_stats()
        if not stats:
            return
        elapsed = time.time() - self._t0
        eta = elapsed / (iteration + 1) * (total_iterations - iteration - 1)
        rule = "=" * 70
        print(rule)
        print(f"Epoch {epoch} | Iter {iteration}/{total_iterations}")
        print(f"Loss:  {stats['loss_mean']:.6f} +/- {stats['loss_std']:.6f}")
        print(
            f"PSNR:  {stats['psnr_mean']:.2f} +/- {stats['psnr_std']:.2f} dB "
            f"(min {stats['psnr_min']:.2f}, max {stats['psnr_max']:.2f})"
        )
        print(f"Time:  elapsed {elapsed / 60:.1f} min, ETA {eta / 60:.1f} min")
        print(rule)
        for floor, advisory in self._BANDS:
            if stats["psnr_mean"] >= floor:
                if advisory:
                    print(advisory)
                break

    def check_convergence(
        self, patience: int = 10, threshold: float = 0.1
    ) -> bool:
        """PSNR improvement between the last two ``patience``-sized windows
        below ``threshold`` -> probably converged."""
        n = len(self._psnr)
        if n < 2 * patience:
            return False
        recent = self._psnr.tail(patience)
        previous = self._psnr.slice(n - 2 * patience, n - patience)
        improvement = float(recent.mean() - previous.mean())
        if improvement >= threshold:
            return False
        print("warning: PSNR has plateaued — training looks converged")
        print(f"   improvement over the last window: {improvement:.4f} dB")
        print("   consider lowering the learning rate or stopping early")
        return True
