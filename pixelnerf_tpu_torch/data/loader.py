"""Host-side batching (numpy only): ``collate`` and a deterministic
``DataLoader``, as in the JAX package.  Malformed samples are dropped,
batches with unequal view counts are cropped to the smallest, and a batch
that fails to collate becomes None (the trainer skips it)."""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

_STACK_KEYS = ("images", "poses", "masks", "bbox", "focal", "c")


def collate(samples: List[Optional[dict]]) -> Optional[dict]:
    """Stack per-object dicts into a batch dict; None if nothing is valid."""
    samples = [s for s in samples if s is not None and isinstance(s, dict) and "images" in s]
    if not samples:
        return None
    try:
        min_views = min(s["images"].shape[0] for s in samples)
        batch: dict = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if key in _STACK_KEYS and isinstance(vals[0], np.ndarray):
                if vals[0].ndim >= 1 and key in ("images", "poses", "masks", "bbox"):
                    vals = [v[:min_views] for v in vals]
                batch[key] = np.stack(vals)
            elif key in _STACK_KEYS and np.isscalar(vals[0]):
                batch[key] = np.asarray(vals)
            else:
                batch[key] = vals  # paths / ids stay lists
        return batch
    except Exception:  # a malformed batch is skipped by the caller
        return None


class DataLoader:
    """Deterministic, optionally shuffled batch iterator.  Epoch ``e`` of a
    shuffled loader visits ``default_rng(seed * 100003 + e).shuffle``'s order.

    ``cache_mb`` > 0 keeps decoded samples by index until the cache is full,
    then freezes it: shuffled epochs visit every index, so evicting would give
    a 0% hit rate once the data outgrows the cap, while a frozen cache still
    serves cap/total of the reads."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, cache_mb: float = 0.0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._cache: dict = {}
        self._cache_bytes = 0
        self._cache_cap = int(cache_mb * 1e6)

    @staticmethod
    def _sample_bytes(s) -> int:
        if not isinstance(s, dict):
            return 0
        return sum(v.nbytes for v in s.values() if isinstance(v, np.ndarray))

    def _get(self, idx: int):
        if self._cache_cap <= 0:
            return self.dataset[idx]
        if idx in self._cache:
            return self._cache[idx]
        s = self.dataset[idx]
        nb = self._sample_bytes(s)
        if 0 < nb and self._cache_bytes + nb <= self._cache_cap:
            self._cache[idx] = s
            self._cache_bytes += nb
        return s

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed * 100003 + self.epoch).shuffle(order)
        for start in range(0, n, self.batch_size):
            idxs = order[start : start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            samples = []
            for i in idxs:
                try:
                    samples.append(self._get(int(i)))
                except Exception as e:  # a bad sample is skipped, as in the JAX loader
                    print(f"Warning: skipping sample {i}: {e}")
                    samples.append(None)
            batch = collate(samples)
            if batch is not None:
                yield batch
