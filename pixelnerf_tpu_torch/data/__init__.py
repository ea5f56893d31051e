"""Datasets and batching.  ``get_split_dataset`` follows the JAX package's
call contract; the ``synthetic`` format is ported, the file formats are not
yet (their adapters decode PNG images; ROADMAP.md)."""

from .base import BaseDataset
from .loader import DataLoader, collate
from .synthetic import SyntheticDataset

__all__ = ["BaseDataset", "DataLoader", "SyntheticDataset", "collate", "get_split_dataset"]

_FILE_FORMATS = ("srn", "dvr", "dvr_gen", "dvr_dtu", "multi_obj")


def _make(fmt: str, datadir: str, split: str, **kwargs):
    if fmt == "synthetic":
        return SyntheticDataset(seed={"train": 0, "val": 1, "test": 2}.get(split, 0), **kwargs)
    if fmt in _FILE_FORMATS:
        raise NotImplementedError(
            f"dataset format {fmt!r}: not ported yet (ROADMAP.md, the file-format adapters)"
        )
    raise NotImplementedError(f"Unsupported dataset format {fmt!r}")


def get_split_dataset(dataset_type: str, datadir: str, want_split=None, training: bool = True,
                      **kwargs):
    """:param want_split: None -> (train, val, test); 'train' | 'val' | 'test' -> one"""
    if want_split is not None:
        return _make(dataset_type, datadir, want_split, **kwargs)
    return tuple(_make(dataset_type, datadir, s, **kwargs) for s in ("train", "val", "test"))
