"""Datasets and batching (numpy only).  ``get_split_dataset`` follows the JAX
package's call contract: no ``want_split`` -> (train, val, test); with
``want_split`` -> one dataset.  Formats: ``srn | dvr | dvr_gen | dvr_dtu |
multi_obj`` on disk, plus the in-memory ``synthetic``."""

from .base import BaseDataset
from .dvr import DVRDataset
from .loader import DataLoader, collate
from .multi_obj import MultiObjectDataset
from .srn import SRNDataset
from .synthetic import (
    SyntheticDataset,
    write_synthetic_dtu,
    write_synthetic_dvr,
    write_synthetic_multi_obj,
    write_synthetic_srn,
)

__all__ = [
    "BaseDataset",
    "DVRDataset",
    "DataLoader",
    "MultiObjectDataset",
    "SRNDataset",
    "SyntheticDataset",
    "collate",
    "get_split_dataset",
    "write_synthetic_dtu",
    "write_synthetic_dvr",
    "write_synthetic_multi_obj",
    "write_synthetic_srn",
]


def _make(fmt: str, datadir: str, split: str, **kwargs):
    if fmt == "srn":
        return SRNDataset(datadir, stage=split, **kwargs)
    if fmt == "dvr":
        return DVRDataset(datadir, stage=split, **kwargs)
    if fmt == "dvr_gen":
        return DVRDataset(datadir, stage=split, list_prefix="gen_", **kwargs)
    if fmt == "dvr_dtu":
        return DVRDataset(datadir, stage=split, sub_format="dtu", **kwargs)
    if fmt == "multi_obj":
        return MultiObjectDataset(datadir, stage=split, **kwargs)
    if fmt == "synthetic":
        return SyntheticDataset(seed={"train": 0, "val": 1, "test": 2}.get(split, 0), **kwargs)
    raise NotImplementedError(f"Unsupported dataset format {fmt!r}")


def get_split_dataset(dataset_type: str, datadir: str, want_split=None, training: bool = True,
                      **kwargs):
    """:param want_split: None -> (train, val, test); 'train' | 'val' | 'test' -> one"""
    if want_split is not None:
        return _make(dataset_type, datadir, want_split, **kwargs)
    return tuple(_make(dataset_type, datadir, s, **kwargs) for s in ("train", "val", "test"))
