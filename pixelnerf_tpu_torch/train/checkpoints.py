"""Model weights in the upstream ``pixel_nerf_latest`` scheme:
``checkpoints/<exp>/pixel_nerf_latest`` (and ``pixel_nerf_init`` as a warm
start), a ``_backup`` copy of the previous file written before it is
replaced.  The file is the model's ``state_dict`` in the reference torch
naming, so the JAX package reads it unchanged through ``load_model``'s torch
branch.  The full trainer state lives in :class:`.trainer.CheckpointManager`.
"""

from __future__ import annotations

import os
import shutil
import warnings

import torch


def checkpoint_path(args, ckpt_name: str = "pixel_nerf_latest") -> str:
    return os.path.join(args.checkpoints_path, args.name, ckpt_name)


def save_model(path: str, net: torch.nn.Module, backup: bool = True) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if backup and os.path.exists(path):
        shutil.copyfile(path, path + "_backup")
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()}, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_model(path: str, net: torch.nn.Module) -> None:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("net"), dict):
        sd = sd["net"]  # fork-style composite file
    net.load_state_dict(sd)


def save_weights(args, net: torch.nn.Module, opt_init: bool = False) -> None:
    save_model(checkpoint_path(args, "pixel_nerf_init" if opt_init else "pixel_nerf_latest"), net)


def load_weights(args, net: torch.nn.Module, opt_init: bool = False) -> bool:
    """Load ``pixel_nerf_latest`` when resuming, else ``pixel_nerf_init``
    (only when ``opt_init`` is False); warn and keep the fresh weights when
    the file does not exist.  Returns whether a file was loaded."""
    if opt_init and not args.resume:
        return False
    name = "pixel_nerf_init" if opt_init or not args.resume else "pixel_nerf_latest"
    path = checkpoint_path(args, name)
    if os.path.exists(path):
        print("Load", path)
        load_model(path, net)
        return True
    if not opt_init:
        warnings.warn(f"WARNING: {path} does not exist, not loaded!! Model will be "
                      "re-initialized. If training, remember to pass --resume.")
    return False
