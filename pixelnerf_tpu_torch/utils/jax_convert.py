"""JAX variables -> the port's ``state_dict``, and the backbone weight contract.

:func:`from_jax_variables` is the inverse of the JAX package's
``utils/torch_convert.py::convert_pixelnerf`` / ``convert_resnet``:

* Dense kernel (I, O) -> weight (O, I); conv kernel (kh, kw, I, O) -> (O, I, kh, kw)
* BatchNorm scale / bias / mean / var -> weight / bias / running_mean / running_var
* ``lin_z_k`` -> ``lin_z.k``, ``blocks_k/fc_0`` -> ``blocks.k.fc_0``,
  ``layer1_0/conv1`` -> ``layer1.0.conv1``, ``downsample_conv`` / ``downsample_bn``
  -> ``downsample.0`` / ``downsample.1``
* ``feature_fusion``: the inverse of ``convert_pixelnerf``'s ``_FUSION_RULES``
  onto the reference names (``proj_i`` -> ``projections.i.0``, ``proj_bn_i``
  -> ``projections.i.1``, ``channel_attn`` -> ``channel_attention.1``, ...),
  a Dense kernel (I, O) of a 1 x 1 convolution -> (O, I, 1, 1)
* ``adaptive_sampler``: ``quality_fc1_i`` / ``quality_fc2_i`` ->
  ``quality_fc1.i`` / ``quality_fc2.i`` (Linear layers; the reference
  converter has no rule for them)
* ``global_encoder``: its trunk as the encoder's, and ``fc``
* the ConvEncoder's ``conv_in`` / ``conv{i}`` / ``conv_mid`` / ``deconv{i}``
  / ``deconv_last`` kernels by the conv rule (the port keeps transposed
  convolutions in the Conv2d layout too, :mod:`..models.custom_encoder`),
  its GroupNorm ``scale`` / ``bias`` as weight / bias (the reference
  converter has no rule for them)
* ImplicitNet's ``lin{i}`` as they are
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_LAYER = re.compile(r"^layer(\d+)_(\d+)$")
_INDEXED = re.compile(r"^(lin_z|scale_z|blocks|quality_fc1|quality_fc2)_(\d+)$")
_RENAMED = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
# the fusion stack's flax modules (under ``feature_fusion``, "/"-joined) ->
# (reference module, whether a flax Dense kernel there is a 1 x 1 convolution)
_FUSION = [
    (re.compile(r"^proj_(\d+)$"), r"projections.\1.0", True),
    (re.compile(r"^proj_bn_(\d+)$"), r"projections.\1.1", False),
    (re.compile(r"^channel_attn$"), "channel_attention.1", True),
    (re.compile(r"^spatial_attn$"), "spatial_attention.0", False),
    (re.compile(r"^fusion_conv$"), "fusion.0", False),
    (re.compile(r"^fusion_bn$"), "fusion.1", False),
    (re.compile(r"^cbam/channel_attn/fc1$"), "cbam.channel_attn.fc.0", True),
    (re.compile(r"^cbam/channel_attn/fc2$"), "cbam.channel_attn.fc.2", True),
    (re.compile(r"^cbam/spatial_attn/conv$"), "cbam.spatial_attn.conv", False),
    (re.compile(r"^enhancement$"), "enhancement.0", True),
]


def _fusion_path(path):
    """('cbam', 'channel_attn', 'fc1') -> ('cbam.channel_attn.fc.0', True)"""
    flat = "/".join(path)
    for rx, name, conv1x1 in _FUSION:
        m = rx.match(flat)
        if m:
            return m.expand(name), conv1x1
    raise ValueError(f"unknown feature_fusion module {flat!r}")


def _module_path(path) -> str:
    """('encoder', 'model', 'layer1_0', 'downsample_conv') -> 'encoder.model.layer1.0.downsample.0'"""
    out = []
    for p in path:
        m = _LAYER.match(p)
        if m:
            out.append(f"layer{m.group(1)}.{m.group(2)}")
            continue
        m = _INDEXED.match(p)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}")
            continue
        out.append(_RENAMED.get(p, p))
    return ".".join(out)


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


_TOP = ("encoder", "global_encoder", "mlp_coarse", "mlp_fine", "feature_fusion",
        "adaptive_sampler")


def from_jax_variables(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (numpy leaves) of the JAX
    ``PixelNeRFNet`` -> a ``state_dict`` for the port's ``PixelNeRFNet``."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(variables_np.get(coll, {})):
            if path[0] not in _TOP:
                raise NotImplementedError(
                    f"JAX variables under {path[0]!r}: not ported yet (ROADMAP.md)"
                )
            leaf, conv1x1 = path[-1], False
            if path[0] == "feature_fusion":
                mod, conv1x1 = _fusion_path(path[1:-1])
                mod = "feature_fusion." + mod
            else:
                mod = _module_path(path[:-1])
            if coll == "batch_stats":
                name = {"mean": "running_mean", "var": "running_var"}[leaf]
                sd[f"{mod}.{name}"] = torch.from_numpy(value.copy())
                sd.setdefault(f"{mod}.num_batches_tracked", torch.tensor(0, dtype=torch.long))
            elif leaf == "kernel":
                perm = (3, 2, 0, 1) if value.ndim == 4 else (1, 0)
                w = np.array(value.transpose(perm), order="C")
                sd[f"{mod}.weight"] = torch.from_numpy(w[:, :, None, None] if conv1x1 else w)
            elif leaf == "scale":
                sd[f"{mod}.weight"] = torch.from_numpy(value.copy())
            elif leaf == "bias":
                sd[f"{mod}.bias"] = torch.from_numpy(value.copy())
            else:
                raise ValueError(f"unknown JAX leaf {'/'.join(path)}")
    return sd


def backbone_state_dict(weights_path: Optional[str] = None) -> Optional[dict]:
    """A torchvision-layout ResNet state dict from ``weights_path`` or
    ``$PIXELNERF_BACKBONE_WEIGHTS``; None when neither is set.  Nothing is
    downloaded."""
    path = weights_path or os.environ.get("PIXELNERF_BACKBONE_WEIGHTS")
    if not path:
        return None
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("net"), dict):
        obj = obj["net"]
    return obj


def load_pretrained_backbone(net: torch.nn.Module, model_conf) -> int:
    """Load the ResNet trunks from pretrained weights where the conf asks for
    them: the spatial encoder's (``encoder.pretrained``, default true; a
    ConvEncoder has none) and, with ``use_global_encoder``, the global
    encoder's (``global_encoder.pretrained``, default true), each from its
    ``pretrained_path`` or ``$PIXELNERF_BACKBONE_WEIGHTS``.  Returns the
    number of tensors loaded.  Without a weights file this fails, unless
    ``PIXELNERF_ALLOW_RANDOM_BACKBONE=1`` keeps the random trunk."""
    targets = []
    enc = model_conf["encoder"]
    if enc.get_string("type", "spatial") == "spatial" and enc.get_bool("pretrained", True):
        targets.append(("encoder", net.encoder.model, enc.get_string("pretrained_path", None)))
    if model_conf.get_bool("use_global_encoder", False):
        ge = model_conf["global_encoder"] if "global_encoder" in model_conf else None
        if ge is None or ge.get_bool("pretrained", True):
            path = ge.get_string("pretrained_path", None) if ge is not None else None
            targets.append(("global_encoder", net.global_encoder.model, path))
    n = 0
    for name, trunk, path in targets:
        sd = backbone_state_dict(path)
        if sd is None:
            if os.environ.get("PIXELNERF_ALLOW_RANDOM_BACKBONE") == "1":
                warnings.warn(f"{name} keeps RANDOM initialization "
                              "(PIXELNERF_ALLOW_RANDOM_BACKBONE=1)")
                continue
            raise RuntimeError(
                f"{name} is configured pretrained=true but no backbone weights were "
                f"given (no {name}.pretrained_path, no $PIXELNERF_BACKBONE_WEIGHTS). "
                "Provide a torchvision-layout state dict, or set "
                "PIXELNERF_ALLOW_RANDOM_BACKBONE=1 to keep a random encoder."
            )
        target = trunk.state_dict()
        keep = {k: v for k, v in sd.items()
                if k in target and tuple(v.shape) == tuple(target[k].shape)}
        if not keep:
            raise RuntimeError(f"backbone weights matched 0 {name} tensors")
        trunk.load_state_dict(keep, strict=False)
        n += len(keep)
    return n
