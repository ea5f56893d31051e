"""Training criteria: L1/L2 rgb losses, the uncertainty- and
background-weighted variants, and the Neural Volumes alpha prior with its
epoch gate (the JAX package's ``models/losses.py``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def _elem(pred, target, use_l1: bool) -> torch.Tensor:
    if use_l1:
        return torch.mean(torch.abs(pred - target), dim=-1)
    return torch.mean((pred - target) ** 2, dim=-1)


def rgb_with_uncertainty(pred, target, betas, use_l1: bool = False) -> torch.Tensor:
    """Kendall '17 beta-weighted loss."""
    return torch.mean(_elem(pred, target, use_l1) / betas) + torch.mean(torch.log(betas))


def rgb_with_background(pred, target, lambda_bg, use_l1: bool = False) -> torch.Tensor:
    """Background-weighted variant."""
    return (torch.mean(_elem(pred, target, use_l1) / (1.0 + lambda_bg))
            + torch.mean(torch.log(lambda_bg)))


def get_rgb_loss(conf, coarse: bool = True) -> Callable:
    """The rgb criterion of a loss conf subtree: the upstream ``use_l1`` flag
    or the fork's ``type = l1|l2``, and the fine head's uncertainty loss."""
    loss_type = conf.get_string("type", None)
    use_l1 = loss_type == "l1" if loss_type is not None else conf.get_bool("use_l1", False)
    if conf.get_bool("use_uncertainty", False) and not coarse:
        return lambda pred, target, betas: rgb_with_uncertainty(pred, target, betas, use_l1=use_l1)
    return l1_loss if use_l1 else l2_loss


@dataclasses.dataclass
class AlphaLossNV2:
    """Neural Volumes alpha prior; ``epoch`` is advanced by the trainer."""

    lambda_alpha: float
    clamp_alpha: float
    init_epoch: int
    force_opaque: bool = False
    epoch: int = 0

    def sched_step(self, num: int = 1) -> None:
        self.epoch += num

    def __call__(self, alpha_fine: torch.Tensor) -> torch.Tensor:
        if self.lambda_alpha <= 0.0 or self.epoch < self.init_epoch:
            return torch.zeros((), device=alpha_fine.device)
        a = torch.clamp(alpha_fine, 0.01, 0.99)
        if self.force_opaque:  # BCE against an all-ones target
            return self.lambda_alpha * torch.mean(-torch.log(a))
        loss = torch.clamp(torch.log(a) + torch.log(1.0 - a), min=-self.clamp_alpha)
        return self.lambda_alpha * torch.mean(loss)


def get_alpha_loss(conf) -> AlphaLossNV2:
    return AlphaLossNV2(
        lambda_alpha=conf.get_float("lambda_alpha"),
        clamp_alpha=conf.get_float("clamp_alpha"),
        init_epoch=conf.get_int("init_epoch"),
        force_opaque=conf.get_bool("force_opaque", False),
    )
