"""Training: the epoch trainer, its checkpoints, and the CLI
(``python -m pixelnerf_tpu_torch.train``)."""

from .cli import main
from .trainer import CheckpointManager, Optimizer, Trainer, make_step_fns, prepare_ray_batch

__all__ = ["CheckpointManager", "Optimizer", "Trainer", "main", "make_step_fns",
           "prepare_ray_batch"]
