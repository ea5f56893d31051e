"""Evaluation CLIs: ``python -m pixelnerf_tpu_torch.eval.eval`` (per-object
PSNR/SSIM over a dataset split)."""
