"""Evaluation CLIs: ``python -m pixelnerf_tpu_torch.eval.eval`` (per-object
PSNR/SSIM over a dataset split) and ``python -m
pixelnerf_tpu_torch.eval.gen_video`` (a novel-view video of one object)."""
