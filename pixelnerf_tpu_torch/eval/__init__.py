"""Evaluation CLIs: ``python -m pixelnerf_tpu_torch.eval.eval`` (per-object
PSNR/SSIM over a dataset split), ``.eval_approx`` (one random target view an
object), ``.gen_video`` (a novel-view video of one object), ``.eval_real``
(a video of each real input image) and ``.calc_metrics`` (PSNR / SSIM /
LPIPS over rendered outputs; ``lpips.py`` is VGG16-LPIPS)."""
