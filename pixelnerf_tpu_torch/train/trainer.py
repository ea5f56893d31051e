"""Epoch-based training on the card: the JAX package's ``train/trainer.py``.

* :func:`prepare_ray_batch`: per-object pixel rays and source views, sampled
  on the host with numpy (bbox-guided until ``no_bbox_step``, or a
  mask-guided foreground fraction) -- bit-equal to the JAX function for the
  same ``np.random.Generator``;
* :func:`make_step_fns`: the train and eval steps.  The encoder and the
  fusion stack run in train mode (batch statistics; the fusion's dropout
  drawn from the step's generator); with AMP the field sees bf16 copies of
  the f32 parameters and bf16 latent maps, and the gradients reach the f32
  masters through the casts.  On the plain route the copies go in through
  ``torch.func.functional_call``; on the kernel route the field's autograd
  Function packs them for the kernels.  ``grad_norm`` is the global norm of
  the raw gradients;
* with a ``("data", "rays")`` mesh (``Trainer(..., mesh=)``) each rank
  steps on its slice of the batch (``parallel.mesh.shard_batch``) with its
  rows of the whole batch's draws; its loss is the mean over its slice, the
  gradients and the reported losses are averaged over the ranks before the
  norm and Adam, so the replicas take the same step; train-mode BatchNorm
  and the fusion's dropout see the whole object batch
  (``parallel.mesh.DataShard``);
* :class:`Optimizer`: Adam with optax's conventions -- update ``t`` (from 0)
  uses ``schedule(t)``, weight decay is added to the gradient before Adam,
  global-norm clipping only with ``check_gradients`` and ``grad_clip > 0``,
  and ``accu_grad`` as ``optax.MultiSteps`` (a running mean, one update every
  ``accu_grad`` steps);
* :class:`CheckpointManager`: ``epoch_%04d.ckpt``, ``latest.ckpt`` stamped
  epoch + 1, ``best.ckpt`` and the keep_last / milestone / keep_all
  retention, as ``torch.save`` payloads of tensors and plain Python;
* :class:`Trainer`: the epoch loop with host-side prefetch, the bbox flip,
  the renderer's sample schedule, validation, saving and resume; every
  ``vis_interval`` epochs the ``vis_step`` hook's image grid, written to
  ``<visual_path>/<name>/<epoch>_vis.png``; and, when ``tensorboardX``
  imports, the JAX trainer's TensorBoard tags under ``<logs_path>/<name>``
  (``train/<loss>``, ``train/lr``, ``val/loss``, ``vis``, ``vis/psnr``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import math
import os
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..data.loader import DataLoader
from ..models.losses import get_alpha_loss, get_rgb_loss, l2_loss
from ..models.pixelnerf import PixelNeRFNet
from ..parallel import launch
from ..parallel.mesh import DataShard, Mesh, axis_slice, set_data_shard, shard_batch
from ..render.renderer import (
    NeRFRenderer,
    RayDraws,
    RenderConfig,
    complete_draws,
    draw_rows,
    render_rays,
)
from ..utils import geometry
from ..utils.png import write_png

FIELD_HEADS = ("mlp_coarse.", "mlp_fine.")


# ---------------------------------------------------------------------------
# host-side batch preparation
# ---------------------------------------------------------------------------


def prepare_ray_batch(data: dict, nviews: int, ray_batch_size: int, z_near: float, z_far: float,
                      use_bbox: bool, rng: np.random.Generator,
                      fg_frac: float = 0.0) -> Optional[dict]:
    """Sample per-object pixel rays and source views.

    :param data: collated batch (images (SB, NV, H, W, 3) in [-1, 1], poses,
        focal, optional c / bbox / masks)
    :param fg_frac: fraction of each object's rays drawn from mask-positive
        pixels (needs ``data["masks"]``), the rest uniform; 0 disables
    :return: dict with src_images (SB, NS, H, W, 3), src_poses, focal, c,
        rays (SB, R, 8), rgb_gt (SB, R, 3), and mask_gt (SB, R) when the
        batch has masks.  A focal or c with a row per view (SB, NV, 2) gives
        each ray its view's row and the encoder the source views' rows
        (SB, NS, 2).
    """
    if "images" not in data:
        return None
    all_images = data["images"]
    SB, NV, H, W = all_images.shape[:4]
    all_poses = data["poses"]
    all_bboxes = data.get("bbox") if use_bbox else None
    all_focals = np.asarray(data["focal"])
    all_c = data.get("c")

    src_images, src_poses, src_ords = [], [], []
    all_rays, all_rgb_gt, all_mask_gt = [], [], []
    for obj_idx in range(SB):
        images = all_images[obj_idx]
        poses = all_poses[obj_idx]
        focal = all_focals[obj_idx]
        c = None if all_c is None else np.asarray(all_c[obj_idx])
        if nviews == 1:
            image_ord = rng.integers(0, NV, (1,))
        else:
            image_ord = rng.choice(NV, nviews, replace=False)
        if all_bboxes is not None:
            pix = geometry.bbox_sample_np(all_bboxes[obj_idx], ray_batch_size, rng)
        else:
            n_fg = 0
            fg_flat = None
            if fg_frac > 0.0 and "masks" in data:
                fg_flat = np.flatnonzero(np.asarray(data["masks"][obj_idx])[..., 0].reshape(-1) > 0.5)
                if fg_flat.size:
                    n_fg = int(round(ray_batch_size * min(fg_frac, 1.0)))
            flat = rng.integers(0, NV * H * W, (ray_batch_size,))
            if n_fg:
                flat[:n_fg] = fg_flat[rng.integers(0, fg_flat.size, (n_fg,))]
            pix = np.stack([flat // (H * W), (flat // W) % H, flat % W], axis=-1)
        all_rgb_gt.append(images[pix[:, 0], pix[:, 1], pix[:, 2]] * 0.5 + 0.5)
        if "masks" in data:
            all_mask_gt.append(np.asarray(data["masks"][obj_idx])[pix[:, 0], pix[:, 1], pix[:, 2], 0])
        all_rays.append(geometry.gen_rays_at_np(poses, W, H, focal, z_near, z_far, pix, c=c))
        src_images.append(images[image_ord])
        src_poses.append(poses[image_ord])
        src_ords.append(image_ord)

    def source_rows(x):
        return np.stack([geometry.view_rows(xo, o) for xo, o in zip(x, src_ords)]).astype(
            np.float32)

    batch = {
        "src_images": np.stack(src_images).astype(np.float32),
        "src_poses": np.stack(src_poses).astype(np.float32),
        "focal": source_rows(all_focals),
        "rays": np.stack(all_rays).astype(np.float32),
        "rgb_gt": np.stack(all_rgb_gt).astype(np.float32),
    }
    if all_c is not None:
        batch["c"] = source_rows(all_c)
    if all_mask_gt:
        batch["mask_gt"] = np.stack(all_mask_gt).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def make_schedule(policy: str, lr: float, steps_per_epoch: int, gamma: float = 1.0,
                  decay_epochs: int = 50, decay_factor: float = 0.5, warmup_steps: int = 100,
                  total_steps: int = 0) -> Callable[[int], float]:
    """The lr at update ``t``: const, exp (per-epoch staircase by ``gamma``),
    step (``decay_factor`` every ``decay_epochs``), or cosine (linear warmup
    from 0, then cosine to 10% of peak at ``total_steps``) -- optax's
    ``exponential_decay`` / ``warmup_cosine_decay_schedule`` arithmetic."""
    if policy == "step":
        every = decay_epochs * steps_per_epoch
        return lambda t: lr * decay_factor ** (t // every)
    if policy == "exp" and gamma != 1.0:
        return lambda t: lr * gamma ** (t // steps_per_epoch)
    if policy == "cosine":
        if int(total_steps) <= 0:
            raise ValueError(
                "train.lr_policy = cosine needs a decay horizon: set "
                "train.lr_total_steps (steps) or pass a finite --epochs"
            )
        end, span = 0.1 * lr, float(total_steps - warmup_steps)

        def cosine(t: int) -> float:
            if t < warmup_steps:
                return lr * t / warmup_steps
            frac = min(float(t - warmup_steps), span) / span
            return lr * ((1.0 - end / lr) * 0.5 * (1.0 + math.cos(math.pi * frac)) + end / lr)

        return cosine
    return lambda t: lr


class Optimizer:
    """Adam on the model's parameters, with optax's step conventions."""

    def __init__(self, params: List[torch.nn.Parameter], schedule: Callable[[int], float],
                 beta1: float = 0.9, beta2: float = 0.999, weight_decay: float = 0.0,
                 clip: float = 0.0, accu_grad: int = 1):
        self.params = list(params)
        self.schedule = schedule
        self.clip = clip
        self.accu_grad = accu_grad
        self.adam = torch.optim.Adam(self.params, lr=schedule(0), betas=(beta1, beta2),
                                     weight_decay=weight_decay)
        self.count = 0  # updates applied: the schedule's step
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def step(self, grads: List[torch.Tensor]) -> None:
        """Apply (or accumulate) one step's raw gradients."""
        if self.accu_grad > 1:
            n = self.mini_step
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            self.acc = [(g + n * a) / (n + 1) for g, a in zip(grads, self.acc)]
            if n < self.accu_grad - 1:
                self.mini_step += 1
                return
            grads, self.acc, self.mini_step = self.acc, None, 0
        if self.clip > 0:
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            grads = [g * scale.to(g.dtype) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def lr(self) -> float:
        return self.schedule(self.count)

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count, "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        acc = state.get("acc")
        self.acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.params)]


# ---------------------------------------------------------------------------
# the train / eval steps
# ---------------------------------------------------------------------------


def make_step_fns(net: PixelNeRFNet, optimizer: Optimizer, render_cfg: Callable[[], RenderConfig],
                  lambda_coarse: float, lambda_fine: float, rgb_coarse_crit: Callable,
                  rgb_fine_crit: Callable, use_viewdirs: bool, amp: bool = True, remat: bool = True,
                  alpha_crit=None, lambda_alpha_mask: float = 0.0,
                  reduce_mean: Optional[Callable[[List[torch.Tensor]], List[torch.Tensor]]] = None):
    """Build ``(train_step, eval_step)``.

    Both take ``(batch, generator, draws=None)``, a batch of device tensors
    from :func:`prepare_ray_batch`, and return a dict of scalar tensors;
    ``train_step`` also takes ``noise_scale`` and updates the parameters and
    the encoder's running statistics.  ``draws`` may also be a function
    ``(generator, cfg) -> RayDraws``, called after the encoder has made its
    draws.  ``render_cfg`` is read at each call (the renderer's sample
    schedule), and so is the alpha prior's epoch gate.  ``remat`` recomputes
    the plain field in the backward (``torch.utils.checkpoint``).
    ``reduce_mean`` (a data-parallel run) averages the gradients and the
    losses over the ranks before the norm and the update."""
    params = list(net.parameters())
    reduce_mean = reduce_mean or (lambda ts: ts)

    def compute_loss(batch: dict, generator, draws, training: bool, noise_scale=None):
        cfg = dataclasses.replace(render_cfg(), eval_batch_size=0)
        scene = net.encode(batch["src_images"], batch["src_poses"], batch["focal"],
                           c=batch.get("c"), train=training, generator=generator)
        if callable(draws):
            draws = draws(generator, cfg)
        if amp:
            fparams = {n: p.to(torch.bfloat16) for n, p in net.named_parameters()
                       if n.startswith(FIELD_HEADS)}
            scene_f = scene.cast(torch.bfloat16)
            field_dtype = torch.bfloat16
        else:
            fparams, scene_f, field_dtype = None, scene, None

        def field_impl(points, viewdirs, coarse):
            kw = dict(viewdirs=viewdirs if use_viewdirs else None, coarse=coarse,
                      planar_out=True, compute_dtype=field_dtype)
            if fparams is None:
                return net.query(scene_f, points, **kw)
            return functional_call(net, fparams, (scene_f, points), kw, strict=False)

        if remat and training:
            def field(points, viewdirs, coarse):
                return checkpoint(field_impl, points, viewdirs, coarse, use_reentrant=False)
        else:
            field = field_impl

        alpha_active = (alpha_crit is not None and alpha_crit.lambda_alpha > 0.0
                        and alpha_crit.epoch >= alpha_crit.init_epoch)
        mask_active = lambda_alpha_mask > 0.0 and "mask_gt" in batch
        out = render_rays(field, batch["rays"], cfg, generator=generator, draws=draws,
                          want_weights=alpha_active or mask_active, training=training,
                          use_viewdirs=use_viewdirs, noise_scale=noise_scale)
        rgb_gt = batch["rgb_gt"]
        loss_c = rgb_coarse_crit(out["coarse"]["rgb"], rgb_gt)
        loss = loss_c * lambda_coarse
        loss_dict = {"rc": loss}
        if "fine" in out:
            loss_f = rgb_fine_crit(out["fine"]["rgb"], rgb_gt) * lambda_fine
            loss = loss + loss_f
            loss_dict["rf"] = loss_f
        if mask_active:
            mask_gt = batch["mask_gt"]
            loss_am = torch.mean((out["coarse"]["weights"].sum(-1) - mask_gt) ** 2) * lambda_coarse
            if "fine" in out:
                loss_am = loss_am + torch.mean(
                    (out["fine"]["weights"].sum(-1) - mask_gt) ** 2) * lambda_fine
            loss = loss + lambda_alpha_mask * loss_am
            loss_dict["am"] = lambda_alpha_mask * loss_am
        if alpha_active:
            head = out["fine"] if "fine" in out else out["coarse"]
            loss_a = alpha_crit(head["weights"].sum(-1))
            loss = loss + loss_a
            loss_dict["la"] = loss_a
        loss_dict["t"] = loss
        return loss, loss_dict

    def train_step(batch: dict, generator, draws: Optional[RayDraws] = None,
                   noise_scale=None) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        loss, loss_dict = compute_loss(batch, generator, draws, True, noise_scale)
        loss.backward()
        # a parameter the loss does not reach (a frozen encoder) has a zero
        # gradient, as in JAX: it still counts in the norm and in Adam's state
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grads = reduce_mean(grads)
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        with torch.no_grad():
            optimizer.step(grads)
        loss_dict = _reduced({k: v.detach() for k, v in loss_dict.items()})
        loss_dict["grad_norm"] = gnorm
        return loss_dict

    def _reduced(loss_dict: dict) -> dict:
        return dict(zip(loss_dict, reduce_mean(list(loss_dict.values()))))

    def eval_step(batch: dict, generator, draws: Optional[RayDraws] = None):
        with torch.no_grad():
            return _reduced(compute_loss(batch, generator, draws, False)[1])

    return train_step, eval_step


# ---------------------------------------------------------------------------
# prefetch and checkpoints
# ---------------------------------------------------------------------------

_PREFETCH_END = object()


def _prefetch(gen, depth: int = 2):
    """Run ``gen`` on a daemon thread, keeping up to ``depth`` items queued, so
    host-side batch preparation and the upload overlap the previous step.
    Exceptions re-raise in the consumer; a consumer that stops early sets a
    stop event that releases the worker."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not _put((True, item)):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises it
            _put((False, e))
            return
        _put((True, _PREFETCH_END))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            ok, item = q.get()
            if not ok:
                raise item
            if item is _PREFETCH_END:
                return
            yield item
    finally:
        stop.set()


def _save(obj, path: str) -> None:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


class CheckpointManager:
    """``epoch_%04d.ckpt`` per save, ``latest.ckpt`` stamped epoch + 1 (a
    restart resumes the next epoch), ``best.ckpt``, and retention:
    ``keep_last`` keeps the newest ``keep_last`` epochs, ``milestone`` the
    newest and every multiple of ``milestone_interval``, ``keep_all`` all."""

    def __init__(self, ckpt_dir: str, strategy: str = "keep_last", keep_last: int = 20,
                 milestone_interval: int = 50):
        self.ckpt_dir = ckpt_dir
        self.strategy = strategy
        self.keep_last = keep_last
        self.milestone_interval = milestone_interval
        os.makedirs(ckpt_dir, exist_ok=True)

    def _epoch_path(self, epoch: int) -> str:
        return os.path.join(self.ckpt_dir, f"epoch_{epoch:04d}.ckpt")

    def save(self, payload: dict, epoch: int, is_best: bool = False) -> None:
        _save(payload, self._epoch_path(epoch))
        _save(dict(payload, epoch=epoch + 1), os.path.join(self.ckpt_dir, "latest.ckpt"))
        if is_best:
            _save(payload, os.path.join(self.ckpt_dir, "best.ckpt"))
        self.cleanup()

    def epochs_on_disk(self) -> List[int]:
        out = []
        for p in glob.glob(os.path.join(self.ckpt_dir, "epoch_*.ckpt")):
            m = re.match(r"epoch_(\d+)\.ckpt$", os.path.basename(p))
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def cleanup(self) -> None:
        if self.strategy == "keep_all":
            return
        epochs = self.epochs_on_disk()
        to_delete = []
        if self.strategy == "keep_last":
            to_delete = epochs[: -self.keep_last] if self.keep_last > 0 else []
        elif self.strategy == "milestone":
            to_delete = [e for e in epochs[:-1]
                         if self.milestone_interval <= 0 or e % self.milestone_interval != 0]
        for e in to_delete:
            try:
                os.remove(self._epoch_path(e))
            except OSError:
                pass

    def disk_usage_mb(self) -> float:
        return sum(os.path.getsize(p) for p in glob.glob(os.path.join(self.ckpt_dir, "*.ckpt"))) / 1e6

    def load_latest(self) -> Optional[dict]:
        path = os.path.join(self.ckpt_dir, "latest.ckpt")
        if not os.path.exists(path):
            epochs = self.epochs_on_disk()
            if not epochs:
                return None
            path = self._epoch_path(epochs[-1])
        return torch.load(path, map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


class Trainer:
    """Epoch trainer.  ``net`` holds the initial weights on its device; the
    train and eval steps run there.  Subclass hooks: ``post_batch``,
    ``vis_step``.

    With ``mesh`` (a ``("data", "rays")`` mesh over the ranks of a process
    group) every rank loads the same batches with the same host generator,
    starts from rank 0's weights and steps on its slice; rank 0 alone writes
    checkpoints, visuals and TensorBoard events, and every rank checks after
    a resume that the replicas agree."""

    def __init__(self, net: PixelNeRFNet, train_dataset, test_dataset, renderer: NeRFRenderer,
                 args, conf, mesh: Optional[Mesh] = None):
        self.net = net
        self.mesh = mesh
        self.is_main = launch.is_main()
        self.renderer = renderer
        self.args = args
        self.conf = conf
        self.device = next(net.parameters()).device
        train_conf = conf["train"] if "train" in conf else None

        def tc(key, default):
            if train_conf is None:
                return default
            getter = {int: train_conf.get_int, float: train_conf.get_float,
                      bool: train_conf.get_bool, str: train_conf.get_string}[type(default)]
            return getter(key, default)

        self.print_interval = tc("print_interval", 2)
        self.save_interval = tc("save_interval", 50)
        self.vis_interval = tc("vis_interval", 100)
        self.eval_interval = tc("eval_interval", 50)
        self.num_epoch_repeats = tc("num_epoch_repeats", 1)
        self.num_epochs = args.epochs
        self.accu_grad = tc("accu_grad", 1)
        self.use_amp = getattr(args, "use_amp", tc("use_amp", True))
        # remat defaults off when the field's backward is the kernel (it
        # saves only its inputs and recomputes), on for the plain field
        remat = getattr(args, "remat", None)
        if remat is None and train_conf is not None and "remat" in train_conf:
            remat = train_conf.get_bool("remat")
        if remat is None:
            max_nviews = max(int(v) for v in str(getattr(args, "nviews", "1")).split())
            remat = not net.field_backward_in_kernel(max_nviews)
        self.remat = bool(remat)
        self.grad_clip = getattr(args, "grad_clip", tc("grad_clip", 0.0))
        self.check_gradients = getattr(args, "check_gradients", tc("check_gradients", False))
        # --profile_dir: a torch.profiler trace (host and device) of train
        # steps 3-5, as the JAX trainer traces them; steps 1-2 absorb the
        # kernels' build and the profiler's warm-up
        self.profile_dir = getattr(args, "profile_dir", None)
        self._profiler = None  # open only inside start()

        batch_size = getattr(args, "batch_size", tc("batch_size", 4))
        cache_mb = conf["data"].get_float("cache_mb", 4096.0) if "data" in conf else 4096.0
        self.train_loader = DataLoader(train_dataset, batch_size=batch_size, shuffle=True, seed=0,
                                       cache_mb=cache_mb)
        self.test_loader = DataLoader(test_dataset, batch_size=min(batch_size, 4), shuffle=True,
                                      seed=1, cache_mb=cache_mb / 4)
        self.z_near = train_dataset.z_near
        self.z_far = train_dataset.z_far

        # --- optimizer and lr schedule ---
        steps_per_epoch = max(1, len(self.train_loader) * self.num_epoch_repeats)
        lr = getattr(args, "lr", None) or tc("lr", 1e-4)
        gamma = getattr(args, "gamma", 1.0)
        policy = tc("lr_policy", "exp" if gamma != 1.0 else "const")
        epochs = int(getattr(args, "epochs", 0) or 0)
        self._schedule = make_schedule(
            policy, lr, steps_per_epoch, gamma=gamma,
            decay_epochs=tc("lr_decay_epochs", 50), decay_factor=tc("lr_decay_factor", 0.5),
            warmup_steps=tc("lr_warmup_steps", 100),
            # args.epochs defaults to an unbounded sentinel (10,000,000)
            total_steps=tc("lr_total_steps",
                           steps_per_epoch * epochs if 0 < epochs < 10_000_000 else 0)
            if policy == "cosine" else 0,
        )
        self.optimizer = Optimizer(
            list(net.parameters()), self._schedule, beta1=tc("beta1", 0.9),
            beta2=tc("beta2", 0.999), weight_decay=tc("weight_decay", 0.0),
            clip=self.grad_clip if self.check_gradients and self.grad_clip > 0 else 0.0,
            accu_grad=self.accu_grad,
        )

        # --- losses ---
        loss_conf = conf["loss"] if "loss" in conf else None
        if loss_conf is not None:
            self.lambda_coarse = loss_conf.get_float("lambda_coarse", 1.0)
            self.lambda_fine = loss_conf.get_float("lambda_fine", 1.0)
            crit_c = get_rgb_loss(loss_conf["rgb"], coarse=True)
            fine_sub = loss_conf["rgb_fine"] if "rgb_fine" in loss_conf else loss_conf["rgb"]
            crit_f = get_rgb_loss(fine_sub, coarse=False)
        else:
            self.lambda_coarse = self.lambda_fine = 1.0
            crit_c = crit_f = l2_loss
        self.alpha_crit = None
        if loss_conf is not None and "alpha" in loss_conf:
            crit_a = get_alpha_loss(loss_conf["alpha"])
            if crit_a.lambda_alpha > 0.0:
                self.alpha_crit = crit_a
        self.lambda_alpha_mask = (loss_conf.get_float("lambda_alpha_mask", 0.0)
                                  if loss_conf is not None else 0.0)
        self.use_viewdirs = net.use_viewdirs
        self._train_step, self._eval_step = make_step_fns(
            net, self.optimizer, lambda: self.renderer.cfg, self.lambda_coarse, self.lambda_fine,
            crit_c, crit_f, self.use_viewdirs, amp=self.use_amp, remat=self.remat,
            alpha_crit=self.alpha_crit, lambda_alpha_mask=self.lambda_alpha_mask,
            reduce_mean=launch.all_reduce_mean if mesh is not None else None,
        )
        self._data_shard = None
        if mesh is not None:
            launch.broadcast_params(net)
            if mesh.shape["data"] > 1:
                self._data_shard = DataShard(group=mesh.group("data"))
            set_data_shard(net, self._data_shard)

        # --- bookkeeping ---
        self.epoch = 0
        self.global_step = 0
        self.best_val_loss = float("inf")
        self.ckpt_dir = os.path.join(args.checkpoints_path, args.name)
        self.ckpt_manager = CheckpointManager(
            self.ckpt_dir, strategy=tc("ckpt_strategy", "keep_last"),
            keep_last=tc("keep_last", 20), milestone_interval=tc("milestone_interval", 50),
        )
        self.visual_path = os.path.join(args.visual_path, args.name)
        self.writer = None
        if self.is_main:
            os.makedirs(self.visual_path, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(os.path.join(args.logs_path, args.name))
            except Exception as e:
                print(f"TensorBoard writer unavailable: {e}")
        self.rng = np.random.default_rng(getattr(args, "seed", 1234))
        # the render's draws; seeded as the JAX Trainer's default key is
        self.generator = torch.Generator(device=self.device).manual_seed(7)
        self.use_bbox = getattr(args, "no_bbox_step", 100000) > 0
        self.fg_sample_frac = tc("fg_sample_frac", 0.0)
        self.nviews: List[int] = [int(x) for x in str(getattr(args, "nviews", "1")).split()]
        self.step_seconds: List[float] = []  # host time of each train step, synchronized
        self.history: List[float] = []  # total loss of each train step
        self.grad_norms: List[float] = []  # gradient norm of each train step

        if getattr(args, "resume", False):
            self.load_checkpoint()

    # -------------------- checkpoint payload --------------------
    def _payload(self) -> dict:
        return {
            "epoch": self.epoch,
            "global_step": self.global_step,
            "best_val_loss": self.best_val_loss,
            "model": self.net.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "renderer": self.renderer.state_dict(),
        }

    def save_checkpoint(self, is_best: bool = False) -> None:
        """Rank 0 writes; the other ranks wait for it."""
        if self.is_main:
            self.ckpt_manager.save(self._payload(), self.epoch, is_best=is_best)
            print(f"Saved checkpoint epoch {self.epoch} "
                  f"({self.ckpt_manager.disk_usage_mb():.1f} MB on disk)")
        launch.barrier()

    def load_checkpoint(self) -> bool:
        payload = self.ckpt_manager.load_latest()
        if payload is None:
            print("No checkpoint found; starting fresh")
            return False
        self.epoch = int(payload["epoch"])
        self.global_step = int(payload["global_step"])
        self.best_val_loss = float(payload["best_val_loss"])
        self.net.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.renderer.load_state_dict(payload["renderer"])
        # epoch / global_step consistency auto-repair
        steps_per_epoch = len(self.train_loader) * self.num_epoch_repeats
        expected = self.epoch * steps_per_epoch
        if steps_per_epoch > 0 and abs(self.global_step - expected) > steps_per_epoch:
            print(f"WARNING: checkpoint global_step {self.global_step} inconsistent with epoch "
                  f"{self.epoch} (expected ~{expected}); auto-correcting")
            self.global_step = expected
        if self.mesh is not None:
            launch.check_replicas(list(self.net.state_dict().values()), "the resumed weights")
        print(f"Resumed from epoch {self.epoch}, step {self.global_step}")
        return True

    # -------------------- steps --------------------
    def _prep(self, data, is_train: bool = True) -> Optional[dict]:
        nviews = int(self.nviews[self.rng.integers(0, len(self.nviews))])
        return prepare_ray_batch(
            data, nviews, self.args.ray_batch_size, self.z_near, self.z_far,
            is_train and self.use_bbox, self.rng,
            fg_frac=self.fg_sample_frac if is_train else 0.0,
        )

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in batch.items()}

    def _maybe_flip_bbox(self) -> None:
        """One-shot switch from bbox to uniform ray sampling at no_bbox_step;
        with prefetch it takes effect on batches prepared after this point."""
        if self.use_bbox and self.global_step >= getattr(self.args, "no_bbox_step", 100000):
            self.use_bbox = False
            print(">>> Stopped using bbox sampling @ iter", self.global_step)

    def _shard(self, batch: dict, draws: Optional[RayDraws], training: bool):
        """This rank's slice of a whole batch, and its draws as a function
        that makes the whole batch's draws (after the encoder's) and takes
        this rank's rows; the data shard set for the encoder."""
        SB, B = batch["rays"].shape[:2]
        obj, ray = axis_slice(SB, self.mesh, "data"), axis_slice(B, self.mesh, "rays")
        if self._data_shard is not None:
            split = obj != slice(None)
            self._data_shard.count = self.mesh.shape["data"] if split else 1
            self._data_shard.index = self.mesh.coords["data"] if split else 0
        local = {k: v.contiguous() for k, v in shard_batch(self.mesh, batch).items()}

        def mine(generator, cfg: RenderConfig) -> RayDraws:
            full = complete_draws(cfg, SB, B, generator, draws, training=training)
            return draw_rows(full, SB, B, obj, ray)

        return local, mine

    def _device_train_step(self, batch: dict, draws: Optional[RayDraws] = None):
        span = (torch.profiler.record_function(f"train_step_{self._profiler.step_num + 1}")
                if self._profiler is not None else contextlib.nullcontext())
        if self.mesh is not None:
            batch, draws = self._shard(batch, draws, training=True)
        with span:
            t0 = time.perf_counter()
            loss_dict = self._train_step(batch, self.generator, draws)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.step_seconds.append(time.perf_counter() - t0)
        self.history.append(float(loss_dict["t"]))
        self.grad_norms.append(float(loss_dict["grad_norm"]))
        self.global_step += 1
        if self._profiler is not None:
            self._profiler.step()
        return loss_dict

    def _profile(self):
        """The ``--profile_dir`` profiler, or a null context: it records
        steps 3-5 (each step ends synchronized, so step 2's device work
        cannot bleed in) and writes ``<profile_dir>/trace.json`` after step
        5, or on leaving the context after fewer steps."""
        if not self.profile_dir:
            return contextlib.nullcontext()
        os.makedirs(self.profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)

        def write(prof) -> None:
            path = os.path.join(self.profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            print(f"profile: trace of train steps 3-{prof.step_num} written to {path}")

        return torch.profiler.profile(
            activities=activities, on_trace_ready=write,
            schedule=torch.profiler.schedule(wait=1, warmup=1, active=3, repeat=1))

    def train_step(self, data, draws: Optional[RayDraws] = None) -> Optional[Dict[str, float]]:
        """One step on a collated batch; ``draws`` injects the render's random
        numbers (tests)."""
        self._maybe_flip_bbox()
        batch = self._prep(data, is_train=True)
        if batch is None:
            return None
        loss_dict = self._device_train_step(self._to_device(batch), draws)
        return {k: float(v) for k, v in loss_dict.items()}

    def eval_step(self, data, draws: Optional[RayDraws] = None) -> Optional[Dict[str, float]]:
        batch = self._prep(data, is_train=False)
        if batch is None:
            return None
        batch = self._to_device(batch)
        if self.mesh is not None:
            batch, draws = self._shard(batch, draws, training=False)
        loss_dict = self._eval_step(batch, self.generator, draws)
        return {k: float(v) for k, v in loss_dict.items()}

    def post_batch(self, epoch: int, batch_idx: int) -> None:
        self.renderer.sched_step(1)

    def vis_step(self, data) -> Optional[Tuple[np.ndarray, float]]:
        """(uint8 (H, W, 3) image grid, PSNR) of a test batch; None writes
        nothing (the train CLI's ``PixelNeRFTrainer`` renders one)."""
        return None

    # -------------------- loops --------------------
    def current_lr(self) -> float:
        return self.optimizer.lr()

    def _train_batches(self):
        """Producer for one epoch pass: load, sample rays, upload."""
        for batch_idx, data in enumerate(self.train_loader):
            batch = self._prep(data, is_train=True)
            if batch is not None:
                yield batch_idx, self._to_device(batch)

    def train_epoch(self) -> Dict[str, float]:
        t_start = time.time()
        if self.alpha_crit is not None:
            self.alpha_crit.epoch = self.epoch  # the prior's epoch gate
        n_batches = 0
        last: Dict[str, torch.Tensor] = {}
        for _ in range(self.num_epoch_repeats):
            self.train_loader.set_epoch(self.epoch)
            for batch_idx, batch in _prefetch(self._train_batches()):
                self._maybe_flip_bbox()
                loss_dict = self._device_train_step(batch)
                n_batches += 1
                last = loss_dict
                if self.global_step % self.print_interval == 0:
                    floats = {k: float(v) for k, v in loss_dict.items()}
                    if self.writer is not None:
                        for k, v in floats.items():
                            self.writer.add_scalar(f"train/{k}", v, self.global_step)
                        self.writer.add_scalar("train/lr", self.current_lr(), self.global_step)
                    items = " ".join(f"{k}:{v:.5f}" for k, v in floats.items())
                    s_it = (time.time() - t_start) / max(n_batches, 1)
                    print(f"E{self.epoch} B{batch_idx} {items} lr:{self.current_lr():.2e} "
                          f"{s_it:.2f}s/it")
                self.post_batch(self.epoch, batch_idx)
        return {k: float(v) for k, v in last.items()}

    def validate(self) -> float:
        losses = []
        for data in self.test_loader:
            ld = self.eval_step(data)
            if ld is not None:
                losses.append(ld["t"])
        val_loss = float(np.mean(losses)) if losses else float("inf")
        if self.writer is not None:
            self.writer.add_scalar("val/loss", val_loss, self.global_step)
        return val_loss

    def write_vis(self, epoch: int) -> None:
        """The ``vis_step`` grid of the first test batch to
        ``<epoch>_vis.png`` and TensorBoard.  Unlike the JAX trainer, a vis
        that raises stops the run: a kernel that fails to launch is not
        hidden.  Under a mesh rank 0 alone renders it, and then hands its
        host generator's state to the other ranks, so that every rank keeps
        drawing the same batches."""
        if self.mesh is not None:
            if self.is_main:
                self._write_vis(epoch)
            self.rng.bit_generator.state = launch.broadcast_object(self.rng.bit_generator.state)
            return
        self._write_vis(epoch)

    def _write_vis(self, epoch: int) -> None:
        data = next(iter(self.test_loader), None)
        if data is None:
            print("vis: the test set is empty; no visuals written")
            return
        vis = self.vis_step(data)
        if vis is None:
            return
        vis_img, vis_psnr = vis
        path = os.path.join(self.visual_path, f"{epoch:04d}_vis.png")
        write_png(path, np.ascontiguousarray(vis_img))
        if self.writer is not None:
            self.writer.add_image("vis", vis_img.transpose(2, 0, 1), self.global_step)
            self.writer.add_scalar("vis/psnr", vis_psnr, self.global_step)
        print(f"Wrote vis to {path} (psnr {vis_psnr:.2f})")

    def start(self) -> None:
        """Train from ``self.epoch`` to ``num_epochs``, validating and saving
        at their intervals and after the last epoch."""
        with (self._profile() if self.is_main else contextlib.nullcontext()) as self._profiler:
            for epoch in range(self.epoch, self.num_epochs):
                self.epoch = epoch
                self.train_epoch()
                is_best = False
                if (epoch + 1) % self.eval_interval == 0 or epoch == self.num_epochs - 1:
                    val_loss = self.validate()
                    print(f"Epoch {epoch}: val loss {val_loss:.5f}")
                    if val_loss < self.best_val_loss:
                        self.best_val_loss = val_loss
                        is_best = True
                if (epoch + 1) % self.save_interval == 0 or epoch == self.num_epochs - 1:
                    self.save_checkpoint(is_best=is_best)
                if (epoch + 1) % self.vis_interval == 0:
                    self.write_vis(epoch)
        self._profiler = None
        if self.writer is not None:
            self.writer.flush()
        self.epoch = self.num_epochs
