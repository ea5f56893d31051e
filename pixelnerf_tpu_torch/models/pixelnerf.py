"""PixelNeRF network: encode source views, query the conditioned field.

* ``encode``: ResNet feature map per source view -- or, multi-scale, the
  per-stage pyramid, optionally gated by the adaptive sampler and fused
  into one 512-channel map (``use_smart_fusion``); or the ConvEncoder's map
  (``encoder.type = conv``); and, with ``use_global_encoder``, each view's
  global code; poses inverted to world->camera; focal y negated; principal
  point defaults to the image center.  Returns an :class:`EncodedScene`
  that ``query`` takes explicitly.
* ``query``: world points into each source camera's frame, positional code
  of xyz with the raw viewdirs appended after it, perspective projection
  ``uv = -xy/z * [fx, -fy] + c``, pixel-aligned features (bilinear or
  nearest) after the view's global code, the field MLP (ResnetFC or
  ImplicitNet), then ``sigmoid(rgb)`` and the configured density activation.

The feature lookup takes one of two routes, chosen as in the JAX package
(:meth:`PixelNeRFNet._fused_gather_ok`): fused into the field kernel as a
:class:`~..ops.resnetfc_fused.LatentGather`, or gathered densely first (a
raw multi-scale pyramid, a global code, a nearest lookup and the
ConvEncoder always are).  Training builds the model with
``diff_mode=True``, which keeps every field input dense so the field stays
differentiable on the kernel route.

With ``PIXELNERF_DEFER_CODE=1`` (read per call; off by default, as in the
JAX package) an eval query hands the field the raw coordinates and the flat
code arrays as a :class:`~..ops.resnetfc_fused.RawCode`: the forward kernels
evaluate the positional code in-register, and the plain route materializes
the same math.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config.hocon import ConfigTree
from ..ops.resnetfc_fused import (FWD_HIDDEN, TILE_LIMITS, LatentGather, RawCode, library_width,
                                  supports)
from ..utils.geometry import invert_poses, repeat_interleave
from .code import PositionalEncoding
from .custom_encoder import ConvEncoder
from .encoder import GlobalEncoder, SpatialEncoder
from .fusion import AdaptiveFeatureSampler, SmartFeatureFusion, reset_fusion_parameters
from .mlp import ImplicitNet
from .resnetfc import ResnetFC


def _defer_code_enabled() -> bool:
    """Whether query passes the positional code as a deferred RawCode
    (opt-in via ``PIXELNERF_DEFER_CODE=1``, read on every call)."""
    return os.environ.get("PIXELNERF_DEFER_CODE", "0") == "1"


Latents = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


@dataclasses.dataclass
class EncodedScene:
    """Everything ``query`` needs about the conditioned source views.
    Shapes use B = SB * NS (object superbatch x source views, flattened)."""

    latents: Latents  # (B, H_l, W_l, C) map, or a tuple of per-scale maps
    poses: torch.Tensor  # (B, 3, 4) world -> camera
    focal: torch.Tensor  # (B, 2) [fx, -fy] in pixels
    c: torch.Tensor  # (B, 2) principal point in pixels
    image_shape: Tuple[int, int] = (0, 0)  # (W, H)
    num_views_per_obj: int = 1
    global_latent: Optional[torch.Tensor] = None  # (B, C_g) with use_global_encoder; stays f32

    @property
    def device(self) -> torch.device:
        return self.poses.device

    def cast(self, dtype: torch.dtype) -> "EncodedScene":
        """The scene with every latent map (the one map, or each map of a raw
        pyramid) in ``dtype``."""
        lat = self.latents
        lat = tuple(t.to(dtype) for t in lat) if isinstance(lat, tuple) else lat.to(dtype)
        return dataclasses.replace(self, latents=lat)


def _make_mlp(conf: ConfigTree, d_in: int, d_latent: int, allow_empty=False, impl="torch"):
    mlp_type = conf.get_string("type", "mlp")
    if mlp_type == "mlp":
        return ImplicitNet.from_conf(conf, d_in + d_latent)
    if mlp_type == "resnet":
        return ResnetFC.from_conf(conf, d_in=d_in, d_latent=d_latent, impl=impl)
    if mlp_type == "empty" and allow_empty:
        return None
    raise NotImplementedError(f"Unsupported MLP type {mlp_type!r}")


class PixelNeRFNet(nn.Module):
    """Conditioned NeRF field.  Construct with :func:`make_model`.

    :param mlp_impl: "torch" | "cuda" | "auto" -- the ResnetFC ``impl``, and
        whether the fused-gather route is open (the counterparts of the JAX
        package's "xla" | "pallas" | "auto")
    :param stop_encoder_grad: detach the sampled latents (``--freeze_enc``)
    :param diff_mode: training construction: no fused gather, so the field's
        inputs stay dense and differentiable
    """

    # 64px-class feature maps (<= 2048 rows) ride the fused-gather route
    FUSED_GATHER_MAX_ROWS = 2048

    def __init__(self, conf: ConfigTree, mlp_impl: str = "torch",
                 stop_encoder_grad: bool = False, diff_mode: bool = False):
        super().__init__()
        self.mlp_impl = mlp_impl
        self.stop_encoder_grad = stop_encoder_grad
        self.diff_mode = diff_mode
        self.use_encoder = conf.get_bool("use_encoder", True)
        self.use_xyz = conf.get_bool("use_xyz", False)
        assert self.use_encoder or self.use_xyz
        self.normalize_z = conf.get_bool("normalize_z", True)
        self.use_code = conf.get_bool("use_code", False)
        self.use_code_viewdirs = conf.get_bool("use_code_viewdirs", True)
        self.use_viewdirs = conf.get_bool("use_viewdirs", False)
        self.use_global_encoder = conf.get_bool("use_global_encoder", False)
        self.sigma_activation = conf.get_string("sigma_activation", "relu")
        if self.sigma_activation not in ("relu", "softplus", "softplus_floor"):
            raise NotImplementedError(f"Unsupported sigma_activation {self.sigma_activation!r}")

        enc_type = conf.get_string("encoder.type", "spatial")
        if enc_type == "spatial":
            self.encoder = SpatialEncoder.from_conf(conf["encoder"])
        elif enc_type == "conv":
            self.encoder = ConvEncoder.from_conf(conf["encoder"])
        else:
            raise NotImplementedError(f"Unsupported encoder type {enc_type!r}")

        # the fork's multi-scale fusion: the adaptive gate on the raw
        # pyramid, then the fusion into one 512-channel map
        self.is_multi_scale = self.encoder.use_multi_scale
        self.use_smart_fusion = conf.get_bool("use_smart_fusion", False) and self.is_multi_scale
        self.use_adaptive_sampling = (conf.get_bool("use_adaptive_sampling", False)
                                      and self.is_multi_scale)
        layer_dims = self.encoder.latent_sizes
        self.feature_fusion = self.adaptive_sampler = None
        if self.use_smart_fusion:
            self.feature_fusion = SmartFeatureFusion(
                layer_dims, output_dim=512,
                use_attention=conf.get_string("fusion_type", "attention") == "attention",
                dropout=conf.get_float("fusion_dropout", 0.0),
                num_heads=conf.get_int("fusion_heads", 8), use_cbam=conf.get_bool("use_cbam", True))
        if self.use_adaptive_sampling:
            self.adaptive_sampler = AdaptiveFeatureSampler(
                layer_dims[-1], conf.get_float("quality_threshold", 0.3), layer_dims=layer_dims)
        self.latent_size = 512 if self.use_smart_fusion else sum(layer_dims)

        d_latent = self.latent_size if self.use_encoder else 0
        d_in = 3 if self.use_xyz else 1
        if self.use_viewdirs and self.use_code_viewdirs:
            d_in += 3
        self.code = None
        if self.use_code and d_in > 0:
            self.code = PositionalEncoding.from_conf(conf["code"], d_in=d_in)
            d_in = self.code.d_out
        if self.use_viewdirs and not self.use_code_viewdirs:
            d_in += 3
        # the global code comes before the pixel latent in every query
        self.global_encoder = None
        if self.use_global_encoder:
            self.global_encoder = GlobalEncoder.from_conf(
                conf["global_encoder"] if "global_encoder" in conf else ConfigTree())
            d_latent += self.global_encoder.latent_size
        self.d_in, self.d_latent, self.d_out = d_in, d_latent, 4

        self.mlp_coarse = _make_mlp(conf["mlp_coarse"], d_in, d_latent, impl=mlp_impl)
        self.mlp_fine = _make_mlp(
            conf["mlp_fine"], d_in, d_latent, allow_empty=True, impl=mlp_impl
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: kaiming fan-out normal convs (torchvision's init),
        unit / zero BatchNorm, the global encoder's ``fc`` and the fusion
        stack LeCun-normal, flax's init of the ConvEncoder, and the ResnetFC
        reference init or ImplicitNet's geometric init."""
        if isinstance(self.encoder, ConvEncoder):
            self.encoder.reset_parameters(generator)
        trunks = [m for m in (self.encoder, self.global_encoder)
                  if isinstance(m, (SpatialEncoder, GlobalEncoder))]
        with torch.no_grad():
            for m in (m for t in trunks for m in t.modules()):
                if isinstance(m, nn.Conv2d):
                    fan_out = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
                    m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                                   * (2.0 / fan_out) ** 0.5)
                elif isinstance(m, nn.BatchNorm2d):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                    m.num_batches_tracked.zero_()
                elif isinstance(m, nn.Linear):
                    m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                                   * (1.0 / m.weight.shape[1]) ** 0.5)
                    m.bias.zero_()
        for stage in (self.adaptive_sampler, self.feature_fusion):
            if stage is not None:
                reset_fusion_parameters(stage, generator)
        for mlp in (self.mlp_coarse, self.mlp_fine):
            if mlp is not None:
                mlp.reset_parameters(generator)

    # ---------------------------- encode ----------------------------
    def encode(self, images: torch.Tensor, poses: torch.Tensor, focal, c=None,
               train: bool = False, generator: Optional[torch.Generator] = None) -> EncodedScene:
        """:param images: (SB, NS, H, W, 3) or (NS, H, W, 3), values in [-1, 1]
        :param poses: matching (..., 4, 4) camera-to-world
        :param focal: () | (2,) | (NS,) | (NS, 2) [fx, fy]
        :param c: principal point, same shape options, default image center
        :param train: run the encoder's and the fusion's BatchNorm on batch
            statistics and update their running statistics, and the fusion's
            dropout (the JAX ``train=True``)
        :param generator: the fusion dropout's draws (train mode with
            ``fusion_dropout`` > 0; on the images' device)
        """
        if images.ndim == 5:
            num_views_per_obj = images.shape[1]
            images = images.reshape((-1,) + tuple(images.shape[2:]))
            poses = poses.reshape(-1, 4, 4)
        else:
            num_views_per_obj = 1
        B, H, W = images.shape[0], images.shape[1], images.shape[2]
        dev = images.device

        for stage in (self.encoder, self.global_encoder, self.adaptive_sampler,
                      self.feature_fusion):
            if stage is not None:
                stage.train(train)
        latents = self.encoder(images)
        if self.use_adaptive_sampling:
            latents = self.adaptive_sampler(latents)
        if self.use_smart_fusion:
            latents = self.feature_fusion(latents, generator=generator)
        if isinstance(latents, list):
            latents = tuple(latents)
        w2c = invert_poses(poses)

        def norm_intrinsic(x):
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
            if x.ndim == 0:
                x = x[None, None].expand(1, 2)
            elif x.ndim == 1:
                x = x[:, None].expand(x.shape[0], 2)
            else:
                x = x.reshape(-1, x.shape[-1])
            if x.shape[0] == 1:
                return x.expand(B, 2)
            if x.shape[0] != B:
                assert B % x.shape[0] == 0, (x.shape, B)
                return repeat_interleave(x, B // x.shape[0])
            return x

        focal = norm_intrinsic(focal) * torch.tensor([1.0, -1.0], device=dev)  # -fy
        if c is None:
            c = torch.tensor([[W * 0.5, H * 0.5]], dtype=torch.float32, device=dev).expand(B, 2)
        else:
            c = norm_intrinsic(c)
        return EncodedScene(
            latents=latents, poses=w2c, focal=focal, c=c,
            image_shape=(W, H), num_views_per_obj=num_views_per_obj,
            global_latent=self.global_encoder(images) if self.use_global_encoder else None,
        )

    # ----------------------------- route -----------------------------
    @staticmethod
    def _fused_gather_cap() -> int:
        """Read per call, so PIXELNERF_FUSED_GATHER_MAX_ROWS applies whenever set."""
        return int(os.environ.get("PIXELNERF_FUSED_GATHER_MAX_ROWS",
                                  PixelNeRFNet.FUSED_GATHER_MAX_ROWS))

    def _fused_gather_ok(self, latents: Latents, NS: int) -> bool:
        """Whether the pixel-aligned lookup rides the fused field kernel."""
        if self.mlp_impl not in ("cuda", "auto"):
            return False
        if self.diff_mode:  # the fused-gather kernel has no backward
            return False
        if isinstance(latents, (list, tuple)):
            # a raw pyramid: per-scale tables of mixed resolutions, dense.
            # Fused, the pyramid is one map and qualifies as single-scale.
            return False
        if self.use_global_encoder:  # the field's latent is [g, pixel latent]
            return False
        if not isinstance(self.encoder, SpatialEncoder):
            # the ConvEncoder has no index_taps (the JAX rule does not look
            # at the encoder type and raises there: ROADMAP.md, reference gaps)
            return False
        if latents.shape[0] != NS:  # SB == 1: one table set per call
            return False
        for mlp in (self.mlp_coarse, self.mlp_fine):
            if mlp is None:
                continue
            if not isinstance(mlp, ResnetFC):  # the lookup is a ResnetFC kernel's input
                return False
            if NS > 1 and not (0 <= mlp.combine_layer < mlp.n_blocks):
                return False
            # a table wider than the gathers take (the mirror of the library
            # the width runs on) is looked up densely, so the field never
            # reaches a gather that refuses it; the JAX rule everywhere else
            lim = (TILE_LIMITS[library_width(mlp.d_hidden)]
                   if 1 <= mlp.d_hidden <= FWD_HIDDEN[-1] else None)
            if lim is not None and mlp.n_lin_z > 0 and mlp.d_latent > lim.max_gather_c:
                return False
        if self.encoder.index_interp != "bilinear":
            return False
        return NS * latents.shape[1] * latents.shape[2] <= self._fused_gather_cap()

    @contextlib.contextmanager
    def eval_routes(self):
        """Within: a ``diff_mode`` model takes the eval-only routes (the
        fused gather, the deferred code) as an eval model does; for renders
        under ``torch.no_grad()``, such as the trainer's visuals."""
        diff_mode, self.diff_mode = self.diff_mode, False
        try:
            yield self
        finally:
            self.diff_mode = diff_mode

    def field_backward_in_kernel(self, max_nviews: int = 1) -> bool:
        """True when train steps route the field through the backward kernel
        (:mod:`..ops.resnetfc_vjp`): dense inputs (``diff_mode``), both heads
        ResnetFC inside the kernels' envelope (config and, for ``auto``, the
        backward's widths), card parameters for ``auto``.  The kernel route
        saves only its inputs and recomputes in the backward, so the trainer
        leaves ``remat`` off for it."""
        if not (self.diff_mode and self.mlp_impl in ("cuda", "auto")):
            return False
        if self.mlp_impl == "auto" and next(self.parameters()).device.type != "cuda":
            return False
        for mlp in (self.mlp_coarse, self.mlp_fine):
            if mlp is None:
                continue
            if not isinstance(mlp, ResnetFC):
                return False
            if not supports(mlp.beta, mlp.use_spade, mlp.combine_type):
                return False
            if max_nviews > 1 and not mlp.combine_layer < mlp.n_blocks:
                return False
            if self.mlp_impl == "auto":
                try:
                    mlp.check_kernel_widths(max_nviews, grad=True)
                except ValueError:
                    return False
        return True

    # ----------------------------- query -----------------------------
    def forward(self, scene: EncodedScene, xyz: torch.Tensor, viewdirs=None, coarse: bool = True,
                planar_out: bool = False, compute_dtype=None) -> torch.Tensor:
        """:meth:`query`, so that ``torch.func.functional_call`` can run the
        field with substituted (e.g. bf16) parameters."""
        return self.query(scene, xyz, viewdirs, coarse, planar_out, compute_dtype)

    def query(self, scene: EncodedScene, xyz: torch.Tensor, viewdirs: Optional[torch.Tensor] = None,
              coarse: bool = True, planar_out: bool = False, compute_dtype=None) -> torch.Tensor:
        """Predict (r, g, b, sigma) at world points.

        :param xyz: (SB, B, 3) world-space points
        :param viewdirs: (SB, B, 3) if use_viewdirs
        :param planar_out: return channel-major (SB, 4, B)
        :param compute_dtype: cast the field's inputs -- the latent and the
            *encoded* coordinate code, never the raw coordinates -- to this
            dtype (the AMP path with bf16 parameters); None keeps f32
        :return: (SB, B, 4) with rgb in [0, 1] and sigma >= 0; (SB, 4, B) when
            ``planar_out``
        """
        SB, B, _ = xyz.shape
        NS = scene.num_views_per_obj
        poses = scene.poses
        rot = poses[:, :3, :3]

        xyz_rep = repeat_interleave(xyz.float(), NS)
        xyz_rot = torch.einsum("nij,nbj->nbi", rot, xyz_rep)
        xyz_cam = xyz_rot + poses[:, None, :3, 3]

        mlp_input = None
        if self.d_in > 0:
            # training keeps the code dense: the deferred code has no backward
            defer_code = self.use_code and _defer_code_enabled() and not self.diff_mode
            if self.use_xyz:
                z_feature = xyz_rot if self.normalize_z else xyz_cam
            else:
                src = xyz_rot if self.normalize_z else xyz_cam
                z_feature = -src[..., 2:3]
            if self.use_code and not self.use_code_viewdirs and not defer_code:
                z_feature = self.code(z_feature)
            if self.use_viewdirs:
                assert viewdirs is not None
                vd = repeat_interleave(viewdirs.float(), NS)
                vd = torch.einsum("nij,nbj->nbi", rot, vd)
                z_feature = torch.cat([z_feature, vd], dim=-1)
            if self.use_code and self.use_code_viewdirs and not defer_code:
                z_feature = self.code(z_feature)
            if defer_code:
                # the raw (~6 column) features and the flat code arrays; a
                # viewdir tail after the code rides the same select matrix,
                # so the layout equals [code(x), vd]
                tail = 3 if (self.use_viewdirs and not self.use_code_viewdirs) else 0
                mlp_input = RawCode(z_feature, *(torch.from_numpy(a).to(xyz.device)
                                                 for a in self.code.flat_arrays(tail=tail)))
            else:
                mlp_input = z_feature

        latent = None
        if self.use_encoder:
            # the divisor is clamped away from 0 keeping its sign, so samples
            # crossing a source camera's z=0 plane give no inf/NaN
            z_cam = xyz_cam[..., 2:3]
            denom = torch.where(
                z_cam.abs() < 1e-8,
                torch.where(z_cam >= 0, torch.full_like(z_cam, 1e-8), torch.full_like(z_cam, -1e-8)),
                z_cam,
            )
            uv = -xyz_cam[..., :2] / denom
            uv = uv * scene.focal[:, None] + scene.c[:, None]
            latents = scene.latents
            if self._fused_gather_ok(latents, NS):
                C = latents.shape[-1]
                table = latents.reshape(-1, C) if NS == 1 else latents.reshape(NS, -1, C)
                if self.stop_encoder_grad:
                    table = table.detach()
                t_idx, t_w = self.encoder.index_taps(latents, uv, scene.image_shape)
                latent = LatentGather(table, t_idx, t_w)
            else:
                latent = self.encoder.index(latents, uv, scene.image_shape)
                if self.stop_encoder_grad:
                    latent = latent.detach()
        if self.use_global_encoder:
            # the view's global code before its pixel latent (lin_z's rows
            # follow that order); --freeze_enc leaves it trained, as in JAX
            g = scene.global_latent[:, None].expand(-1, B, -1)
            latent = g if latent is None else torch.cat([g.to(latent.dtype), latent], dim=-1)

        is_gather = isinstance(latent, LatentGather)
        if mlp_input is None:
            mlp_input = (
                torch.zeros(xyz_cam.shape[:-1] + (0,), device=xyz.device)
                if is_gather or latent is None
                else latent[..., :0]
            )
        if isinstance(mlp_input, RawCode):
            # the raw coordinates are never cast: rounding them to bf16 before
            # the sin is ~0.4 rad of phase at the top frequency.  Under AMP
            # the marker casts the f32-encoded output instead.
            flat_x = mlp_input._replace(x=mlp_input.x.reshape(-1, mlp_input.x.shape[-1]),
                                        cd=compute_dtype)
        else:
            flat_x = mlp_input.reshape(-1, mlp_input.shape[-1])
            if compute_dtype is not None:
                flat_x = flat_x.to(compute_dtype)
        if is_gather:
            flat_z = LatentGather(
                latent.table if compute_dtype is None else latent.table.to(compute_dtype),
                latent.idx.reshape(-1, latent.idx.shape[-1]),
                latent.w.reshape(-1, latent.w.shape[-1]),
            )
        elif latent is not None:
            flat_z = latent.reshape(-1, latent.shape[-1])
            if compute_dtype is not None:
                flat_z = flat_z.to(compute_dtype)
        else:
            flat_z = None
        arg = (flat_z, flat_x) if flat_z is not None or isinstance(flat_x, RawCode) else flat_x
        mlp = self.mlp_coarse if (coarse or self.mlp_fine is None) else self.mlp_fine
        out = mlp(arg, combine_inner_dims=(NS, B), planar_out=planar_out).float()

        if planar_out:
            # the kernels return flat columns (1, d_out, SB*B) with column
            # s*B + b; the plain forward returns (SB, d_out, B) already
            if out.shape[0] == 1 and SB > 1:
                out = out.reshape(self.d_out, SB, B).transpose(0, 1)
            else:
                out = out.reshape(SB, self.d_out, B)
            rgb = torch.sigmoid(out[:, :3])
            sigma = self._sigma_act(out[:, 3:4])
            return torch.cat([rgb, sigma], dim=1)

        out = out.reshape(SB, B, self.d_out)
        rgb = torch.sigmoid(out[..., :3])
        sigma = self._sigma_act(out[..., 3:4])
        return torch.cat([rgb, sigma], dim=-1)

    def _sigma_act(self, raw: torch.Tensor) -> torch.Tensor:
        if self.sigma_activation == "softplus":
            return F.softplus(raw)
        if self.sigma_activation == "softplus_floor":
            # straight-through clip at -4: the forward sees the clipped value,
            # the gradient passes 1 through the clip
            raw = raw + (torch.clamp(raw, min=-4.0) - raw).detach()
            return F.softplus(raw)
        return F.relu(raw)


def make_model(conf, mlp_impl: str = "torch", device=None,
               generator: Optional[torch.Generator] = None, stop_encoder_grad: bool = False,
               diff_mode: bool = False) -> PixelNeRFNet:
    """Construct the model from the ``model`` conf subtree on ``device``,
    initialised from ``generator`` (a fresh ``torch.Generator`` seeded 0 when
    not given).  Parameters are allocated once, on the target device."""
    from ..device import resolve_device

    model_type = conf.get_string("type", "pixelnerf")
    if model_type != "pixelnerf":
        raise NotImplementedError(f"Unsupported model type {model_type!r}")
    device = resolve_device(device)
    with torch.device("meta"):
        net = PixelNeRFNet(conf, mlp_impl=mlp_impl, stop_encoder_grad=stop_encoder_grad,
                           diff_mode=diff_mode)
    net = net.to_empty(device=device)
    net.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
    return net.eval()
