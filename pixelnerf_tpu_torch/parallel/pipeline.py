"""Single-device dense render of many rays: rays in chunks of
``device_chunk``, the fine (else coarse) rgb and depth out in the JAX
package's wire formats (the JAX ``RenderPipeline`` without its mesh and
occupancy accel, which are not ported yet)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.pixelnerf import EncodedScene, PixelNeRFNet
from ..render.renderer import NeRFRenderer, render_rays


def unpack_simple(pieces):
    """Fetched ``render_simple`` pieces -> (rgb (NR, 3), depth (NR,)) float32
    numpy.  Both wire formats: (n, 4) f32 [rgb | depth], and the (n, 5) uint8
    video-frame format [rgb u8 | depth f16 as 2 u8 lanes].

    :param pieces: [(packed array or tensor, true row count), ...]
    """
    packed = np.concatenate(
        [(p.cpu().numpy() if torch.is_tensor(p) else np.asarray(p))[:n] for p, n in pieces],
        axis=0)
    if packed.dtype == np.uint8:
        rgb = packed[:, :3].astype(np.float32) / 255.0
        depth = np.ascontiguousarray(packed[:, 3:5]).view(np.float16)[:, 0].astype(np.float32)
        return rgb, depth
    return packed[:, :3], packed[:, 3]


def pack_simple(rgb: torch.Tensor, depth: torch.Tensor, pack: str) -> torch.Tensor:
    """One chunk's (rgb (n, 3), depth (n,)) in a wire format: ``"f32"`` (n, 4)
    f32; ``"u8"`` (n, 5) uint8 -- rgb quantized as the video writer does it,
    depth as f16 in two byte lanes (5 bytes a ray instead of 16)."""
    if pack == "f32":
        return torch.cat([rgb, depth[:, None]], dim=-1)
    if pack == "u8":
        rgb_u8 = torch.round(rgb.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        d_u8 = depth.to(torch.float16)[:, None].contiguous().view(torch.uint8)
        return torch.cat([rgb_u8, d_u8], dim=-1)
    raise ValueError(f"pack must be 'f32' or 'u8', got {pack!r}")


class RenderPipeline:
    def __init__(self, net: PixelNeRFNet, renderer: NeRFRenderer, device_chunk: int = 8192):
        """:param device_chunk: rays rendered per step (bounds activation memory)"""
        self.net = net
        self.renderer = renderer
        self.device_chunk = device_chunk
        self.use_viewdirs = net.use_viewdirs

    def _kernel_mlp(self, scene: EncodedScene) -> bool:
        impl = self.net.mlp_impl
        return impl == "cuda" or (impl == "auto" and scene.latents.device.type == "cuda")

    def _field(self, scene: EncodedScene):
        def field(points, viewdirs, coarse):
            return self.net.query(
                scene, points, viewdirs=viewdirs if self.use_viewdirs else None,
                coarse=coarse, planar_out=True,
            )

        return field

    @torch.no_grad()
    def render_simple(self, scene: EncodedScene, rays, generator: torch.Generator,
                      ray_batch_size: int = 50000, as_numpy: bool = True, pack: str = "f32"):
        """(rgb, depth) from the fine pass if present, else the coarse one.

        :param rays: (NR, 8) rays, numpy or tensor
        :param ray_batch_size: upper bound on the rays per step
        :param pack: the wire format of each chunk (:func:`pack_simple`):
            ``"f32"``, or ``"u8"`` for a video or frame writer, never for
            quality metrics
        :return: with ``as_numpy``, (rgb (NR, 3), depth (NR,)) float32 numpy
            (:func:`unpack_simple`); else the packed chunks on the scene's
            device, ``[(packed, n), ...]``
        """
        if pack not in ("f32", "u8"):
            raise ValueError(f"pack must be 'f32' or 'u8', got {pack!r}")
        device = scene.latents.device
        rays = torch.as_tensor(np.asarray(rays) if not torch.is_tensor(rays) else rays,
                               dtype=torch.float32).to(device)
        if self._kernel_mlp(scene):
            # the kernels read bf16 features; storing the table in bf16 halves
            # its reads without changing the kernels' numerics
            scene = dataclasses.replace(scene, latents=scene.latents.to(torch.bfloat16))
        # ray chunks already bound memory: no inner point chunking
        cfg = dataclasses.replace(self.renderer.cfg, eval_batch_size=0)
        chunk = max(1, min(self.device_chunk, ray_batch_size, rays.shape[0]))
        field = self._field(scene)
        pieces = []
        for start in range(0, rays.shape[0], chunk):
            out = render_rays(field, rays[None, start : start + chunk], cfg, generator,
                              use_viewdirs=self.use_viewdirs)
            head = out["fine"] if cfg.using_fine else out["coarse"]
            packed = pack_simple(head["rgb"][0], head["depth"][0], pack)
            pieces.append((packed, packed.shape[0]))
        return unpack_simple(pieces) if as_numpy else pieces
