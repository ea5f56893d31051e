"""sn64 novel-view render from one or more source views on the card.

The port's counterpart of ``__graft_entry__.entry()`` and the core of
``eval/gen_video.py``: the ``conf/exp/sn64.conf`` model at full width (or
another recipe's, ``-c conf/exp/sn64_multiscale.conf``), views
of one 64x64 synthetic sphere as the source views (view 0 by default; more
with ``--source "0 1 2"``, as ``gen_video -P`` takes them), a
``pose_spherical`` ring of frames at radius (z_near + z_far) / 2, the conf's
renderer (64 coarse, 16 importance + 16 depth samples), and
:meth:`RenderPipeline.render_simple`.

Run it with ``python -m pixelnerf_tpu_torch.entry``.  It runs on ``cuda``
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .config.hocon import ConfigTree, parse_file
from .data.synthetic import SyntheticDataset
from .device import resolve_device
from .models.pixelnerf import PixelNeRFNet, make_model
from .parallel.pipeline import RenderPipeline
from .render.renderer import NeRFRenderer
from .utils.geometry import gen_rays_np, pose_spherical
from .utils.jax_convert import from_jax_variables, load_pretrained_backbone

SN64_CONF = Path(__file__).resolve().parent.parent / "conf" / "exp" / "sn64.conf"


def load_conf(pretrained: Optional[bool] = None, path=SN64_CONF) -> ConfigTree:
    """The conf at ``path`` (sn64's, resolved against this file, by default);
    ``pretrained`` overrides ``model.encoder.pretrained``."""
    conf = parse_file(str(path))
    if pretrained is not None:
        conf.put("model.encoder.pretrained", bool(pretrained))
    return conf


def build_model(conf: ConfigTree, device, mlp_impl: str = "auto", seed: int = 0,
                variables: Optional[Mapping] = None) -> PixelNeRFNet:
    """The model on ``device``: weights from JAX ``variables`` when given,
    else a seeded init with the backbone per the conf's pretrained contract."""
    net = make_model(conf["model"], mlp_impl=mlp_impl, device=device,
                     generator=torch.Generator().manual_seed(seed))
    if variables is not None:
        net.load_state_dict(from_jax_variables(variables))
    else:
        load_pretrained_backbone(net, conf["model"])
    return net


def source_view(image_size: int = 64, seed: int = 0, views: Sequence[int] = (0,)) -> dict:
    """Views ``views`` of synthetic sphere object 0 (a ring of at least 3) ->
    images (1, NS, H, W, 3), poses (1, NS, 4, 4), focal, z range."""
    views = [int(v) for v in views]
    ds = SyntheticDataset(n_objs=1, n_views=max(3, max(views) + 1), image_size=image_size,
                          seed=seed)
    s = ds[0]
    return dict(images=s["images"][None, views], poses=s["poses"][None, views], focal=s["focal"],
                z_near=ds.z_near, z_far=ds.z_far, lindisp=ds.lindisp,
                height=ds.height, width=ds.width)


def ring_rays(src: dict, n_frames: int, elevation: float = -10.0) -> np.ndarray:
    """Rays of ``n_frames`` views on a 360-degree ring -> (n_frames*H*W, 8)."""
    radius = (src["z_near"] + src["z_far"]) * 0.5
    poses = np.stack([
        pose_spherical(angle, elevation, radius)
        for angle in np.linspace(-180, 180, n_frames + 1)[:-1]
    ])
    return gen_rays_np(poses, src["width"], src["height"], src["focal"],
                       src["z_near"], src["z_far"]).reshape(-1, 8)


def render_ring(net: PixelNeRFNet, conf: ConfigTree, src: dict, rays: np.ndarray,
                generator: torch.Generator, ray_batch_size: int = 50000,
                views: Optional[Sequence[int]] = None):
    """Encode the source views once -- those of ``src`` at the indices
    ``views``, all of them by default -- and render ``rays`` ->
    (rgb (NR, 3), depth (NR,)) on the model's device."""
    device = next(net.parameters()).device
    images, poses = src["images"], src["poses"]
    if views is not None:
        images, poses = images[:, list(views)], poses[:, list(views)]
    renderer = NeRFRenderer.from_conf(conf["renderer"], lindisp=src["lindisp"],
                                      eval_batch_size=ray_batch_size)
    if renderer.n_coarse < 64:  # video sampling floor, as gen_video sets it
        renderer.n_coarse, renderer.n_fine = 64, 128
    with torch.no_grad():
        scene = net.encode(torch.as_tensor(images, device=device),
                           torch.as_tensor(poses, device=device), float(src["focal"]))
        pipe = RenderPipeline(net, renderer)
        pieces = pipe.render_simple(scene, rays, generator, ray_batch_size=ray_batch_size,
                                    as_numpy=False)
    packed = torch.cat([p for p, _ in pieces])
    return packed[:, :3], packed[:, 3]


def entry(n_frames: int = 3, device=None, mlp_impl: str = "auto", seed: int = 0,
          variables: Optional[Mapping] = None, pretrained: Optional[bool] = None,
          image_size: int = 64, ray_batch_size: int = 50000,
          views: Sequence[int] = (0,), conf_path=SN64_CONF) -> dict:
    """Render ``n_frames`` ring views of the model of ``conf_path`` (sn64's
    by default) from the source views ``views`` of the synthetic object.

    :return: {"frames": (N, H, W, 3) rgb in [0, 1], "depth": (N, H, W)} tensors
    """
    device = resolve_device(device)
    conf = load_conf(pretrained, conf_path)
    net = build_model(conf, device, mlp_impl, seed, variables)
    src = source_view(image_size, seed, views)
    rays = ring_rays(src, n_frames)
    gen = torch.Generator(device=device).manual_seed(seed)
    rgb, depth = render_ring(net, conf, src, rays, gen, ray_batch_size)
    H, W = src["height"], src["width"]
    return {"frames": rgb.clamp(0.0, 1.0).reshape(n_frames, H, W, 3),
            "depth": depth.reshape(n_frames, H, W)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--conf", "-c", default=str(SN64_CONF),
                    help="model recipe, e.g. conf/exp/sn64_multiscale.conf (default sn64)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--impl", default="auto", choices=["auto", "cuda", "torch"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--source", "-P", default="0",
                    help='source view ids, space-separated, e.g. "0 1 2" (as gen_video -P)')
    ap.add_argument("--random-backbone", action="store_true",
                    help="use a seeded random encoder instead of pretrained weights")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    out = entry(args.frames, device, args.impl, args.seed,
                pretrained=False if args.random_backbone else None,
                image_size=args.image_size, views=[int(v) for v in args.source.split()],
                conf_path=args.conf)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    frames = out["frames"]
    n_rays = frames.shape[0] * frames.shape[1] * frames.shape[2]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"entry OK: {Path(args.conf).name}, source views {args.source.split()}, frames "
          f"{tuple(frames.shape)} depth {tuple(out['depth'].shape)} "
          f"finite {bool(torch.isfinite(frames).all())}; {n_rays} rays in {dt:.3f} s "
          f"including build and encode, on {name}")


if __name__ == "__main__":
    main()
