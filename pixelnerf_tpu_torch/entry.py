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
unless ``--device cpu`` is given.  ``python -m pixelnerf_tpu_torch.entry
multichip [N]`` runs :func:`dryrun_multichip` over N ranks (default 4) on
card 0 (or on the CPU with ``--device cpu``).
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


def dryrun_multichip(n_devices: int = 4, device: str = "cuda", replay: bool = False) -> dict:
    """The JAX package's multichip dry run over ``n_devices`` ranks
    (``parallel.launch``; on the card they share card 0 over gloo), each leg
    held against one unsharded process with the same weights and draws,
    torch's deterministic algorithms on in both:

    * train: two steps over a ("data", "rays") mesh of data n/2 x rays 2 on
      sn64 at full width (16 px views, the dry run's 6 + 4 + 2 samples,
      AMP on the card), ``lambda_alpha_mask`` 0.1 so that ``mask_gt`` is
      sharded, and the lin_out density bias raised by 1 (else the first
      step can leave sigma dead and the second step's gradient zero); step
      1 at the JAX dry run's bars (loss 1e-4 and grad_norm 1e-3 relative);
    * resume: a sharded step, save, restore into a new Trainer on every
      rank, step 2: bit for bit the sharded run that did not stop (steps
      and weights); its step 2 against one process that restores the same
      checkpoint and takes step 2 at step 1's bars; and against two
      unsharded steps at the JAX bars (loss 1e-3 relative; grad_norm
      1e-3 + 1% of it, held where the step is f32 throughout: on the card
      Adam's first step, about lr * sign(g), carries the bf16 rounding of
      each rank's weight gradients, so two runs' weights part there and
      that grad_norm is printed, with the share of the weights that part);
    * eval: ``render_simple`` of 64 n rays over a 1-D mesh of n, against
      one process (rgb 1e-5, depth 1e-4).

    Prints the JAX wording's ``dryrun_multichip ... OK`` lines and raises
    when a leg misses.  ``replay``: keep and replay every rank's kernel
    calls (:mod:`.ops.replay`).  Returns the deltas and both runs'
    results."""
    import tempfile

    from .parallel import dryrun, launch

    rays_par = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    data_par = n_devices // rays_par
    conf = load_conf(pretrained=False)
    for key, value in (("n_coarse", 6), ("n_fine", 4), ("n_fine_depth", 2), ("white_bkgd", True)):
        conf.put("renderer." + key, value)
    conf.put("loss.lambda_alpha_mask", 0.1)
    src = source_view(image_size=16, views=(0, 1))
    NR = 64 * n_devices
    rays = gen_rays_np(src["poses"][0, 1:2], 16, 16, float(src["focal"]), 0.8, 1.8)
    rays = rays.reshape(-1, 8)[:NR].astype(np.float32)
    while rays.shape[0] < NR:  # more than 4 ranks: the view's rays again
        rays = np.concatenate([rays, rays])[:NR]
    SB, R = data_par, 16 * rays_par
    train = dict(kind="train", objs=list(range(SB)), R=R, seed=0, steps=2, state=True)
    render = dict(kind="render", name="eval", images=src["images"][:, :1],
                  poses=src["poses"][:, :1], focal=src["focal"], rays=rays, R=NR,
                  device_chunk=NR, seed=7)
    lr = 1e-4
    with tempfile.TemporaryDirectory() as wd:
        spec = dict(conf=conf, impl="auto", device=device, init={"seed": 0, "sigma_bias": 1.0},
                    dataset=dict(n_objs=8, n_views=3, image_size=16), workdir=wd,
                    args={"use_amp": device != "cpu", "lr": lr}, deterministic=True)
        ids = list(range(n_devices)) if device == "cpu" else [0] * n_devices
        sharded = launch.spawn(dryrun.run_legs, ids, device, dict(spec, replay=replay, legs=[
            dict(train, name="train", data=data_par),
            dict(train, name="resume", data=data_par, resume_at=1),
            dict(render, sharded=True)]))
        single = dryrun.run_legs(dict(spec, legs=[
            dict(train, name="single"), dict(train, name="single_again"),
            dict(train, name="single_resume", resume_at=1, restore_from="resume", state=False),
            render]))

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    s1, u1 = sharded["train"]["steps"][0], single["single"]["steps"][0]
    if "am" not in s1:
        raise RuntimeError(f"the mask loss did not run: {sorted(s1)}")
    dloss, dg = rel(s1["t"], u1["t"]), rel(s1["grad_norm"], u1["grad_norm"])
    if not (np.isfinite(s1["t"]) and dloss < 1e-4 and dg < 1e-3):
        raise RuntimeError(f"dryrun_multichip train: {s1} against {u1}")
    print(f"dryrun_multichip train OK: mesh {{'data': {data_par}, 'rays': {rays_par}}}, "
          f"SB={SB}, R={R}, loss={s1['t']:.6f} (single-device {u1['t']:.6f}, rel delta "
          f"{dloss:.2e}), grad_norm={s1['grad_norm']:.5f} (single-device "
          f"{u1['grad_norm']:.5f}, rel delta {dg:.2e})")

    res, cont = sharded["resume"], sharded["train"]
    exact = res["steps"] == cont["steps"] and all(
        np.array_equal(res["state"][k], v) for k, v in cont["state"].items())
    repeat = single["single"]["steps"] == single["single_again"]["steps"]
    s2, u2 = res["steps"][1], single["single"]["steps"][1]
    dl2, dg2 = rel(s2["t"], u2["t"]), rel(s2["grad_norm"], u2["grad_norm"])
    r2 = single["single_resume"]["steps"][1]
    dlr, dgr = rel(s2["t"], r2["t"]), rel(s2["grad_norm"], r2["grad_norm"])
    drifted, total = _drift(sharded["train"]["state"], single["single"]["state"], 0.5 * lr)
    f32 = device == "cpu"
    if not (exact and dlr < 1e-4 and dgr < 1e-3 and dl2 < 1e-3 and u2["grad_norm"] > 1e-6
            and (not f32 or dg2 * abs(u2["grad_norm"]) < 1e-3 + 0.01 * abs(u2["grad_norm"]))):
        raise RuntimeError(f"dryrun_multichip resume: bit for bit the unbroken sharded run "
                           f"{exact}; {s2} against {r2} from the same checkpoint and {u2} "
                           f"unbroken")
    print(f"dryrun_multichip resume OK: sharded save->restore->step2 bit for bit the unbroken "
          f"sharded run {exact} (one process twice: {repeat}), loss={s2['t']:.6f} (unsharded "
          f"step2 from the same checkpoint {r2['t']:.6f}, rel delta {dlr:.2e}; unsharded "
          f"2-step {u2['t']:.6f}, rel delta {dl2:.2e}), grad_norm={s2['grad_norm']:.5f} "
          f"(from the same checkpoint {r2['grad_norm']:.5f}, rel delta {dgr:.2e}; unsharded "
          f"2-step {u2['grad_norm']:.5f}, rel delta {dg2:.2e}"
          f"{'' if f32 else ', printed'}); weights after 2 steps: {drifted} of {total} "
          f"({drifted / total:.2e}) more than lr/2 from one process's")
    ev, eu = sharded["eval"], single["eval"]
    drgb = float(np.abs(ev["rgb"] - eu["rgb"]).max())
    ddep = float(np.abs(ev["depth"] - eu["depth"]).max())
    if not (np.isfinite(ev["rgb"]).all() and drgb < 1e-5 and ddep < 1e-4):
        raise RuntimeError(f"dryrun_multichip eval: rgb {drgb}, depth {ddep}")
    print(f"dryrun_multichip eval OK: {NR} rays over 1-D mesh of {n_devices}, max |sharded - "
          f"single| rgb {drgb:.2e}, depth {ddep:.2e}")
    return dict(train=(dloss, dg), resume=(dl2, dg2), resume_control=(dlr, dgr),
                drift=(drifted, total), eval=(drgb, ddep), exact=exact,
                repeat=repeat, sharded=sharded, single=single, mesh=(data_par, rays_par))


def _drift(got: Mapping, ref: Mapping, tol: float):
    """(count, total) of the floating weights of ``got`` more than ``tol``
    from ``ref``'s; BatchNorm's running statistics left out."""
    drifted = total = 0
    for k, v in ref.items():
        if "running" not in k and np.issubdtype(v.dtype, np.floating):
            drifted += int((np.abs(got[k] - v) > tol).sum())
            total += v.size
    return drifted, total


def main(argv=None) -> None:
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["multichip"]:
        n = int(argv[1]) if len(argv) > 1 and not argv[1].startswith("-") else 4
        dryrun_multichip(n, "cpu" if "--device" in argv and "cpu" in argv else "cuda")
        return
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
