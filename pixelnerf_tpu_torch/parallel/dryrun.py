"""Rank bodies of the multi-device checks: what every rank of a
:func:`.launch.spawn` runs for ``entry.dryrun_multichip``, the CPU tests and
``chip_smoke.py``.  They live in the package so that ``spawn`` can import
them by name.

:func:`run_legs` takes a spec (a dict of plain values and numpy arrays):

* ``conf``: HOCON text or a ``ConfigTree``; ``impl``: the field route;
  ``device``: "cpu" or "cuda" (this rank's card); ``workdir``: where a
  train leg's checkpoints, visuals and logs go; ``deterministic``: torch's deterministic
  algorithms on (warn only);
* ``state``: a state dict of numpy arrays, or ``init``: ``{"seed", "sigma_bias"}``
  (a seeded init, the lin_out density biases raised by ``sigma_bias``);
* ``dataset``: ``SyntheticDataset`` keyword arguments;
* ``legs``: each a dict with ``name`` and ``kind``:

  - ``train``: steps of a :class:`..train.trainer.Trainer` on objects
    ``objs`` (``data``: the data axis of a ``("data", "rays")`` mesh over
    every rank, None for no mesh; ``draws``: one dict of render draws a
    step or None; ``resume_at``: save, then continue from a new Trainer
    that resumes the checkpoint before that step; ``restore_from``: at
    ``resume_at``, resume leg ``restore_from``'s checkpoint instead, saving
    nothing);
  - ``render``: ``RenderPipeline.render`` (``method`` "render") or
    ``render_simple`` (``pack``) of ``rays`` from the source views
    ``images`` / ``poses`` / ``focal``, on a ray mesh over every rank when
    ``sharded`` (``cfg``: RenderConfig fields; ``grid``: an occupancy
    grid's arrays; ``draws``: one dict a chunk);
  - ``batchnorm``: train-mode ``BatchNorm2d`` on the rows of ``x`` this
    rank holds on a data mesh over every rank (``data_shard``), or on the
    whole of ``x`` when ``sharded`` is false;
  - ``cli``: a CLI's ``main(argv)`` in this rank (``cli``: its module
    under the package, e.g. ``train.cli``, ``eval.eval``; ``env``:
    environment variables set for the leg);
  - ``collectives``: whether the process group's backend takes this
    device's tensors as they are, for each collective ``launch`` uses
    (rank 0's view; a refusal is the backend's error line), and the ms of
    ``launch.all_reduce_mean`` on ``floats`` floats and on 512.

Every leg's kernel launches are counted from 0 in each rank; with
``replay`` each rank also keeps its kernel calls and replays them against
their plain versions right after the leg (:mod:`..ops.replay`).  Each rank
returns ``{leg name: result}`` (``spawn`` hands back rank 0's); results hold
numpy arrays and plain values, and every rank's wall seconds, peak device
memory, launches and replay rows.
"""

from __future__ import annotations

import os
import time
import types

import numpy as np
import torch

from . import launch
from .mesh import DataShard, axis_slice, make_ray_mesh, make_train_mesh


def _conf(spec):
    from ..config import hocon

    c = spec["conf"]
    return hocon.parse_string(c) if isinstance(c, str) else c


def _net(spec, conf, device, diff_mode: bool = False):
    from ..models.pixelnerf import make_model

    init = spec.get("init", {})
    net = make_model(conf["model"], mlp_impl=spec.get("impl", "auto"), device=device,
                     generator=torch.Generator().manual_seed(init.get("seed", 0)),
                     diff_mode=diff_mode)
    if "state" in spec:
        net.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()})
    else:
        bias = init.get("sigma_bias", 0.0)
        if bias:
            with torch.no_grad():
                for mlp in (net.mlp_coarse, net.mlp_fine):
                    if mlp is not None:
                        mlp.lin_out.bias[3] += bias
    return net


def _draws(d):
    from ..render.renderer import RayDraws

    if d is None:
        return None
    return RayDraws(**{k: (_draws(v) if k == "compacted" else torch.from_numpy(np.asarray(v)))
                       for k, v in d.items() if v is not None})


def _numpy(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else t


def _trainer(spec, leg, conf, ds, device, mesh, resume: bool):
    from ..render.renderer import NeRFRenderer
    from ..train.trainer import Trainer

    wd = spec["workdir"]
    args = dict(name=leg["name"], checkpoints_path=os.path.join(wd, "ck"),
                visual_path=os.path.join(wd, "vis"), logs_path=os.path.join(wd, "logs"),
                epochs=10000, lr=1e-4, gamma=1.0, ray_batch_size=leg["R"], nviews="1",
                batch_size=len(leg["objs"]), resume=resume, use_amp=False, grad_clip=0.0,
                check_gradients=False, no_bbox_step=100000)
    args.update(spec.get("args", {}))
    args.update(leg.get("args", {}))
    net = _net(spec, conf, device, diff_mode=True)
    return Trainer(net, ds, ds, NeRFRenderer.from_conf(conf["renderer"]),
                   types.SimpleNamespace(**args), conf, mesh=mesh)


def _train(spec, leg, device) -> dict:
    from ..data import SyntheticDataset, collate

    conf = _conf(spec)
    ds = SyntheticDataset(**spec["dataset"])
    mesh = None if leg.get("data") is None else make_train_mesh(data_parallel=leg["data"])
    tr = _trainer(spec, leg, conf, ds, device, mesh, resume=False)
    tr.rng = np.random.default_rng(leg.get("seed", 5))
    data = collate([ds[i] for i in leg["objs"]])
    draws = leg.get("draws") or [None] * leg["steps"]
    steps, module_norms = [], []
    for i in range(leg["steps"]):
        if leg.get("resume_at") == i:
            if "restore_from" not in leg:
                tr.save_checkpoint()
            rng, gen = tr.rng.bit_generator.state, tr.generator.get_state()
            tr = _trainer(spec, dict(leg, name=leg.get("restore_from", leg["name"])), conf, ds,
                          device, mesh, resume=True)
            tr.rng.bit_generator.state = rng
            tr.generator.set_state(gen)
        steps.append(tr.train_step(data, draws=_draws(draws[i])))
        norms = {}  # the step's (reduced) gradient norm by top-level module
        for name, p in tr.net.named_parameters():
            if p.grad is not None:
                top = name.split(".")[0]
                norms[top] = norms.get(top, 0.0) + float(p.grad.float().pow(2).sum())
        module_norms.append({k: v ** 0.5 for k, v in norms.items()})
    out = dict(steps=steps, step_s=list(tr.step_seconds), module_grad_norms=module_norms)
    if leg.get("state"):
        out["state"] = {k: _numpy(v) for k, v in tr.net.state_dict().items()}
    return out


def _render(spec, leg, device) -> dict:
    from ..parallel.pipeline import RenderPipeline
    from ..render import renderer as rr
    from ..render.accel import OccupancyGrid
    from ..render.renderer import NeRFRenderer, RenderConfig

    conf = _conf(spec)
    net = _net(spec, conf, device)
    mesh = make_ray_mesh() if leg.get("sharded") else None
    cfg = (RenderConfig(**leg["cfg"]) if "cfg" in leg
           else NeRFRenderer.from_conf(conf["renderer"]).cfg)
    pipe = RenderPipeline(net, NeRFRenderer(cfg), mesh=mesh,
                          device_chunk=leg.get("device_chunk", 8192))
    if leg.get("grid"):
        g = dict(leg["grid"])
        res = int(g.pop("resolution"))
        pipe.accel = OccupancyGrid(resolution=res, **{
            k: None if v is None else torch.as_tensor(v, device=device) for k, v in g.items()})
    chunk_draws = leg.get("draws")
    draws = None if chunk_draws is None else (lambda i, n: _draws(chunk_draws[i]))
    put = (lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device))
    gen = torch.Generator(device=device).manual_seed(leg.get("seed", 5))
    rr.reset_accel_counts()
    with torch.no_grad():
        scene = net.encode(put(leg["images"]), put(leg["poses"]), put(leg["focal"]))
        if leg.get("method", "render_simple") == "render":
            out = pipe.render(scene, leg["rays"], gen, leg["R"], want_weights=True, draws=draws)
        else:
            rgb, depth = pipe.render_simple(scene, leg["rays"], gen, leg["R"],
                                            pack=leg.get("pack", "f32"), draws=draws)
            out = {"rgb": rgb, "depth": depth}
    out["accel_counts"] = dict(rr.ACCEL_COUNTS)
    return out


def _batchnorm(spec, leg, device) -> dict:
    from ..models.resnet import BatchNorm2d

    x, g = np.asarray(leg["x"], np.float32), np.asarray(leg["g"], np.float32)
    bn = BatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1).to(device).train()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.as_tensor(leg[k]))
    rows = slice(None)
    if leg.get("sharded"):
        mesh = make_train_mesh(data_parallel=launch.world_size())
        rows = axis_slice(x.shape[0], mesh, "data")
        bn.data_shard = DataShard(mesh.coords["data"], mesh.shape["data"], mesh.group("data"))
    xr = torch.tensor(x[rows], device=device, requires_grad=True)
    y = bn(xr)
    (y * torch.as_tensor(g[rows], device=device)).sum().backward()
    dw, db = launch.all_reduce_mean([bn.weight.grad, bn.bias.grad])
    n = launch.world_size() if leg.get("sharded") else 1
    return dict(y=_numpy(launch.all_gather_rows(y.detach())),
                dx=_numpy(launch.all_gather_rows(xr.grad)),
                dweight=_numpy(dw * n), dbias=_numpy(db * n),
                running_mean=_numpy(bn.running_mean), running_var=_numpy(bn.running_var))


def _cli(spec, leg, device) -> dict:
    """A CLI's ``main(argv)`` in this rank: the trainer's per-step losses,
    gradient norms and step seconds, or the CLI's returned dict."""
    import importlib

    env = leg.get("env", {})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ret = importlib.import_module(f"pixelnerf_tpu_torch.{leg['cli']}").main(
            list(leg["argv"]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if hasattr(ret, "history"):
        if ret.writer is not None:  # its thread ends before the process does
            ret.writer.close()
        return dict(losses=list(ret.history), grad_norms=list(ret.grad_norms),
                    step_s=list(ret.step_seconds))
    return dict(result=ret)


def _collectives(spec, leg, device) -> dict:
    """For all_reduce, broadcast and all_gather: True when the backend takes
    a tensor on ``device`` as it is and gives the right values, False when
    it gives wrong ones, else its error's first line."""
    import torch.distributed as dist

    r, n = launch.rank(), launch.world_size()
    t = torch.arange(4.0, device=device) + r
    ranks = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    want = {"all_reduce": (torch.arange(4.0, device=device) * n + ranks.sum()),
            "broadcast": torch.arange(4.0, device=device),
            "all_gather": torch.arange(4.0, device=device) + ranks}

    def all_reduce():
        x = t.clone()
        dist.all_reduce(x)
        return x

    def broadcast():
        x = t.clone()
        dist.broadcast(x, 0)
        return x

    def all_gather():
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
        return torch.stack(parts)

    calls = {"all_reduce": all_reduce, "broadcast": broadcast, "all_gather": all_gather}
    out = {"backend": dist.get_backend()}
    for name, call in calls.items():
        try:
            got = call()
        except RuntimeError as e:  # the measurement: the backend refused the tensor
            out[name] = str(e).strip().splitlines()[0]
            continue
        out[name] = bool(got.device == t.device and torch.equal(got, want[name]))
    # the port's transport: a train step's gradient mean (``floats``) and one
    # BatchNorm statistic's sum (512 floats), host clock around synchronized calls
    for key, floats, reps in (("gradient_mean_ms", leg.get("floats", 0), 5),
                              ("batchnorm_sum_ms", 512, 50)):
        if floats:
            t = torch.ones(int(floats), device=device)
            launch.all_reduce_mean([t])
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                launch.all_reduce_mean([t])
            _sync(device)
            out[key] = (time.perf_counter() - t0) / reps * 1e3
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


LEGS = {"train": _train, "render": _render, "batchnorm": _batchnorm, "cli": _cli,
        "collectives": _collectives}


def run_legs(spec: dict) -> dict:
    """Every leg of ``spec`` in this rank, in order -> rank 0's
    ``{leg name: result}``; each result also holds every rank's
    ``rank_wall_s`` and ``rank_peak_mb`` (peak device memory; 0 on the
    CPU).  The deterministic-algorithm settings are restored on return."""
    from ..device import resolve_device

    device = resolve_device(spec.get("device", "cuda"))
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", torch.cuda.current_device())
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        results = _run(spec, device, cuda)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was[2], was[3]
    return results


def _run(spec: dict, device: torch.device, cuda: bool) -> dict:
    import contextlib

    from ..ops import resnetfc_fused as rf
    from ..ops import resnetfc_vjp as rv
    from ..ops.replay import KernelCalls

    results = {}
    for leg in spec["legs"]:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        rf.reset_launches()
        rv.reset_launches()
        t0 = time.perf_counter()
        with KernelCalls() if spec.get("replay") else contextlib.nullcontext() as calls:
            res = LEGS[leg["kind"]](spec, leg, device)
        if cuda:
            torch.cuda.synchronize()
        mine = dict(wall_s=time.perf_counter() - t0,
                    peak_mb=torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0,
                    launches={k: v for k, v in {**rf.LAUNCHES, **rv.LAUNCHES}.items() if v})
        if calls is not None:
            mine["replay"] = calls.check()
        per_rank = launch.gather_objects(mine)
        res.update({f"rank_{k}": [r[k] for r in per_rank] for k in mine})
        results[leg["name"]] = res
    return results
