"""The data x rays train step over several ranks against one rank, on the
CPU (``torch.distributed`` over gloo); ``test_torch_sharded_jax.py`` holds
it against the JAX package's mesh step.

Every rank body is ``pixelnerf_tpu_torch.parallel.dryrun.run_legs``, started
by ``parallel.launch.spawn`` (the one-rank reference runs in the test's
process); each rank runs one thread and imports no JAX, and ``spawn`` hands
rank 0's results back to the test.  The weights are the JAX variables of ``test_torch_train_step`` (a
live ``fc_1``), the batch two objects of its synthetic set at R 24, and
every step's render draws are the JAX trainer's (``_jax_draws``), so one
rank and the JAX trainer see the same random numbers as the sharded ranks.
The plain field without AMP (f32) keeps the bars tight:

* the 1-rank mesh step is the unsharded step bit for bit;
* 2 ranks (rays 2) and 4 ranks (data 2 x rays 2) against one rank: loss
  within rel 1e-5 and ``grad_norm`` within rel 2e-4 at each of 3 steps (the
  JAX multichip dry run's recorded deltas, 1.86e-5 and 1.60e-4, are of
  that size: the gradient all-reduce reassociates the sums);
* train-mode BatchNorm synced over 2 ranks against the unsynced layer on
  the whole batch (forward, gradients, running statistics) within 1e-5;
* a sharded save -> restore -> step against 2 unsharded steps at the
  sharded steps' bars.
"""

import jax
import numpy as np
import pytest

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.parallel import make_train_mesh as jmake_train_mesh
from pixelnerf_tpu.render import NeRFRenderer as JNeRFRenderer
from pixelnerf_tpu.train.trainer import Trainer as JTrainer
from pixelnerf_tpu_torch.data import collate
from pixelnerf_tpu_torch.parallel import dryrun, launch
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables
from test_torch_train_step import CONF, _Args, _jax_draws, setup  # noqa: F401

STEPS = 3
R = 24


def _np_draws(d):
    return {k: np.asarray(v) for k, v in vars(d).items() if v is not None}


def jax_step_draws(steps: int = STEPS):
    """The render draws of the JAX trainer's first ``steps`` steps from key
    3 (each step splits the trainer's key)."""
    cfg = JNeRFRenderer.from_conf(jhocon.parse_string(CONF)["renderer"]).cfg
    key, out = jax.random.PRNGKey(3), []
    for _ in range(steps):
        out.append(_np_draws(_jax_draws(key, 2 * R, cfg)))
        key = jax.random.split(key)[0]
    return out


def jax_mesh_steps(setup, workdir):  # noqa: F811
    """The JAX trainer's steps on a (data 2, rays 2) mesh of 4 devices, with
    the f32 scatter-add backward (``test_torch_train_step``)."""
    import importlib

    jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")
    old = jgs._ONEHOT_BWD_MAX_ROWS
    jgs._ONEHOT_BWD_MAX_ROWS = 0
    try:
        conf = jhocon.parse_string(CONF)
        tr = JTrainer(jmake_model(conf["model"], mlp_impl="xla"), setup["variables"],
                      setup["jds"], setup["jds"], JNeRFRenderer.from_conf(conf["renderer"]),
                      _Args(str(workdir)), conf, mesh=jmake_train_mesh(4, data_parallel=2))
        tr.rng = np.random.default_rng(7)
        tr.jrng = jax.random.PRNGKey(3)
        return [tr.train_step(setup["data"]) for _ in range(STEPS)]
    finally:
        jgs._ONEHOT_BWD_MAX_ROWS = old


def spec(setup, workdir, legs):  # noqa: F811
    state = {k: v.numpy() for k, v in from_jax_variables(setup["variables"]).items()}
    return dict(conf=CONF, impl="torch", device="cpu", workdir=str(workdir), state=state,
                dataset=dict(n_objs=3, n_views=4, image_size=24), legs=legs,
                args={"lr": _Args("").lr})


def run(n, spec_):
    """``spec_``'s legs over ``n`` ranks (rank 0's results); one rank runs
    in this process."""
    if n == 1:
        return dryrun.run_legs(spec_)
    return launch.spawn(dryrun.run_legs, list(range(n)), "cpu", spec_)


def train_leg(name, draws, **kw):
    return dict(dict(kind="train", name=name, objs=[0, 1], R=R, seed=7, steps=STEPS,
                     draws=draws, state=True), **kw)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):  # noqa: F811
    """One rank (no mesh and a 1-rank mesh), 2 ranks (rays 2, and the
    BatchNorm leg) and 4 ranks (data 2 x rays 2, and the resume leg)."""
    draws = jax_step_draws()
    rng = np.random.default_rng(11)
    bn = dict(kind="batchnorm", name="bn", x=rng.normal(size=(6, 8, 5, 5)) * 2 + 0.5,
              g=rng.normal(size=(6, 8, 5, 5)), weight=rng.uniform(0.5, 1.5, 8),
              bias=rng.normal(size=8) * 0.1, running_mean=rng.normal(size=8) * 0.1,
              running_var=rng.uniform(0.5, 1.5, 8))
    one = run(1, spec(setup, tmp_path_factory.mktemp("one"), [
        train_leg("nomesh", draws), train_leg("mesh1", draws, data=1),
        dict(bn, name="bn_whole")]))
    two = run(2, spec(setup, tmp_path_factory.mktemp("two"), [
        train_leg("rays2", draws, data=1), dict(bn, sharded=True)]))
    four = run(4, spec(setup, tmp_path_factory.mktemp("four"), [
        train_leg("mesh22", draws, data=2),
        train_leg("resume", draws[:2], data=2, steps=2, resume_at=1, state=False)]))
    return dict(one=one, two=two, four=four)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_one_rank_mesh_is_the_unsharded_step_bit_for_bit(runs):
    a, b = runs["one"]["nomesh"], runs["one"]["mesh1"]
    assert a["steps"] == b["steps"]
    assert sorted(a["state"]) == sorted(b["state"])
    for k, v in a["state"].items():
        np.testing.assert_array_equal(b["state"][k], v, err_msg=k)


@pytest.mark.parametrize("n,leg", [(2, "rays2"), (4, "mesh22")])
def test_sharded_steps_match_one_rank(runs, n, leg):
    ref = runs["one"]["nomesh"]["steps"]
    got = runs["two" if n == 2 else "four"][leg]
    assert len(got["rank_wall_s"]) == n
    for step, (s, r) in enumerate(zip(got["steps"], ref)):
        assert np.isfinite(s["t"])
        assert sorted(s) == sorted(r)
        assert _rel(s["t"], r["t"]) < 1e-5, (step, s, r)
        assert _rel(s["grad_norm"], r["grad_norm"]) < 2e-4, (step, s, r)


def test_sharded_weights_match_one_rank(runs):
    """After 3 steps the replicas' weights are one rank's by
    ``test_torch_train_step``'s measure (fewer than 1e-3 of the parameters
    drifted by more than a quarter of 3 x lr: Adam's first updates are
    about lr * sign(g), so a gradient near 0 may flip), and the BatchNorm
    running statistics within 1e-5 (rank 0's; every rank takes the same
    step)."""
    ref = runs["one"]["nomesh"]["state"]
    budget = 3 * _Args("").lr
    for leg, res in (("rays2", runs["two"]), ("mesh22", runs["four"])):
        got = res[leg]["state"]
        assert sorted(got) == sorted(ref)
        drifted = total = 0
        for k, v in ref.items():
            if "running" in k:
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=f"{leg} {k}")
            elif np.issubdtype(v.dtype, np.floating):
                d = np.abs(got[k] - v)
                drifted += int((d > 0.25 * budget).sum())
                total += d.size
        assert drifted / total < 1e-3, (leg, drifted, total)


def test_synced_batchnorm_matches_the_whole_batch(runs):
    ref, got = runs["one"]["bn_whole"], runs["two"]["bn"]
    for k in ("y", "dx", "dweight", "dbias", "running_mean", "running_var"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    # the statistics are the whole batch's, not a rank's half
    assert np.abs(ref["running_mean"] - runs["two"]["bn"]["running_mean"]).max() < 1e-6


def test_resume_continues_the_sharded_run(runs):
    """Sharded step, save (rank 0), restore on every rank, step 2: against
    two unsharded steps."""
    s2, u2 = runs["four"]["resume"]["steps"][1], runs["one"]["nomesh"]["steps"][1]
    assert _rel(s2["t"], u2["t"]) < 1e-5, (s2, u2)
    assert _rel(s2["grad_norm"], u2["grad_norm"]) < 2e-4, (s2, u2)
    assert u2["grad_norm"] > 1e-6


def test_draws_are_one_devices(setup):  # noqa: F811
    """``complete_draws`` makes the draws ``render_rays`` would make from the
    generator, in its order, so a sharded rank's rows come from the one
    device's numbers."""
    import torch

    from pixelnerf_tpu_torch.config import hocon
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.render.renderer import RenderConfig, complete_draws, render_rays

    net = make_model(hocon.parse_string(CONF)["model"], mlp_impl="torch", device="cpu")
    data = collate([setup["jds"][0]])
    rays = torch.from_numpy(np.asarray(
        __import__("pixelnerf_tpu_torch.utils.geometry", fromlist=["x"]).gen_rays_np(
            data["poses"][0, :1], 24, 24, float(data["focal"][0]), 0.8, 1.8)).reshape(1, -1, 8)[:, :40])
    images = torch.from_numpy(data["images"][:, :1])
    poses = torch.from_numpy(data["poses"][:, :1])
    scene = net.encode(images, poses, float(data["focal"][0]))

    def field(p, v, coarse):
        return net.query(scene, p, viewdirs=v, coarse=coarse, planar_out=True)

    cfg = RenderConfig(n_coarse=8, n_fine=6, n_fine_depth=3, noise_std=0.5, white_bkgd=True)
    with torch.no_grad():
        lazy = render_rays(field, rays, cfg, torch.Generator().manual_seed(4), training=True)
        d = complete_draws(cfg, 1, 40, torch.Generator().manual_seed(4), None, training=True)
        eager = render_rays(field, rays, cfg, None, draws=d, training=True)
    for head in ("coarse", "fine"):
        for k, v in lazy[head].items():
            torch.testing.assert_close(eager[head][k], v, rtol=0, atol=0)
