"""The port's multi-view (NS > 1) field against the JAX package, on the CPU.

* The plain versions of the multi-view kernels -- ``resnetfc_dense_mv`` (the
  port of ``_kernel_2d_mv``) and ``resnetfc_gather_mv`` (``_kernel_2d_mv_gather``)
  on CPU tensors -- against the Pallas kernels run as ``tests/test_pallas.py``
  runs them (``interpret=True``, f32 throughout): NS 2 and 3, SB 1 and 2,
  planar and not, B ragged against the 128-point Pallas block.  1e-4 of
  max(1, max|ref|).
* ``ResnetFCFunction`` at NS > 1 (forward, and the plain transcription of the
  NS > 1 ``_bwd_kernel``) against ``resnetfc_pallas_diff`` in interpret mode,
  to ``tests/test_pallas_vjp.py``'s tolerances: value rtol 2e-4, every
  gradient 5e-4 of max(max|ref|, 1e-3).
* ``query`` and ``render_rays`` with 2 and 3 source views against the JAX
  model (``PIXELNERF_PALLAS_INTERPRET=1``; gather caps 2048 and 0, so the
  fused-gather and the dense multi-view route), 1e-4 of max(1, max|ref|).
* Three train steps at ``-V 2`` against the JAX ``Trainer``, as
  ``tests/test_torch_train_step.py`` holds the single-view step.

The kernels themselves run only on a CUDA card (marker ``cuda``): their
on-card checks are at the end and skip here."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.data import SyntheticDataset as JSyntheticDataset
from pixelnerf_tpu.data.loader import collate as jcollate
from pixelnerf_tpu.models import PixelNeRFNet as JPixelNeRFNet
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops import resnetfc_pallas as rp
from pixelnerf_tpu.ops.resnetfc_vjp import resnetfc_pallas_diff
from pixelnerf_tpu.render import NeRFRenderer as JNeRFRenderer
from pixelnerf_tpu.render import renderer as jrenderer
from pixelnerf_tpu.train.trainer import Trainer as JTrainer
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import SyntheticDataset
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from pixelnerf_tpu_torch.render import NeRFRenderer, RayDraws, RenderConfig, render_rays
from pixelnerf_tpu_torch.utils.geometry import gen_rays_np, pose_spherical
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

TOL = 1e-4
jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")


def close(port, ref, tol=TOL, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    bar = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bar, f"{what} max|d| {err:.3g} > {bar:.3g}"


def _pair(d_in, d_latent, H, nb, combine_layer, impl="cuda", seed=0):
    """JAX ResnetFC parameters drawn from numpy (fc_1 and biases live) and the
    port module holding the same weights."""
    jm = JResnetFC(d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H,
                   combine_layer=combine_layer)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((4, d_latent + d_in)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * (0.05 if p.ndim == 1 else 1.0 / np.sqrt(p.shape[0])))
        .astype(np.float32), params)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H,
                    combine_layer=combine_layer, impl=impl)
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    return jm, params, port


# ---------------------------------------------------------------------------
# rows 3 and 4: the plain multi-view towers against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "route,NS,sb,planar,d_latent",
    [
        ("dense", 2, 1, True, 32),
        ("dense", 3, 2, False, 32),
        ("dense", 3, 1, True, 0),  # no latent: the views differ by their code only
        ("dense", 2, 2, True, 32),
        ("gather", 2, 1, True, 32),
        ("gather", 3, 1, False, 32),
    ],
)
def test_plain_mv_towers_match_pallas_interpret(route, NS, sb, planar, d_latent):
    d_in, H, nb, cl, B_obj, T = 42, 64, 4, 2, 150, 40  # B_obj ragged against 128
    _, params, port = _pair(d_in, d_latent, H, nb, cl)
    rng = np.random.default_rng(1)
    rows = sb * NS * B_obj
    x = rng.uniform(-1, 1, size=(rows, d_in)).astype(np.float32)
    kw = dict(NS=NS, d_latent=d_latent, d_in=d_in, n_blocks=nb, combine_layer=cl, sb=sb,
              planar_out=planar, block_points=128, interpret=True)
    tower = port.tower(torch.device("cpu"))
    X = torch.from_numpy(x)
    rf.reset_launches()
    if route == "gather":
        tables = rng.normal(size=(NS, T, d_latent)).astype(np.float32)
        idx = rng.integers(-2, T + 2, size=(rows, 8)).astype(np.int32)  # a few taps out of range
        w = rng.uniform(0, 1, size=(rows, 8)).astype(np.float32)
        w[:, 4:] = 0.0
        ref = rp.resnetfc_pallas(params, (rp.LatentGather(jnp.asarray(tables), jnp.asarray(idx),
                                                          jnp.asarray(w)), jnp.asarray(x)), **kw)
        g = rf.LatentGather(torch.from_numpy(tables), torch.from_numpy(idx), torch.from_numpy(w))
        out = rf.resnetfc_gather_mv(g.idx, g.w, g.table, X, tower, nb, cl, planar)
        with torch.no_grad():  # the fused-gather route is eval-only
            via_module = port((g, X), combine_inner_dims=(NS, B_obj), planar_out=planar)
    else:
        z = rng.normal(size=(rows, d_latent)).astype(np.float32) if d_latent else None
        ref = rp.resnetfc_pallas(params, (None if z is None else jnp.asarray(z), jnp.asarray(x)),
                                 **kw)
        Z = None if z is None else torch.from_numpy(z)
        out = rf.resnetfc_dense_mv(Z, X, tower, nb, NS, cl, sb, planar)
        via_module = port((Z, X), combine_inner_dims=(NS, B_obj), planar_out=planar)
    close(out, ref[0])
    close(via_module, ref)
    assert not any(rf.LAUNCHES.values())  # CPU tensors: the plain versions


def test_gather_mv_refuses_a_superbatch():
    """As in the JAX package, the fused gather holds one object's tables."""
    _, _, port = _pair(6, 8, 16, 2, 1)
    g = rf.LatentGather(torch.zeros(2, 4, 8), torch.zeros(2 * 2 * 3, 8, dtype=torch.int32),
                        torch.zeros(2 * 2 * 3, 8))
    with torch.no_grad(), pytest.raises(ValueError, match="SB=1"):
        port((g, torch.zeros(12, 6)), combine_inner_dims=(2, 3))


def test_view_mean_is_an_ordered_sum_times_the_reciprocal():
    """The combine is sum(xs) * (1 / NS) in view order, as the TPU kernel
    takes it, not a mean that divides."""
    h = torch.from_numpy(np.random.default_rng(0).normal(size=(2 * 3 * 5, 7)).astype(np.float32))
    hv = h.reshape(2, 3, 5, 7)
    want = ((hv[:, 0] + hv[:, 1]) + hv[:, 2]) * np.float32(1.0 / 3)
    assert torch.equal(rf.view_mean(h, 3, 2), want.reshape(10, 7))


# ---------------------------------------------------------------------------
# row 5 at NS > 1: the autograd Function against resnetfc_pallas_diff
# ---------------------------------------------------------------------------

VJP_CASES = [
    # NS, sb, B_obj, d_in, d_latent, d_hidden, n_blocks, combine_layer
    (2, 1, 150, 42, 64, 64, 5, 3),  # ragged against the 128-point block
    (3, 2, 48, 42, 32, 64, 5, 2),  # superbatch x multi-view (the train layout)
    (3, 1, 70, 39, 0, 64, 3, 1),  # no latent
    (2, 2, 40, 42, 32, 64, 3, 0),  # mean right after lin_in
]


@pytest.mark.parametrize("NS,sb,B_obj,d_in,d_latent,H,nb,cl", VJP_CASES)
def test_function_mv_value_and_grads_match_pallas_interpret(NS, sb, B_obj, d_in, d_latent, H, nb,
                                                            cl):
    _, params, port = _pair(d_in, d_latent, H, nb, cl)
    rng = np.random.default_rng(0)
    rows = sb * NS * B_obj
    x = rng.normal(size=(rows, d_in)).astype(np.float32)
    z = rng.normal(size=(rows, d_latent)).astype(np.float32) if d_latent else None
    cot = rng.normal(size=(1, sb * B_obj, 4)).astype(np.float32)

    def loss(p, z, x):
        out = resnetfc_pallas_diff(p, (z, x), NS=NS, d_latent=d_latent, d_in=d_in, n_blocks=nb,
                                   combine_layer=cl, sb=sb, block_points=128,
                                   bwd_block_points=128, interpret=True)
        return jnp.sum(out * cot)

    argnums = (0, 2) if z is None else (0, 1, 2)
    zj = None if z is None else jnp.asarray(z)
    v_ref, g_ref = jax.value_and_grad(loss, argnums=argnums)(params, zj, jnp.asarray(x))

    X = torch.from_numpy(x).requires_grad_()
    Z = torch.from_numpy(z).requires_grad_() if z is not None else None
    rv.reset_launches()
    out = port((Z, X), combine_inner_dims=(NS, B_obj))  # (1, sb * B_obj, 4)
    value = torch.sum(out * torch.from_numpy(cot))
    value.backward()
    assert rv.LAUNCHES == {"resnetfc_bwd_data": 0, "resnetfc_bwd_weights": 0}  # CPU: plain

    def close_grad(b, a, what):
        a, b = np.asarray(a), b.detach().numpy()
        assert a.shape == b.shape, (what, a.shape, b.shape)
        np.testing.assert_allclose(b, a, atol=5e-4 * max(np.abs(a).max(), 1e-3),
                                   err_msg=f"grad mismatch at {what}")

    np.testing.assert_allclose(value.item(), float(v_ref), rtol=2e-4)
    ref_params = from_jax_variables({"params": {"mlp_coarse": jax.tree.map(np.asarray, g_ref[0])}})
    dparams = {n: p.grad for n, p in port.named_parameters()}
    assert sorted(k[len("mlp_coarse."):] for k in ref_params) == sorted(dparams)
    for k, v in ref_params.items():
        close_grad(dparams[k[len("mlp_coarse."):]], v.numpy(), k)
    close_grad(X.grad, g_ref[-1], "x")
    if z is not None:
        close_grad(Z.grad, g_ref[1], "z")


def test_plain_mv_backward_walks_its_own_operands():
    """With ``compute_dtype=bf16`` the plain NS > 1 backward, handed the
    operands it would recompute, gives the same bits; the operands come in
    the backward kernel's workspace order (per block below the mean: r of
    each view, then s of each view)."""
    NS, sb, B_obj, nb, cl = 3, 2, 20, 4, 2
    _, _, port = _pair(42, 32, 64, nb, cl)
    tw = port.tower(torch.device("cpu"))
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.normal(size=(sb * NS * B_obj, 42)).astype(np.float32))
    Z = torch.from_numpy(rng.normal(size=(sb * NS * B_obj, 32)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(4, sb * B_obj)).astype(np.float32))
    kw = dict(NS=NS, sb=sb, combine_layer=cl)
    ops = rv.forward_operands(Z, X, tw, nb, torch.bfloat16, **kw)
    assert ops.shape == (2 * (NS * cl + nb - cl) + 1, sb * B_obj, 64)
    assert torch.equal(ops, ops.bfloat16().float())
    gr = rv.resnetfc_bwd_reference(g, Z, X, tw, nb, compute_dtype=torch.bfloat16, **kw)
    same = rv.resnetfc_bwd_reference(g, Z, X, tw, nb, compute_dtype=torch.bfloat16,
                                     operands=ops, **kw)
    for name in rv.Grads._fields:
        torch.testing.assert_close(getattr(gr, name), getattr(same, name), rtol=0, atol=0)
    # r_0 of view 1 at output column B_obj (object 1, point 0) comes from
    # input row (1 * NS + 1) * B_obj; a wrong row would be far off
    row = (NS + 1) * B_obj
    h = X[row].bfloat16().float() @ tw.w_in[:42].bfloat16().float() + tw.b_in
    h = h + (Z[row].bfloat16().float() @ tw.w_z[0].bfloat16().float() + tw.b_z[0])
    torch.testing.assert_close(ops[1][B_obj], torch.relu(h).bfloat16().float(), rtol=1e-2,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# query and render_rays with several source views against the JAX model
# ---------------------------------------------------------------------------

CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 6\n freq_factor = 1.5\n include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet\n n_blocks = 3\n d_hidden = 64\n combine_layer = 2\n combine_type = average }
    mlp_fine { type = resnet\n n_blocks = 3\n d_hidden = 64\n combine_layer = 2\n combine_type = average }
    encoder { backbone = resnet34\n pretrained = False\n num_layers = 2\n use_first_pool = False }
}
"""
IMG = 32


@pytest.fixture(scope="module")
def world():
    """Three source views of one object, query points, and JAX variables with
    live fc_1 and MLP biases."""
    ds = SyntheticDataset(n_objs=1, n_views=3, image_size=IMG, seed=2)
    s = ds[0]
    rng = np.random.default_rng(9)
    B = 60
    xyz = (rng.normal(size=(1, B, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(1, B, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    conf = jhocon.parse_string(CONF)
    jnet = jmake_model(conf["model"], mlp_impl="xla")
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(s["images"][None, :1]),
                                   jnp.asarray(s["poses"][None, :1]), jnp.asarray(s["focal"]),
                                   jnp.asarray(xyz), jnp.asarray(vd))
    variables = jax.tree.map(np.asarray, dict(variables))

    def bump(tree, path=()):
        if isinstance(tree, dict):
            return {k: bump(v, path + (k,)) for k, v in tree.items()}
        v = np.array(tree, np.float32)
        if ("fc_1" in path and path[-1] == "kernel") or (path[1].startswith("mlp") and
                                                          path[-1] == "bias"):
            v = rng.normal(size=v.shape).astype(np.float32) * 0.1
        return v

    rays = gen_rays_np(pose_spherical(40.0, -20.0, 1.3)[None], IMG, IMG, s["focal"],
                       ds.z_near, ds.z_far).reshape(-1, 8)[::9][:48]
    return dict(images=s["images"], poses=s["poses"], focal=np.float32(s["focal"]), xyz=xyz,
                vd=vd, conf=conf, variables=bump(variables), rays=rays)


def _jax_scene(world, NS):
    jnet = jmake_model(world["conf"]["model"], mlp_impl="xla")
    return jnet.apply(world["variables"], jnp.asarray(world["images"][None, :NS]),
                      jnp.asarray(world["poses"][None, :NS]), jnp.asarray(world["focal"]),
                      method=JPixelNeRFNet.encode)


def _port(world, impl, NS):
    net = make_model(hocon.parse_string(CONF)["model"], mlp_impl=impl, device="cpu")
    net.load_state_dict(from_jax_variables(world["variables"]))
    scene = net.encode(torch.from_numpy(world["images"][None, :NS]),
                       torch.from_numpy(world["poses"][None, :NS]), float(world["focal"]))
    return net, scene


@pytest.mark.parametrize(
    "NS,impl,jimpl,cap",
    [
        (2, "cuda", "pallas", 2048),  # fused multi-view gather (row 4)
        (3, "cuda", "pallas", 2048),
        (2, "cuda", "pallas", 0),  # dense multi-view (row 3)
        (3, "cuda", "pallas", 0),
        (3, "torch", "xla", 2048),
    ],
)
def test_mv_query_matches_jax(world, monkeypatch, NS, impl, jimpl, cap):
    monkeypatch.setenv("PIXELNERF_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PIXELNERF_FUSED_GATHER_MAX_ROWS", str(cap))
    jscene = _jax_scene(world, NS)
    jnet = jmake_model(world["conf"]["model"], mlp_impl=jimpl)
    net, scene = _port(world, impl, NS)
    assert scene.num_views_per_obj == NS
    assert net._fused_gather_ok(scene.latents, NS) == (impl != "torch" and cap > 0)
    rf.reset_launches()
    for coarse in (True, False):
        ref = jnet.apply(world["variables"], jscene, jnp.asarray(world["xyz"]),
                         viewdirs=jnp.asarray(world["vd"]), coarse=coarse, planar_out=True,
                         method=JPixelNeRFNet.query)
        with torch.no_grad():  # an eval query: the fused-gather route is eval-only
            out = net.query(scene, torch.from_numpy(world["xyz"]), torch.from_numpy(world["vd"]),
                            coarse=coarse, planar_out=True)
        close(out, ref, what=f"coarse={coarse}")
    assert not any(rf.LAUNCHES.values())  # CPU tensors never launch a kernel


@pytest.fixture(scope="module")
def jax_render(world):
    """JAX render_rays (XLA field) from 2 and 3 source views, and the draws
    its key split gives."""
    cfg = jrenderer.RenderConfig(n_coarse=8, n_fine=6, n_fine_depth=3, white_bkgd=True,
                                 depth_std=0.05, eval_batch_size=0)
    jnet = jmake_model(world["conf"]["model"], mlp_impl="xla")
    rays = jnp.asarray(world["rays"])[None]
    rng = jax.random.PRNGKey(5)

    @jax.jit
    def run(variables, scene, rays, rng):
        def field(points, viewdirs, coarse):
            return jnet.apply(variables, scene, points, viewdirs=viewdirs, coarse=coarse,
                              planar_out=True, method=JPixelNeRFNet.query)

        return jrenderer.render_rays(field, rays, rng, cfg, want_weights=True)

    outs = {NS: jax.tree.map(np.asarray, run(world["variables"], _jax_scene(world, NS), rays, rng))
            for NS in (2, 3)}
    B = rays.shape[1]
    k_c, _, k_f, k_d, _ = jax.random.split(rng, 5)
    k_u, k_j = jax.random.split(k_f)
    n_imp = cfg.n_fine - cfg.n_fine_depth
    draws = dict(
        coarse=jax.random.uniform(k_c, (B, cfg.n_coarse)),
        fine_u=jax.random.uniform(k_u, (B, n_imp), dtype=jnp.float32),
        fine_jitter=jax.random.uniform(k_j, (B, n_imp)),
        depth=jax.random.normal(k_d, (B, cfg.n_fine_depth)),
    )
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    port_cfg = RenderConfig(n_coarse=8, n_fine=6, n_fine_depth=3, white_bkgd=True,
                            depth_std=0.05, eval_batch_size=0)
    return outs, draws, port_cfg


@pytest.mark.parametrize("NS,impl", [(2, "cuda"), (3, "cuda"), (3, "torch")])
def test_mv_render_rays_matches_jax(world, jax_render, NS, impl):
    """The whole multi-view render on the CPU: encode NS views, query on the
    route ``impl`` picks (the fused multi-view gather for ``cuda``), samplers,
    compositing -- against JAX's render_rays fed the same draws."""
    refs, draws, cfg = jax_render
    ref = refs[NS]
    net, scene = _port(world, impl, NS)

    def field(points, viewdirs, coarse):
        return net.query(scene, points, viewdirs=viewdirs, coarse=coarse, planar_out=True)

    with torch.no_grad():
        out = render_rays(field, torch.from_numpy(world["rays"])[None], cfg,
                          draws=RayDraws(**draws), want_weights=True)
    close(out["coarse"]["weights"], ref["coarse"]["weights"], what="coarse weights")
    for head in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            close(out[head][k], ref[head][k], what=f"{head} {k}")


# ---------------------------------------------------------------------------
# train steps at -V 2 against the JAX Trainer
# ---------------------------------------------------------------------------

TRAIN_CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 4\n freq_factor = 1.5\n include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet\n n_blocks = 3\n d_hidden = 48\n combine_layer = 2 }
    mlp_fine { type = resnet\n n_blocks = 3\n d_hidden = 48\n combine_layer = 2 }
    encoder { backbone = resnet18\n pretrained = False\n num_layers = 2\n use_first_pool = False }
}
renderer {
    n_coarse = 8\n n_fine = 6\n n_fine_depth = 3\n white_bkgd = True\n sched = []
}
loss {
    rgb { use_l1 = False }
    rgb_fine { use_l1 = False }
    lambda_coarse = 1.0\n lambda_fine = 1.0
}
train {
    print_interval = 100\n save_interval = 1000\n vis_interval = 1000
    eval_interval = 1000\n num_epoch_repeats = 1
}
"""


class _Args:
    def __init__(self, tmp):
        self.name = "t"
        self.checkpoints_path = str(tmp / "ck")
        self.visual_path = str(tmp / "vis")
        self.logs_path = str(tmp / "logs")
        self.epochs = 10000
        self.lr = 5e-4
        self.gamma = 1.0
        self.ray_batch_size = 24
        self.nviews = "2"
        self.batch_size = 2
        self.resume = False
        self.use_amp = False
        self.grad_clip = 0.0
        self.check_gradients = False
        self.no_bbox_step = 100000


def _jax_draws(key, n_rays, cfg):
    """The random numbers the JAX trainer's next step draws."""
    key, step = jax.random.split(key)
    rng_render, _ = jax.random.split(step)
    k_c, _, k_f, k_fd, _ = jax.random.split(rng_render, 5)
    k_u, k_j = jax.random.split(k_f)
    n_imp = cfg.n_fine - cfg.n_fine_depth
    draws = dict(
        coarse=jax.random.uniform(k_c, (n_rays, cfg.n_coarse)),
        fine_u=jax.random.uniform(k_u, (n_rays, n_imp), dtype=jnp.float32),
        fine_jitter=jax.random.uniform(k_j, (n_rays, n_imp)),
        depth=jax.random.normal(k_fd, (n_rays, cfg.n_fine_depth)),
    )
    return RayDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_train_steps_at_two_views_match_jax_trainer(tmp_path, monkeypatch, impl):
    """``-V 2``: both objects of each batch encode two source views, and the
    field combines them at combine_layer.  Same weights, batch, host
    generator and render draws; the bars of the single-view step test (loss
    rtol 2e-3, grad norm rtol 5e-3)."""
    monkeypatch.setattr(jgs, "_ONEHOT_BWD_MAX_ROWS", 0)  # read when the JAX step is traced
    jds = JSyntheticDataset(n_objs=3, n_views=4, image_size=24)
    sample = jds[0]
    jconf = jhocon.parse_string(TRAIN_CONF)
    jnet = jmake_model(jconf["model"], mlp_impl="xla")
    variables = jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(sample["images"][None, :2]),
        jnp.asarray(sample["poses"][None, :2]), jnp.asarray(np.float32(sample["focal"])),
        jnp.zeros((1, 4, 3), jnp.float32), jnp.zeros((1, 4, 3), jnp.float32))
    rng = np.random.default_rng(3)

    def bump(tree, path=()):
        if isinstance(tree, dict):
            return {k: bump(v, path + (k,)) for k, v in tree.items()}
        v = np.array(tree, np.float32)
        if "fc_1" in path and path[-1] == "kernel":
            v = rng.normal(size=v.shape).astype(np.float32) * 0.1
        return v

    variables = bump(jax.tree.map(np.asarray, dict(variables)))
    tr_j = JTrainer(jnet, variables, jds, jds, JNeRFRenderer.from_conf(jconf["renderer"]),
                    _Args(tmp_path / "j"), jconf)
    conf = hocon.parse_string(TRAIN_CONF)
    net = make_model(conf["model"], mlp_impl=impl, device="cpu", diff_mode=True)
    net.load_state_dict(from_jax_variables(variables))
    ds = SyntheticDataset(n_objs=3, n_views=4, image_size=24)
    from pixelnerf_tpu_torch.train import Trainer

    tr_p = Trainer(net, ds, ds, NeRFRenderer.from_conf(conf["renderer"]), _Args(tmp_path / "p"),
                   conf)
    assert tr_p.remat == (impl == "torch")  # the kernel route saves only its inputs
    data = jcollate([jds[0], jds[1]])
    tr_j.rng, tr_p.rng = np.random.default_rng(7), np.random.default_rng(7)
    tr_j.jrng = jax.random.PRNGKey(3)
    n_rays = 2 * tr_p.args.ray_batch_size
    for step in range(3):
        draws = _jax_draws(tr_j.jrng, n_rays, tr_j.renderer.cfg)
        ld_j = tr_j.train_step(data)
        ld_p = tr_p.train_step(data, draws=draws)
        assert np.isfinite(ld_p["t"]), ld_p
        np.testing.assert_allclose(ld_p["t"], ld_j["t"], rtol=2e-3, err_msg=f"step {step}")
        np.testing.assert_allclose(ld_p["grad_norm"], ld_j["grad_norm"], rtol=5e-3,
                                   err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _agree(out, ref):
    d = (out - ref).abs().max().item()
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1].item()
    return d <= 0.015 * max(1.0, ref.abs().max().item()) and corr > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("route,NS,sb", [("dense", 3, 2), ("dense", 2, 1), ("gather", 2, 1),
                                         ("gather", 3, 1)])
def test_mv_kernels_match_plain_on_card(cuda_device, route, NS, sb):
    """sn64 widths, ragged B_obj: each multi-view forward kernel against its
    bf16 plain version, to the bar of tests/test_pallas.py."""
    d_in, C, H, nb, cl, B_obj, T = 42, 512, 512, 5, 3, 500, 1024
    _, _, port = _pair(d_in, C, H, nb, cl)
    tower = port.to(cuda_device).tower(cuda_device)
    rng = np.random.default_rng(2)
    rows = sb * NS * B_obj
    x = torch.from_numpy(rng.uniform(-1, 1, size=(rows, d_in)).astype(np.float32)).to(cuda_device)
    tables = torch.from_numpy(rng.normal(size=(NS, T, C)).astype(np.float32)).to(cuda_device)
    tables = tables.to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, T, size=(rows, 8)).astype(np.int32)).to(cuda_device)
    w = torch.from_numpy(rng.uniform(0, 1, size=(rows, 8)).astype(np.float32)).to(cuda_device)
    zq = rf.gather_reference(idx, w, tables, torch.bfloat16) if sb == 1 else \
        torch.randn(rows, C, device=cuda_device).bfloat16().float()
    ref = rf.resnetfc_reference(zq, x, tower, nb, compute_dtype=torch.bfloat16, NS=NS, sb=sb,
                                combine_layer=cl)
    name = f"resnetfc_fwd_{route}_mv"
    before = rf.LAUNCHES[name]
    if route == "gather":
        out = rf.resnetfc_gather_mv(idx, w, tables, x, tower, nb, cl)
    else:
        out = rf.resnetfc_dense_mv(zq.to(torch.bfloat16), x, tower, nb, NS, cl, sb)
    torch.cuda.synchronize()
    assert rf.LAUNCHES[name] == before + 1
    assert out.shape == (4, sb * B_obj) and _agree(out, ref)


@pytest.mark.cuda
def test_mv_backward_kernels_match_plain_on_card(cuda_device):
    """sn64 widths, SB 2 x NS 3, ragged B_obj: every output of the two
    backward kernels against the plain bf16 backward walked through the
    kernel's stashed operands, and bit-identical on a second call."""
    NS, sb, B_obj, nb, cl = 3, 2, 300, 5, 3
    _, _, port = _pair(42, 512, 512, nb, cl)
    tw = port.to(cuda_device).tower(cuda_device)
    rows, B = sb * NS * B_obj, sb * B_obj
    x = torch.randn(rows, 42, device=cuda_device)
    z = torch.randn(rows, 512, device=cuda_device).to(torch.bfloat16)
    g = torch.randn(4, B, device=cuda_device)
    kw = dict(NS=NS, sb=sb, combine_layer=cl)
    before = dict(rv.LAUNCHES)
    data = rv.bwd_data(g, z, x, tw, nb, True, **kw)
    gr = rv.bwd_weights(z, data, tw, nb)
    torch.cuda.synchronize()
    assert all(rv.LAUNCHES[k] == before[k] + 1 for k in before)
    ref = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16,
                                    operands=data.ws_act[:, :B].float(), **kw)
    for name in rv.Grads._fields:
        assert _agree(getattr(gr, name).float(), getattr(ref, name)), name
    again = rv.resnetfc_bwd(g, z, x, tw, nb, **kw)
    assert all(torch.equal(getattr(gr, n), getattr(again, n)) for n in rv.Grads._fields)
