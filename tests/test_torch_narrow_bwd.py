"""The port's ResnetFC backward (rows 5a / 5b of PERF.md) at the narrower
tower widths, d_hidden 384, 256, 128 and 64, on the CPU.

The backward is built once per tower width, as the forward is: its data
kernel's walk back forms dz H columns a step (``dz_pieces``: 2 steps an
injection of sn64's C = 512 at 384 and 256, 4 at 128, 8 at 64), each into
an (NS B_pad, H) plane that ``_join_planes`` joins; its weights kernel's
output tile is 128 x min(256, H) (128 x 192 at 384), so a narrow tower has
few output tiles (86 at 384, 33 at 256, 23 at 128 and at 64 against sn64's
106 at the -V 1 fine pass), and
``fill_points`` splits the point axis past ``split_points``' whole views to
fill the card's SMs in one wave.

* The slice as a whole: sn64's depth (5 blocks, the latent in blocks 0-2,
  the views' mean at block 3) at d_hidden 256, 128 and 64, C = 512 and 640,
  from 1 and 3 views, and the JAX package's own d_hidden 64 case of
  ``tests/test_pallas_vjp.py`` (C = 96, 4 blocks, the latent in all four),
  through the port's ``ResnetFC(impl="cuda")`` on CPU
  tensors (its autograd Function, whose backward is the plain transcription
  of ``_bwd_kernel``), against the JAX ``resnetfc_pallas_diff`` in
  interpret mode (as ``tests/test_pallas_vjp.py`` runs it): the value to
  rtol 2e-4, every gradient to 5e-4 of max(max|ref|, 1e-3), the tolerances
  of ``tests/test_pallas_vjp.py``.
* The walk back's dz steps, emulated on the flat ``(n_lin_z C, H)`` W_z that
  the kernel's tensor map reads (rows past the array as zeros, the next
  injection's rows past C), joined by ``_join_planes``: dz to 1e-5 of
  max|ref| against the plain product (f32 sums regrouped).
* ``weight_plan`` / ``weight_tiles`` / ``fill_points`` and ``data_steps``
  at the narrow widths, by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops.resnetfc_vjp import resnetfc_pallas_diff
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

FINE = 4 * 128 * 96  # the train step's fine pass: SB 4 x 128 rays x 96 samples
N_SMS = 132  # an H100 SXM's SMs


def _setup(NS, sb, B_obj, d_in, C, H, seed=0, nb=5, cl=3):
    """sn64's depth at width H (or ``nb`` blocks, the latent below ``cl``):
    JAX parameters drawn from numpy (every parameter live), the port module
    holding them (impl="cuda": on CPU tensors its kernels' plain versions),
    seeded inputs and cotangent."""
    jm = JResnetFC(d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=cl)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, C + d_in)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * (0.05 if p.ndim == 1 else 1.0 / np.sqrt(p.shape[0])))
        .astype(np.float32), params)
    rows = sb * NS * B_obj
    x = rng.normal(size=(rows, d_in)).astype(np.float32)
    z = rng.normal(size=(rows, C)).astype(np.float32)
    cot = rng.normal(size=(1, sb * B_obj, 4)).astype(np.float32)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=cl,
                    impl="cuda")
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    return params, x, z, cot, port


def _close(b, a, what):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, atol=5e-4 * max(np.abs(a).max(), 1e-3),
                               err_msg=f"grad mismatch at {what}")


@pytest.mark.parametrize("NS,sb,B_obj,C,H,nb,cl", [
    (1, 1, 150, 512, 256, 5, 3),  # B ragged against the 64-point tile and the 128-point block
    (3, 2, 48, 512, 256, 5, 3),  # the -V 3 train layout: SB 2 x 3 views
    (1, 1, 96, 640, 128, 5, 3),  # the global encoder's latent: 2 pieces, 5 dz steps an injection
    (3, 1, 20, 512, 128, 5, 3),  # a small batch: one half-filled tile
    # tests/test_pallas_vjp.py's own d_hidden 64 case: C = 96 (6 dz steps of
    # 64 columns, the last past C), the latent in all 4 blocks
    (1, 1, 64, 96, 64, 4, 4),
    (3, 2, 48, 512, 64, 5, 3),  # sn64's depth at 64 from 3 views: 8 dz steps an injection
    (1, 1, 96, 512, 384, 5, 3),  # 384: three 64-column pieces a warpgroup, 2 dz steps
    (3, 1, 40, 640, 384, 5, 3),  # 384 from 3 views at the global encoder's 640
])
def test_narrow_function_value_and_grads_match_pallas_interpret(monkeypatch, NS, sb, B_obj, C,
                                                                H, nb, cl):
    """The narrow tower's train-step field through the port's kernel route
    (the autograd Function and its backward, ``resnetfc_bwd``) against the
    JAX kernels: the value, every parameter's gradient, dz and dx."""
    d_in = 42
    params, x, z, cot, port = _setup(NS, sb, B_obj, d_in, C, H, nb=nb, cl=cl)

    def loss(p, z, x):
        out = resnetfc_pallas_diff(p, (z, x), NS=NS, d_latent=C, d_in=d_in, n_blocks=nb,
                                   combine_layer=cl, sb=sb, block_points=128,
                                   bwd_block_points=128, interpret=True)
        return jnp.sum(out * cot)

    v_ref, g_ref = jax.value_and_grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(z),
                                                               jnp.asarray(x))
    calls = []
    bwd = rv.resnetfc_bwd
    monkeypatch.setattr(rv, "resnetfc_bwd", lambda *a, **k: calls.append(a[3]) or bwd(*a, **k))
    X = torch.from_numpy(x).requires_grad_()
    Z = torch.from_numpy(z).requires_grad_()
    rv.reset_launches()
    value = torch.sum(port((Z, X), combine_inner_dims=(NS, B_obj)) * torch.from_numpy(cot))
    value.backward()
    # the backward of the kernel route, at the tower's width; CPU: no launch
    assert len(calls) == 1 and calls[0].w_in.shape[1] == H
    assert rv.LAUNCHES == {"resnetfc_bwd_data": 0, "resnetfc_bwd_weights": 0}

    np.testing.assert_allclose(value.item(), float(v_ref), rtol=2e-4)
    ref = from_jax_variables({"params": {"mlp_coarse": jax.tree.map(np.asarray, g_ref[0])}})
    got = {n: p.grad for n, p in port.named_parameters()}
    assert sorted(k[len("mlp_coarse."):] for k in ref) == sorted(got)
    for k, v in ref.items():
        _close(got[k[len("mlp_coarse."):]], v.numpy(), k)
    _close(X.grad, g_ref[2], "x")
    _close(Z.grad, g_ref[1], "z")


@pytest.mark.parametrize("H,C", [(512, 512), (512, 640), (256, 512), (256, 640), (128, 128),
                                 (128, 512), (128, 640), (128, 1024), (256, 16), (64, 512),
                                 (64, 96), (64, 640), (384, 512), (384, 640), (384, 1024)])
def test_dz_steps_joined_are_the_latents_gradient(H, C):
    """The walk back's Z_BWD steps as the kernel takes them: step j of
    injection k reads the rows k C + j H .. + H of the flat (n_lin_z C, H)
    W_z (the tensor map's rows; past the array zeros, past C the next
    injection's rows) as the product's H columns, and writes them into dz
    plane j; the views' planes at v B_pad.  ``_join_planes`` of the summed
    planes is dz = sum_k gb_k W_z[k]^T: its columns past C, computed from
    whatever rows were read there, are cut off."""
    g = torch.Generator().manual_seed(H + C)
    n_lin_z, rows = 3, 96
    w_z = torch.randn(n_lin_z, C, H, generator=g)
    gbs = [torch.randn(rows, H, generator=g) for _ in range(n_lin_z)]
    flat = torch.cat([w_z.reshape(n_lin_z * C, H), torch.zeros(H, H)])  # TMA's zero fill
    steps = rv.dz_pieces(C, H)
    assert steps == -(-C // H) and (H != 512 or steps == rf.latent_pieces(C))
    planes = torch.zeros(steps, rows, H)
    for k in reversed(range(n_lin_z)):  # in injection order of the walk back
        for j in range(steps):
            rowbase = k * C + j * H
            planes[j] += gbs[k] @ flat[rowbase: rowbase + H].t()
    dz = rv._join_planes(planes, C)
    want = sum(gb @ w_z[k].t() for k, gb in enumerate(gbs))
    assert dz.shape == (rows, C)
    torch.testing.assert_close(dz, want, rtol=0, atol=1e-5 * want.abs().max().item())
    if steps == 1:  # one plane: a view of it, no copy
        assert dz.data_ptr() == planes.data_ptr()


@pytest.mark.parametrize("H,C,NS,pre,want", [
    # sn64 at -V 1: 34 steps at 512; each injection's walk back takes
    # dz_pieces(512, H) steps (1, 2, 4, 8), 3 injections
    (512, 512, 1, 5, 34), (256, 512, 1, 5, 37), (128, 512, 1, 5, 43), (64, 512, 1, 5, 55),
    (384, 512, 1, 5, 37),  # 2 steps of 384 columns, the second's last 256 past C
    # -V 3: one view's segments; the walk back's view segment holds the steps
    (512, 512, 3, 3, 36), (256, 512, 3, 3, 39), (128, 512, 3, 3, 45), (64, 512, 3, 3, 57),
    (384, 512, 3, 3, 39),
    # the global encoder's C = 640: 2 recompute pieces, 2 / 3 / 5 dz steps
    (384, 640, 1, 5, 17 + 1 + 22), (256, 640, 1, 5, 17 + 1 + 25), (128, 640, 1, 5, 17 + 1 + 31),
    # the ConvEncoder's C = 128: one step each way at every width
    (128, 128, 1, 5, 34), (256, 128, 3, 3, 36),
    # the widest latent at 128: 2 pieces, 8 dz steps an injection
    (128, 1024, 1, 5, 17 + 1 + 40),
])
def test_data_steps_with_the_split_dz_steps(H, C, NS, pre, want):
    assert rv.data_steps(5, 3, NS, pre, C, H) == want
    assert want <= rv.DATA_LIMITS[H].max_steps
    rv.check_data_program(5, 3, NS, pre, rv.DATA_LIMITS[H], C)


@pytest.mark.parametrize("H,want", [(512, [2] + [8] * 13), (256, [1] + [4] * 3 + [2] * 10),
                                    (128, [1] + [4] * 3 + [1] * 10),
                                    (64, [1] + [4] * 3 + [1] * 10),
                                    (384, [2] + [8] * 3 + [6] * 10)])
@pytest.mark.parametrize("NS,pre", [(1, 5), (3, 3)])
def test_weight_plan_at_narrow_widths(H, want, NS, pre):
    """sn64's 14 products at d_hidden 384, 256, 128 and 64: lin_in (M =
    48), lin_z (M = C = 512) and the blocks (M = H), on 128 x min(256, H)
    tiles (128 x 192 at 384, two column tiles): 106 tiles at 512, 86 at 384
    (lin_in 2, lin_z 3 x 8, blocks 10 x 6), 33 at 256 (lin_in 1, lin_z 3 x
    4, blocks 10 x 2), 23 at 128 and at 64 (lin_in 1, lin_z 3 x 4, blocks 10
    x 1); the outputs lie one after another, lin_z's 512 x H and the blocks'
    H x H each; 23 tensor maps."""
    lim = rv.WEIGHT_LIMITS[H]
    assert lim.tile_n == rv.weight_tile_n(H) == (192 if H == 384 else min(256, H))
    tasks = rv.weight_tasks(48, H, 512, 5, 3, NS, pre, FINE)
    assert [rv.weight_tiles(t, H, lim) for t in tasks] == want
    plan = rv.weight_plan(48, H, 512, 5, 3, NS, pre, FINE, lim, N_SMS)
    assert plan.tiles == sum(want) == {512: 106, 384: 86, 256: 33, 128: 23, 64: 23}[H]
    assert len(plan.maps) == 23 and len(plan.table) == 6 * 14
    assert [t.M for t in tasks] == [48] + [512] * 3 + [H] * 10
    offsets = [plan.table[6 * i + 5] for i in range(14)]
    assert offsets == [sum(t.M * H for t in tasks[:i]) for i in range(14)]
    for i, t in enumerate(tasks):
        g = plan.maps[plan.table[6 * i + 1]]
        assert g == (1, t.g_plane * FINE, t.P, H)  # ws_cot's planes are H wide


@pytest.mark.parametrize("H,NS,pre,pts,ctas", [
    (512, 1, 5, FINE, 106),  # sn64: more than half the card already; the parent's plan
    (512, 3, 3, FINE, 254),
    (256, 1, 5, FINE // 4, 132),  # 33 tiles x 4 splits: one full wave
    (256, 3, 3, FINE, 83),  # 166 at half the points: past one wave
    (128, 1, 5, 9856, 115),  # 23 tiles x 5 splits (6 would take 138 CTAs)
    (128, 3, 3, FINE // 2, 122),  # 6 splits below the mean, 2 above
    (64, 1, 5, 9856, 115),  # 64's 23 tiles split as 128's
    (64, 3, 3, FINE // 2, 122),
    (384, 1, 5, FINE, 86),  # 86 tiles: more than half the card already
    (384, 3, 3, FINE, 210),
])
def test_split_points_fill_the_card_at_narrow_widths(H, NS, pre, pts, ctas):
    """On an H100's 132 SMs: a launch that would leave more than half the
    SMs idle splits every product into the most pieces (multiples of 64
    points) whose CTAs still fit one wave and 24 splits; sn64's plans stay
    the whole-view splits of ``split_points``."""
    lim = rv.WEIGHT_LIMITS[H]
    tasks = rv.weight_tasks(48, H, 512, 5, 3, NS, pre, FINE)
    tiles = [rv.weight_tiles(t, H, lim) for t in tasks]
    assert rv.split_points(tasks, lim.max_splits) == FINE  # one view's points
    got = rv.fill_points(tasks, H, lim, N_SMS)
    assert got == pts and got % 64 == 0
    splits = [-(-t.P // got) for t in tasks]
    assert sum(n * s for n, s in zip(tiles, splits)) == ctas
    assert ctas <= N_SMS or got == FINE  # split past whole views only within one wave
    assert max(splits) <= lim.max_splits
    plan = rv.weight_plan(48, H, 512, 5, 3, NS, pre, FINE, lim, N_SMS)
    assert plan.pts == got and list(plan.table[4::6]) == splits
    assert plan.units == sum(n * s for n, s in zip(tiles, splits) if s > 1)


@pytest.mark.parametrize("H", [384, 256, 128, 64])
@pytest.mark.parametrize("NS,B", [(1, 2000), (1, 40), (3, 666), (25, FINE), (255, 1000)])
def test_split_points_stay_within_the_kernels_limits(H, NS, B):
    """At a ragged B, a tiny B, and -V 25 / -V 255, the narrow plans keep
    every product within 24 splits of at least 64 points and their CTAs
    within one wave whenever they split past the whole-view rule."""
    lim = rv.WEIGHT_LIMITS[H]
    pre = 5 if NS == 1 else 3
    tasks = rv.weight_tasks(48, H, 512, 5, 3, NS, pre, B)
    tiles = [rv.weight_tiles(t, H, lim) for t in tasks]
    base = rv.split_points(tasks, lim.max_splits)
    got = rv.fill_points(tasks, H, lim, N_SMS)
    assert 64 <= got <= base and got % 64 == 0
    splits = [-(-t.P // got) for t in tasks]
    assert max(splits) <= lim.max_splits
    if got < base:
        assert sum(n * s for n, s in zip(tiles, splits)) <= N_SMS
    rv.weight_plan(48, H, 512, 5, 3, NS, pre, B, lim, N_SMS)
