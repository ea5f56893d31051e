"""The weight-gradient half of the port's ResnetFC backward
(``ops/resnetfc_vjp.py``: ``weight_tasks``, ``weight_plan``, ``bwd_weights``,
``bwd_weights_reference``, ``workspace_reference``).

On the CPU the kernel's plain version is driven by the plain workspace: the
DataOut that ``resnetfc_bwd_data`` leaves, formed by ``workspace_reference``.
Its weight and bias gradients are held against

* the plain backward ``resnetfc_bwd_reference`` on the same bf16-rounded
  operands: the same products, grouped per task (one product over the NS
  views' rows where the plain backward sums one product per view), so f32
  summation order is the only difference: rtol 1e-5 and an atol of 1e-5 of
  max|ref|;
* the JAX package's ``_bwd_kernel`` through ``resnetfc_pallas_diff`` in
  interpret mode (as ``tests/test_torch_train_vjp.py`` runs it), with an f32
  workspace: 5e-4 of max(max|ref|, 1e-3), the tolerance of
  ``tests/test_pallas_vjp.py``; a point whose relu input lies within f32
  rounding of 0 gets a zero cotangent on both sides.
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

WEIGHT_FIELDS = ("w_in", "b_in", "w_z", "b_z", "w_blk", "b_blk", "w_out", "b_out")
# what resnetfc_bwd_weights_kernel fixes, by hand (the library reports it on
# the card): 128 x 256 output tiles; at most 24 splits, 256 tensor maps and
# 128 products a launch (62 blocks at sn64's three injections)
LIMITS = rv.KernelLimits(tile_m=128, tile_n=256, max_splits=24, max_maps=256, max_tasks=128)
N_SMS = 132  # an H100 SXM's SMs

CASES = [
    # NS, sb, B_obj, d_in, d_latent, d_hidden, n_blocks, combine_layer
    (1, 1, 150, 42, 64, 64, 5, 3),  # z read in place; B = 150, not a multiple of 32 or 64
    (3, 2, 37, 42, 32, 64, 5, 2),  # ws_z, three views below the mean, B = 74
    (1, 1, 100, 39, 0, 64, 3, 1),  # no latent, kin 48 < 128
    (2, 1, 40, 42, 32, 64, 3, 0),  # the mean right after lin_in: only lin_in and lin_z per view
]
# sn64's tower (H 512, 5 blocks, the latent in blocks 0-2, the mean at block
# 3) at the global encoder's C = 640 (z in place, and ws_z from three views)
# and the ConvEncoder's C = 128: lin_z's products of M = C
WIDE_CASES = [
    (1, 1, 96, 42, 640, 512, 5, 3),
    (3, 2, 48, 42, 640, 512, 5, 3),
    (1, 1, 160, 42, 128, 512, 5, 3),
]
# sn64's depth at the narrow widths, d_hidden 256, 128 and 64 (the weights
# kernel's tile 128 x 256, 128 x 128 and 128 x 64): C = 512 and 640, from 1
# and 3 views, a ragged B (150) and a small batch (SB 1 x 20)
NARROW_CASES = [
    (1, 1, 150, 42, 512, 256, 5, 3),
    (3, 2, 48, 42, 640, 256, 5, 3),
    (1, 1, 96, 42, 640, 128, 5, 3),
    (3, 1, 20, 42, 512, 128, 5, 3),
    (1, 1, 150, 42, 512, 64, 5, 3),
    (3, 2, 48, 42, 512, 64, 5, 3),
]


def _setup(NS, sb, B_obj, d_in, d_latent, H, nb, cl, seed=0):
    jm = JResnetFC(d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H, combine_layer=cl)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, d_latent + d_in)))["params"]
    rng = np.random.default_rng(seed)
    # every parameter live: fc_1 and the biases are zero at init
    params = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * (0.05 if p.ndim == 1 else 1.0 / np.sqrt(p.shape[0])))
        .astype(np.float32), params)
    rows = sb * NS * B_obj
    x = rng.normal(size=(rows, d_in)).astype(np.float32)
    z = rng.normal(size=(rows, d_latent)).astype(np.float32) if d_latent else None
    cot = rng.normal(size=(1, sb * B_obj, 4)).astype(np.float32)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H,
                    combine_layer=cl, impl="torch")
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    tw = port.tower(torch.device("cpu"))
    Z = None if z is None else torch.from_numpy(z)
    kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
    return params, x, z, cot, tw, Z, torch.from_numpy(x), torch.from_numpy(cot[0]).t().contiguous(), kw


def _relu_edge_points(tw, Z, X, nb, NS, sb, cl, tol=1e-6):
    """The output points that have a relu input within ``tol`` of 0 in an
    f64 forward of the tower: a few f32 roundings of the sums that form it
    (eps 6e-8 of terms of magnitude ~1-10), so two f32 forwards may put it on
    either side of the relu, which moves the point's whole gradient.  Only
    the tower's own columns count: those of a tower zero-padded onto a wider
    library are exactly 0 and meet only zero weights."""
    n_lin_z, Hw = tw.w_z.shape[0], tw.d_hidden
    pre = rf.blocks_per_view(nb, NS, cl)
    w = {k: getattr(tw, k).double() for k in ("w_in", "b_in", "w_z", "b_z", "w_blk", "b_blk")}
    hs = [xv.double() @ w["w_in"][: tw.d_in] + w["b_in"] for xv in rv.split_views(X, NS, sb)]
    zs = rv.split_views(Z.double(), NS, sb) if n_lin_z else None
    near = torch.zeros(hs[0].shape[0], dtype=torch.bool)

    def block(k, h, zc):
        nonlocal near
        if k < n_lin_z:
            h = h + zc @ w["w_z"][k] + w["b_z"][k]
        a = torch.relu(h) @ w["w_blk"][k, 0] + w["b_blk"][k, 0]
        near = near | (h[:, :Hw].abs() < tol).any(1) | (a[:, :Hw].abs() < tol).any(1)
        return h + torch.relu(a) @ w["w_blk"][k, 1] + w["b_blk"][k, 1]

    for k in range(pre):
        hs = [block(k, hs[v], zs[v] if zs else None) for v in range(NS)]
    h = hs[0] if NS == 1 else rf.view_mean(rv.join_views(hs, sb), NS, sb)
    for k in range(pre, nb):
        h = block(k, h, None)
    return near | (h[:, :Hw].abs() < tol).any(1)


@pytest.mark.parametrize("NS,sb,B_obj,d_in,d_latent,H,nb,cl", CASES + NARROW_CASES[::3])
def test_weights_reference_matches_plain_backward(NS, sb, B_obj, d_in, d_latent, H, nb, cl):
    _, _, _, _, tw, Z, X, g, kw = _setup(NS, sb, B_obj, d_in, d_latent, H, nb, cl)
    Z = None if Z is None else Z.bfloat16()  # the kernel route's latent, read in place at NS = 1
    data = rv.workspace_reference(g, Z, X, tw, nb, **kw)
    assert data.ws_act.dtype == data.ws_cot.dtype == data.ws_x.dtype == torch.bfloat16
    assert data.ws_x.shape == (NS * -(-sb * B_obj // 32) * 32, tw.w_in.shape[0])
    assert (data.ws_z is not None) == (NS > 1 and tw.w_z.shape[0] > 0)
    got = rv.bwd_weights_reference(Z, data, tw, nb)
    ops = data.ws_act[:, : sb * B_obj].float()
    ref = rv.resnetfc_bwd_reference(g, Z, X, tw, nb, False, torch.bfloat16, operands=ops, **kw)
    for name in WEIGHT_FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == torch.float32, name
        scale = b.abs().max().item() if b.numel() else 0.0
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale, msg=name)
    if tw.w_z.shape[0] > 0:  # dz in z's rows (without a latent layer it stays None here)
        torch.testing.assert_close(got.dz, ref.dz, rtol=0, atol=0)


@pytest.mark.parametrize("NS,sb,B_obj,d_in,d_latent,H,nb,cl",
                         [CASES[0], (3, 1, 40, 42, 32, 64, 4, 2)] + WIDE_CASES + NARROW_CASES)
def test_weights_reference_matches_pallas_interpret(NS, sb, B_obj, d_in, d_latent, H, nb, cl):
    """The weights kernel's plain version on the f32 plain workspace, and the
    plain backward itself, against the JAX ``_bwd_kernel``: every weight and
    bias gradient (and, from the plain backward, dz and dx).  A point with a
    relu input within rounding of 0 (:func:`_relu_edge_points`; at most one a
    case here) gets a zero cotangent on both sides, as the card's gates count
    relu flips apart."""
    params, x, z, cot, tw, Z, X, g, kw = _setup(NS, sb, B_obj, d_in, d_latent, H, nb, cl, seed=1)
    edge = _relu_edge_points(tw, Z, X, nb, NS, sb, cl)
    assert int(edge.sum()) <= max(1, 0.02 * edge.numel())
    cot[0, edge.numpy()] = 0.0
    g = torch.from_numpy(cot[0]).t().contiguous()

    def loss(p, z, x):
        out = resnetfc_pallas_diff(p, (z, x), NS=NS, d_latent=d_latent, d_in=d_in, n_blocks=nb,
                                   combine_layer=cl, sb=sb, block_points=128,
                                   bwd_block_points=128, interpret=True)
        return jnp.sum(out * cot)

    g_ref, dz_ref, dx_ref = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(z),
                                                                 jnp.asarray(x))
    ref = {k[len("mlp_coarse."):]: v.numpy() for k, v in from_jax_variables(
        {"params": {"mlp_coarse": jax.tree.map(np.asarray, g_ref)}}).items()}
    gr = rv.bwd_weights_reference(Z, rv.workspace_reference(g, Z, X, tw, nb,
                                                            compute_dtype=torch.float32, **kw),
                                  tw, nb)
    plain = rv.resnetfc_bwd_reference(g, Z, X, tw, nb, True, **kw)

    def named(gr):  # the module's own columns of a tower packed zero-padded
        got = {"lin_in.weight": gr.w_in[:d_in, :H].t(), "lin_in.bias": gr.b_in[:H],
               "lin_out.weight": gr.w_out[:H].t(), "lin_out.bias": gr.b_out}
        for k in range(gr.w_z.shape[0]):
            got[f"lin_z.{k}.weight"] = gr.w_z[k, :, :H].t()
            got[f"lin_z.{k}.bias"] = gr.b_z[k, :H]
        for k in range(nb):
            for i in (0, 1):
                got[f"blocks.{k}.fc_{i}.weight"] = gr.w_blk[k, i, :H, :H].t()
                got[f"blocks.{k}.fc_{i}.bias"] = gr.b_blk[k, i, :H]
        return got

    weights = sorted(ref)
    ref.update(dz=np.asarray(dz_ref), dx=np.asarray(dx_ref))
    for what, got in (("bwd_weights_reference", named(gr)),
                      ("resnetfc_bwd_reference", dict(named(plain), dz=plain.dz, dx=plain.dx))):
        assert sorted(got) == sorted(weights + (["dz", "dx"] if "dz" in got else []))
        for k, b in got.items():
            a, b = ref[k], b.detach().numpy()
            assert a.shape == b.shape, (what, k)
            np.testing.assert_allclose(b, a, atol=5e-4 * max(np.abs(a).max(), 1e-3),
                                       err_msg=f"{what}: {k}")


@pytest.mark.parametrize("C", [128, 640, 1024, 1856, 3904, 4096])
@pytest.mark.parametrize("NS,pre", [(1, 5), (3, 3)])
def test_weight_plan_at_other_latent_widths(C, NS, pre):
    """lin_z's products at the ConvEncoder's 128, the global encoder's 640,
    1024, ResNet50's 1856 and 3904 and the widest 4096 stay one task each,
    of M = C (ceil(C / 128) x 2 output tiles: 15 x 2 at 1856): the table
    keeps its 14 products and 23 maps, the latent's
    map (z in place, or ws_z) is C wide, and the outputs lie one after
    another in the buffer, lin_z's C x 512 each."""
    B = 4 * 128 * 96
    tasks = rv.weight_tasks(48, 512, C, 5, 3, NS, pre, B)
    plan = rv.weight_plan(48, 512, C, 5, 3, NS, pre, B, LIMITS, N_SMS)
    assert len(tasks) == 14 and len(plan.maps) == 23 and len(plan.table) == 6 * 14
    assert [t.M for t in tasks[1:4]] == [C] * 3
    assert [rv.weight_tiles(t, 512, LIMITS) for t in tasks[1:4]] == [-(-C // 128) * 2] * 3
    assert plan.tiles == 2 + 3 * -(-C // 128) * 2 + 10 * 8
    latent = plan.arrays.index("z" if NS == 1 else "ws_z")
    for i in (1, 2, 3):
        a = plan.maps[plan.table[6 * i]]
        assert a == (latent, 0, B if NS == 1 else NS * B, C)
    offsets = [plan.table[6 * i + 5] for i in range(14)]
    assert offsets == [sum(t.M * 512 for t in tasks[:i]) for i in range(14)]


def test_task_table_at_sn64_widths():
    """The 14 products of sn64 (kin 48, 512 wide, 5 blocks, latent in blocks
    0-2) and their 106 output tiles of 128 x 256, by hand."""
    B = 4 * 128 * 96
    one = rv.weight_tasks(48, 512, 512, 5, 3, 1, 5, B)
    NP = 5
    want = [("lin_in", "ws_x", 0, 48, 2 * NP, B)]
    want += [("lin_z.0", "z", 0, 512, 2 * NP, B), ("lin_z.1", "z", 0, 512, 0, B),
             ("lin_z.2", "z", 0, 512, 1, B)]
    for k in range(5):
        want += [(f"blocks.{k}.fc_0", "ws_act", 2 * k, 512, NP + k, B),
                 (f"blocks.{k}.fc_1", "ws_act", 2 * k + 1, 512, k, B)]
    assert [tuple(t) for t in one] == want
    assert len(one) == 14
    assert [rv.weight_tiles(t, 512, LIMITS) for t in one] == [2] + [8] * 13
    assert sum(rv.weight_tiles(t, 512, LIMITS) for t in one) == 106

    # -V 3: blocks 0-2 below the mean (3 planes each), blocks 3-4 above
    three = rv.weight_tasks(48, 512, 512, 5, 3, 3, 3, B)
    NP = 3 * 3 + 2
    assert three[0] == ("lin_in", "ws_x", 0, 48, 2 * NP, 3 * B)
    assert [t.a for t in three[1:4]] == ["ws_z"] * 3
    assert [t.g_plane for t in three[1:4]] == [2 * NP, 0, 3]
    assert three[4:8] == [("blocks.0.fc_0", "ws_act", 0, 512, NP, 3 * B),
                          ("blocks.0.fc_1", "ws_act", 3, 512, 0, 3 * B),
                          ("blocks.1.fc_0", "ws_act", 6, 512, NP + 3, 3 * B),
                          ("blocks.1.fc_1", "ws_act", 9, 512, 3, 3 * B)]
    assert three[10:] == [("blocks.3.fc_0", "ws_act", 18, 512, NP + 9, B),
                          ("blocks.3.fc_1", "ws_act", 19, 512, 9, B),
                          ("blocks.4.fc_0", "ws_act", 20, 512, NP + 10, B),
                          ("blocks.4.fc_1", "ws_act", 21, 512, 10, B)]
    assert sum(rv.weight_tiles(t, 512, LIMITS) for t in three) == 106


@pytest.mark.parametrize("NS,pre,B,pts", [(1, 5, 4 * 128 * 96, 49152), (3, 3, 4 * 128 * 96, 49152),
                                          (3, 3, 1000, 1024), (1, 5, 40, 64)])
def test_split_points_fill_the_card_in_whole_pieces(NS, pre, B, pts):
    """Splits of 64-point multiples, one view's points each: -V 1's fine
    pass in one split a product (106 CTAs); -V 3's in 3 below the view mean
    and 1 above it (254 CTAs); a ragged B_pad (1,024 rows) rounds up, so a
    product of three views takes 3 pieces, the last shorter."""
    tasks = rv.weight_tasks(48, 512, 512, 5, 3, NS, pre, B)
    got = rv.split_points(tasks, LIMITS.max_splits)
    assert got == pts
    plan = rv.weight_plan(48, 512, 512, 5, 3, NS, pre, B, LIMITS, N_SMS)
    assert plan.pts == pts
    for i, t in enumerate(tasks):
        s = -(-t.P // got)
        assert 1 <= s <= NS and (s - 1) * got < t.P <= s * got
        assert plan.table[6 * i + 4] == s
    assert plan.units == sum(rv.weight_tiles(t, 512, LIMITS) * NS for t in tasks if t.P > pts)


@pytest.mark.parametrize("NS,B", [(25, 4 * 128 * 96), (64, 4 * 128 * 96), (255, 4 * 128 * 96),
                                  (26, 2 * 333), (255, 1000)])
def test_weight_plan_fits_max_splits_at_any_view_count(NS, B):
    """-V 25, 64 and 255 (sn64, the mean at block 3): the products below the
    mean sum over NS views of B_pad points, and a split takes as many of the
    shortest product's pieces (one view's B_pad, rounded up to 64) as it
    needs for the longest to fit the kernel's 24 splits -- whole views where
    B_pad is a multiple of 64 -- so no product passes them."""
    tasks = rv.weight_tasks(48, 512, 512, 5, 3, NS, 3, B)
    plan = rv.weight_plan(48, 512, 512, 5, 3, NS, 3, B, LIMITS, N_SMS)
    B_pad = -(-B // 32) * 32
    piece = -(-B_pad // 64) * 64
    assert plan.pts == piece * -(-(-(-NS * B_pad // piece)) // LIMITS.max_splits)
    if B_pad % 64 == 0:
        assert plan.pts == B_pad * -(-NS // LIMITS.max_splits)
    for i, t in enumerate(tasks):
        s = plan.table[6 * i + 4]
        assert s == -(-t.P // plan.pts) and 1 <= s <= LIMITS.max_splits
        assert (s - 1) * plan.pts < t.P <= s * plan.pts
    assert plan.units == sum(rv.weight_tiles(t, 512, LIMITS) * plan.table[6 * i + 4]
                             for i, t in enumerate(tasks) if plan.table[6 * i + 4] > 1)


@pytest.mark.parametrize("NS,pre", [(1, 5), (3, 3)])
def test_weight_plan_at_sn64_widths(NS, pre):
    """The launch plan of sn64's fine pass: one tensor map per distinct
    operand plane (23: lin_in's and lin_z_0's cotangent is one plane), the
    products written one after another into one bf16 buffer, 106 tiles."""
    B = 4 * 128 * 96
    plan = rv.weight_plan(48, 512, 512, 5, 3, NS, pre, B, LIMITS, N_SMS)
    tasks = rv.weight_tasks(48, 512, 512, 5, 3, NS, pre, B)
    assert plan.arrays == ("ws_act", "ws_cot", "ws_x", "z" if NS == 1 else "ws_z")
    assert len(plan.maps) == 23 and len(plan.table) == 6 * 14
    assert plan.tiles == 106
    assert plan.table[1] == plan.table[6 + 1]  # lin_in and lin_z.0 read g_in through one map
    offsets = [plan.table[6 * i + 5] for i in range(14)]
    sizes = [t.M * 512 for t in tasks]
    assert offsets == [sum(sizes[:i]) for i in range(14)]
    for i, t in enumerate(tasks):
        a, g = plan.maps[plan.table[6 * i]], plan.maps[plan.table[6 * i + 1]]
        B_pad = B  # a multiple of 32
        assert g == (1, t.g_plane * B_pad, t.P, 512)
        rows = B if t.a == "z" else t.P
        assert a == (plan.arrays.index(t.a), t.a_plane * B_pad, rows, t.M)


@pytest.mark.parametrize("NS,pre", [(1, 64), (3, 4)])
def test_weight_plan_refuses_a_tower_past_the_kernel_limits(NS, pre):
    """64 blocks need 259 tensor maps and 132 products, more than the
    kernel's table holds: the plan says so, naming the limit, before any
    launch."""
    with pytest.raises(ValueError, match="at most 256 tensor maps and 128 products.*259 maps "
                                         "and 132 products"):
        rv.weight_plan(48, 512, 512, 64, 3, NS, pre, 1000, LIMITS, N_SMS)
    # 62 blocks, the forward's deepest at these widths, fit at every view count
    assert len(rv.weight_plan(48, 512, 512, 62, 3, NS, min(pre, 62), 1000, LIMITS,
                              N_SMS).maps) == 251


def test_bwd_weights_raises_on_planes_tma_cannot_read():
    NS, sb, B_obj, nb, cl = 1, 1, 40, 3, 2
    _, _, _, _, tw, Z, X, g, kw = _setup(NS, sb, B_obj, 42, 32, 64, nb, cl)
    Zb = Z.bfloat16()
    data = rv.workspace_reference(g, Zb, X, tw, nb)
    # on CPU tensors the wrapper is the plain version, weights cast to bf16
    rv.reset_launches()
    out = rv.bwd_weights(Zb, data, tw, nb)
    ref = rv.bwd_weights_reference(Zb, data, tw, nb)
    assert rv.LAUNCHES == {"resnetfc_bwd_data": 0, "resnetfc_bwd_weights": 0}
    assert out.w_blk.dtype == torch.bfloat16
    torch.testing.assert_close(out.w_blk, ref.w_blk.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(out.b_blk, ref.b_blk, rtol=0, atol=0)

    # z read in place, one element off a 16-byte boundary
    off = torch.empty(Zb.numel() + 1, dtype=torch.bfloat16)[1:].view(Zb.shape)
    off.copy_(Zb)
    with pytest.raises(ValueError, match="16-byte"):
        rv.bwd_weights(off, data, tw, nb)
    # z not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        rv.bwd_weights(Zb.t().contiguous().t(), data, tw, nb)
    # a workspace whose planes start off a 16-byte boundary
    act = torch.empty(data.ws_act.numel() + 1, dtype=torch.bfloat16)[1:].view(data.ws_act.shape)
    act.copy_(data.ws_act)
    with pytest.raises(ValueError, match="16-byte"):
        rv.bwd_weights(Zb, data._replace(ws_act=act), tw, nb)
    # a non-contiguous cotangent workspace
    cot = data.ws_cot.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rv.bwd_weights(Zb, data._replace(ws_cot=cot), tw, nb)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H", [512, 384, 256, 128, 64])
@pytest.mark.parametrize("NS,B_obj", [(1, 1000), (3, 333)])
def test_weights_kernel_matches_plain_on_card(cuda_device, NS, B_obj, H):
    """sn64 widths (and the narrower towers' d_hidden 384, 256, 128 and 64, a
    library each), ragged B: the weights kernel against its plain version on
    the data kernel's own DataOut, to the bar of tests/test_pallas.py, and
    bit-identical on a second call."""
    nb, cl, sb = 5, 3, 2
    _, x, z, _, _, _, _, _, kw = _setup(NS, sb, B_obj, 42, 512, H, nb, cl)
    port = ResnetFC(d_in=42, d_out=4, n_blocks=nb, d_latent=512, d_hidden=H, combine_layer=cl,
                    impl="cuda").to(cuda_device)
    tw = port.tower(cuda_device)
    x = torch.from_numpy(x).to(cuda_device)
    z = torch.from_numpy(z).to(cuda_device).to(torch.bfloat16)
    g = torch.randn(4, sb * B_obj, device=cuda_device)
    data = rv.bwd_data(g, z, x, tw, nb, False, **kw)
    before = rv.LAUNCHES["resnetfc_bwd_weights"]
    gr = rv.bwd_weights(z, data, tw, nb)
    torch.cuda.synchronize()
    assert rv.LAUNCHES["resnetfc_bwd_weights"] == before + 1
    ref = rv.bwd_weights_reference(z, data, tw, nb)
    for name in WEIGHT_FIELDS:
        out, r = getattr(gr, name).float(), getattr(ref, name)
        assert (out - r).abs().max().item() <= 0.015 * max(1.0, r.abs().max().item()), name
        assert torch.corrcoef(torch.stack([out.flatten(), r.flatten()]))[0, 1] > 0.999, name
    again = rv.bwd_weights(z, data, tw, nb)
    assert all(torch.equal(getattr(gr, n), getattr(again, n)) for n in WEIGHT_FIELDS)
