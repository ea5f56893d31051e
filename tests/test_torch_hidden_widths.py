"""Every ResnetFC width up to 512 on the port's kernel route, on the CPU.

The kernels are built one library a width for every multiple of 64 up to
512 but 448: at d_hidden 192 a warpgroup's 96 columns are one piece (wgmma
m64n96k16 on three 64 x 32 weight boxes a stage, a ring of 4 stages of 24
KB), at 320 its 160 are two pieces of 80 (m64n80k16 on five 64 x 16 boxes
with the 32-byte swizzle, 4 stages of 20 KB); the weights kernel's output
tile is 128 x 192 at 192 and 128 x 160 at 320, and the walk back forms dz
H columns a step (3 steps an injection of C = 512 at 192, 2 at 320).  A
tower of any other width up to 512 (448 too) runs on the next library's
(``rf.library_width``), its weights zero-padded past its own columns
(``rf.pack_tower``): the same function, since the padded columns of the
stream stay +0 and only meet zero weights, and their cotangent is zero.

* The route rule takes 192 / 320 and padded widths (1, 100, 200, 448, 500)
  under ``auto`` on a (faked) card, with and without grad, from 1 and 3
  views, to 6 blocks under grad, reading only the mirrored limits; 576 and
  1024 stay plain and raise under ``cuda``.
* The mirrors at the new widths by hand: pieces, stages, the weights
  kernel's tile and tiles, ``dz_pieces`` and ``data_steps``.
* A padded tower's plain forward and plain backward against the unpadded
  tower's (the padded weights sliced off): the forward and every gradient
  to 1e-6 of max|ref| (f32 sums regrouped by the padding), the padded dW and
  db entries exactly zero; through the module, its autograd Function hands
  back the module's own shapes.
* The slice as a whole at d_hidden 192 (its own library) and 200 (the 256
  library's, padded), as ``tests/test_torch_hidden384.py`` holds 384:
  ``query`` on the gather and dense routes from 1 and 3 views and
  ``render_rays`` against the JAX package's Pallas kernels in interpret
  mode, one ``-V 1`` trainer step against the JAX trainer, at that file's
  bars.
* The plain backward at d_hidden 320 and 448 (padded onto 512) against the JAX
  ``_bwd_kernel`` in interpret mode at a small depth, as
  ``tests/test_torch_bwd_weights.py`` holds sn64's depth.

The kernels themselves run on the card only; ``chip_smoke.py`` (phases 17
and 18) holds them against these plain versions there."""

import pytest
import torch

import test_torch_bwd_weights as bwt
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from test_torch_hidden64 import (make_jax_render, make_world, query_matches_jax,
                                 render_rays_matches_jax, takes_the_kernels_on_a_card,
                                 train_step_matches_jax_trainer)

CUDA = torch.device("cuda")  # compared by type only: nothing is allocated on it


def _tower(H, nb=5, impl="auto"):
    with torch.device("meta"):
        return ResnetFC(d_in=42, d_out=4, n_blocks=nb, d_latent=512, d_hidden=H,
                        combine_layer=3, impl=impl)


@pytest.mark.parametrize("H", [192, 320, 448, 1, 100, 200, 500])
def test_route_takes_every_width_up_to_512(H):
    """sn64's other widths (the 512-wide latent in blocks 0-2, the views'
    mean at block 3) at d_hidden H take the kernels under ``auto`` on a card,
    forward and under grad, from 1 and 3 views, and at the gated depth
    (``GRAD_MAX_BLOCKS``) under grad:
    192 and 320 on their own libraries' mirrors, any other width (448 too)
    on the next library's.  No library is built or loaded."""
    for nb in (5, rv.GRAD_MAX_BLOCKS):
        t = _tower(H, nb)
        assert all(t._kernel_route((NS, 64), CUDA, grad) for NS in (1, 3)
                   for grad in (False, True)), (H, nb)
    L = {192: 192, 320: 320, 448: 512, 1: 64, 100: 128, 200: 256, 500: 512}[H]
    assert rf.library_width(H) == L and rf.tile_limits(H) is rf.TILE_LIMITS[L]
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("H", [576, 1024])
def test_route_keeps_towers_past_512_plain(H):
    """Past 512 the forward takes the 1024 library (576 zero-padded onto
    it) from 1 and 3 views, while under grad, where no backward library is
    built past 512, the rule routes plain under ``auto`` and raises under
    ``cuda``; past 1024, the widest library, both ways are plain (and raise
    under ``cuda``)."""
    for NS in (1, 3):
        t = _tower(H)
        assert t._kernel_route((NS, 64), CUDA, False) is True
        assert t._kernel_route((NS, 64), CUDA, True) is False
        t.impl = "cuda"
        with pytest.raises(ValueError, match="d_hidden up to 512"):
            t._kernel_route((NS, 64), CUDA, True)
    assert rf.library_width(H) == 1024 and rf.tile_limits(H) is rf.TILE_LIMITS[1024]
    for grad in (False, True):
        t = _tower(H + 1024)
        assert t._kernel_route((1, 64), CUDA, grad) is False
        t.impl = "cuda"
        with pytest.raises(ValueError, match="d_hidden 1 to 1024"):
            t._kernel_route((3, 64), CUDA, grad)
    with pytest.raises(ValueError, match="d_hidden 1 to 1024"):
        rf.library_width(H + 1024)
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("H,piece,box,stages,tile_n,n_tiles,dz,steps1,steps3", [
    # one piece a warpgroup of its whole half at 192 (three 64 x 32 boxes a
    # stage), two of half of it at 320 (five 64 x 16 boxes); the weights
    # kernel's tile 128 x 192 at 192, 128 x 160 at 320 (2 and 6 of an H x H
    # dW); C = 512's dz in 3 steps of H columns at 192, 2 at 320
    (192, 96, 32, 4, 192, 2, 3, 40, 42),
    (320, 80, 16, 4, 160, 6, 2, 37, 39),
])
def test_mirrors_at_the_new_widths_by_hand(H, piece, box, stages, tile_n, n_tiles, dz, steps1,
                                           steps3):
    """``csrc/tile64.cuh``'s and ``csrc/resnetfc_bwd.cu``'s constants at the
    new widths, by hand: the pieces and their weight boxes (64 x 32 with the
    64-byte swizzle, 64 x 16 with the 32-byte one), the ring's stages within
    96 KB, a view-sum slot of H / 4 f32 a thread, the weights kernel's tile,
    the data kernel's dz steps and stored program (sn64's widths at 1 view,
    and at 3 with the mean at block 3)."""
    lim, dlim, wlim = rf.TILE_LIMITS[H], rv.DATA_LIMITS[H], rv.WEIGHT_LIMITS[H]
    assert rf.piece_cols(H) == piece and (H // 2) % piece == 0 and piece % box == 0
    stage = 2 * (piece // box) * 64 * box * 2  # two warpgroups' boxes of 64 K rows
    assert rf.ring_stage_bytes(H) == stage and lim.stages == dlim.stages == stages
    assert stages * stage <= 3 * 32768 < (stages + 1) * stage
    assert lim.smem == dlim.smem == 2 * 65536 + stages * stage + 1024 <= rf.MAX_SMEM_BYTES
    assert lim.slot_floats == dlim.slot_floats == H // 4 * 256 and lim.hidden == dlim.hidden == H
    assert rv.weight_tile_n(H) == wlim.tile_n == tile_n and H % tile_n == 0
    blk = rv.WTask(name="blocks.0.fc_0", a="ws_act", a_plane=0, M=H, g_plane=0, P=64)
    assert rv.weight_tiles(blk, H, wlim) == n_tiles  # an H x H dW
    assert rv.dz_pieces(512, H) == dz
    assert rv.data_steps(5, 3, 1, 5, 512, H) == steps1 <= dlim.max_steps
    assert rv.data_steps(5, 3, 3, 3, 512, H) == steps3
    assert rf.dense_steps(5, 3, C=512) == 14  # the forward's program does not depend on H


def _unpadded(tw: rf.Tower) -> rf.Tower:
    """The tower at its own width: the padded weights sliced off."""
    H = tw.d_hidden
    return rf.Tower(tw.w_in[:, :H], tw.b_in[:H], tw.w_z[..., :H], tw.b_z[:, :H],
                    tw.w_blk[:, :, :H, :H], tw.b_blk[:, :, :H], tw.w_out[:H], tw.b_out,
                    tw.d_in, H)


@pytest.mark.parametrize("H,NS", [(1, 1), (100, 3), (200, 1), (200, 3), (448, 1), (500, 3),
                                  (600, 1), (960, 3)])
def test_padded_tower_is_the_tower(H, NS):
    """The packed tower at the library's width: zeros past H; its plain
    forward and plain backward (what the CPU route runs) against the same
    tower unpadded, and the module's gradients through the autograd Function
    against autograd of the plain module."""
    d_in, C, nb, cl, sb, B_obj = 42, 64, 4, 2, 2, 20
    g = torch.Generator().manual_seed(H)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=cl,
                    impl="cuda")
    plain = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=cl,
                     impl="torch")
    with torch.no_grad():
        for name, p in port.named_parameters():
            std = 0.05 if name.endswith("bias") else p.shape[1] ** -0.5
            p.copy_(torch.randn(p.shape, generator=g) * std)
    plain.load_state_dict(port.state_dict())
    tw = port.tower(torch.device("cpu"))
    L = rf.library_width(H)
    assert tw.w_in.shape[1] == L and tw.d_hidden == H and tw.w_blk.shape[2:] == (L, L)
    for pad in (tw.w_in[:, H:], tw.b_in[H:], tw.w_z[..., H:], tw.b_z[:, H:], tw.w_blk[:, :, H:],
                tw.w_blk[:, :, :, H:], tw.b_blk[:, :, H:], tw.w_out[H:]):
        assert not pad.any()
    rows = sb * NS * B_obj
    x = torch.randn(rows, d_in, generator=g)
    z = torch.randn(rows, C, generator=g)
    cot = torch.randn(4, sb * B_obj, generator=g)
    kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
    un = _unpadded(tw)
    a, b = rf.resnetfc_reference(z, x, tw, nb, **kw), rf.resnetfc_reference(z, x, un, nb, **kw)
    assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    gp = rv.resnetfc_bwd_reference(cot, z, x, tw, nb, True, **kw)
    gu = rv.resnetfc_bwd_reference(cot, z, x, un, nb, True, **kw)
    own = {"w_in": (Ellipsis, slice(0, H)), "b_in": (slice(0, H),),
           "w_z": (Ellipsis, slice(0, H)), "b_z": (Ellipsis, slice(0, H)),
           "w_blk": (Ellipsis, slice(0, H), slice(0, H)), "b_blk": (Ellipsis, slice(0, H)),
           "w_out": (slice(0, H),)}
    for name in rv.Grads._fields:
        a, b = getattr(gp, name), getattr(gu, name)
        if name in own:
            rest = a.clone()
            rest[own[name]] = 0
            assert not rest.any(), name  # the padded entries are zero
            a = a[own[name]]
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= 1e-6 * max(1.0, b.abs().max().item()), name
    # through the module: the Function hands back the module's own shapes
    zx = torch.cat([z, x], -1).requires_grad_()
    ga = torch.autograd.grad((port(zx, (NS, B_obj)).reshape(-1, 4).t() * cot).sum(),
                             [zx, *port.parameters()])
    gb = torch.autograd.grad((plain(zx, (NS, B_obj)).reshape(-1, 4).t() * cot).sum(),
                             [zx, *plain.parameters()])
    for a, b in zip(ga, gb):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-5 * max(1.0, b.abs().max().item())


# ----------------------------------------------------------------------------
# the slice at d_hidden 192 (its own library) and 200 (the 256 library, padded)
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world192():
    return make_world(192)


@pytest.fixture(scope="module")
def world200():
    return make_world(200)


@pytest.mark.parametrize("H", [192, 200])
def test_slice_takes_the_kernels_on_a_card(H):
    """Under ``auto`` the route rule sends sn64's heads at d_hidden 192 and
    200 to the kernels on a CUDA device, forward and under grad, from 1 and
    3 views."""
    takes_the_kernels_on_a_card(H)


@pytest.mark.parametrize("H,NS,cap", [(192, 1, 2048), (192, 3, 0), (200, 1, 0), (200, 3, 4096)])
def test_query_matches_jax(world192, world200, monkeypatch, H, NS, cap):
    """The fused gather (row 1) or the dense forward (row 2) from one view,
    the multi-view dense forward (row 3) or gather (row 4) from three, in
    their plain versions (200: on the padded tower), against the JAX Pallas
    kernels in interpret mode at the unpadded width; both heads."""
    query_matches_jax(world192 if H == 192 else world200, monkeypatch, NS, cap)


@pytest.mark.parametrize("H,NS", [(192, 3), (200, 1)])
def test_render_rays_matches_jax(world192, world200, H, NS):
    """Encode, the kernel route's query (plain versions), the samplers and
    the compositing from NS views against JAX's render_rays on the same
    draws: weights, rgb and depth of both passes."""
    world = world192 if H == 192 else world200
    render_rays_matches_jax(world, make_jax_render(world), NS)


@pytest.mark.parametrize("H", [192, 200])
def test_train_step_matches_jax_trainer(tmp_path, monkeypatch, H):
    """One ``-V 1`` step of the kernel route (the dense forward's plain
    version and the backward's plain transcription through the autograd
    Function, on the padded tower at 200; remat off, as on the card) against
    the JAX trainer at the unpadded width."""
    tr = train_step_matches_jax_trainer(tmp_path, monkeypatch, H)
    assert tr.net.mlp_fine.tower(torch.device("cpu")).w_in.shape[1] == rf.library_width(H)


@pytest.mark.parametrize("NS,sb,B_obj,H", [(1, 1, 96, 320), (3, 2, 20, 448)])
def test_plain_backward_matches_pallas_interpret(NS, sb, B_obj, H):
    """A 3-block tower (the latent in blocks 0-1, the mean at block 2): the
    weights kernel's plain version on the plain workspace, and the plain
    backward, against the JAX ``_bwd_kernel`` in interpret mode --
    ``tests/test_torch_bwd_weights.py``'s check at these widths."""
    bwt.test_weights_reference_matches_pallas_interpret(NS, sb, B_obj, 42, 64, H, 3, 2)
