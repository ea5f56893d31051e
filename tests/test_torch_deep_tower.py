"""Towers deeper than sn64's 5 blocks on the port's kernel route, on the CPU.

The forward kernels store a program of 128 steps (62 blocks at sn64's three
injections and one view, 61 at NS views), the backward's data kernel one of
512 16-bit steps (319 at 62 blocks there: every tower the forward's program
takes at sn64's other widths); the weights kernel reads a tensor map per
operand plane and a product per weight (4 n + 3 maps and 2 n + 4 products
at n blocks and three injections) from a table in device memory of 256
maps and 128 products, which holds every tower the forward takes.  The
route rule trains a tower on the kernels to the depth ``chip_smoke.py``'s
gates and train-step parity hold on the card (``GRAD_MAX_BLOCKS``, 32
blocks); deeper ones render on the forward kernels and train
plain, and so does a tower past the data kernel's program (d_hidden 64 with
four 4096-wide injections: 44 blocks).

* The plain backward of a 7-block tower (``workspace_reference`` and
  ``bwd_weights_reference``, and ``resnetfc_bwd_reference``) against the JAX
  ``_bwd_kernel`` through ``resnetfc_pallas_diff`` in interpret mode, from 1
  and 3 views, at d_hidden 64 and 384: 5e-4 of max(max|ref|, 1e-3), as
  ``tests/test_torch_bwd_weights.py`` holds sn64's depth.
* ``weight_plan`` at 6, 8, 49 and 62 blocks (the forward's deepest), at NS
  1 and 3: its maps and products; the forward's deepest tower fits the
  weights kernel and the data kernel's program and is past the gated
  depth; every tower the forward's program takes fits the weights kernel's
  plan, at every width.
* One ``-V 1`` trainer step of sn64's conf with 7-block heads at d_hidden 64,
  and with 8-block heads on a 138-wide code (11 frequencies over xyz and
  the view direction: kin 144), on the kernel route
  (its autograd Function, the backward's plain transcription) against the
  JAX ``Trainer``: loss rtol 2e-3, grad norm rtol 5e-3, the bars of
  ``tests/test_torch_train_step.py``.
* The route rule sends 6- to 32-block towers to the kernels under grad, and
  33- to 61-block ones to the plain field (raising under ``cuda``).
"""

import pytest
import torch

import test_torch_bwd_weights as bwt
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from test_torch_hidden64 import takes_the_kernels_on_a_card, train_step_matches_jax_trainer

NB = 7
GATED = 32  # the deepest tower the route trains on the kernels (GRAD_MAX_BLOCKS)
N_SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("NS,sb,B_obj,H", [(1, 1, 150, 64), (3, 2, 40, 64), (1, 1, 96, 384)])
def test_deep_plain_backward_matches_pallas_interpret(NS, sb, B_obj, H):
    """A 7-block tower (the 512-wide latent in blocks 0-2, the mean at block
    3): the weights kernel's plain version on the plain workspace, and the
    plain backward, against the JAX ``_bwd_kernel`` in interpret mode --
    ``tests/test_torch_bwd_weights.py``'s check at this depth."""
    bwt.test_weights_reference_matches_pallas_interpret(NS, sb, B_obj, 42, 512, H, NB, 3)


@pytest.mark.parametrize("NS,pre", [(1, None), (3, 3)])
@pytest.mark.parametrize("nb,maps,tasks", [(6, 27, 16), (8, 35, 20), (49, 199, 102),
                                           (62, 251, 128)])
def test_weight_plan_past_five_blocks(nb, maps, tasks, NS, pre):
    """sn64's widths at nb blocks: one tensor map per distinct operand plane
    (4 a block, lin_in's, the latent's and g_in's), one product per weight;
    62 blocks, the forward's deepest, fill the kernel's 128 products."""
    lim = rv.WEIGHT_LIMITS[512]
    plan = rv.weight_plan(48, 512, 512, nb, 3, NS, pre or nb, 2000, lim, N_SMS)
    assert len(plan.maps) == maps == 4 * nb + 3 <= lim.max_maps
    assert len(plan.table) // 6 == tasks == 2 * nb + 4 <= lim.max_tasks
    assert plan.tiles == 2 + 3 * 8 + 2 * nb * 8  # lin_in, lin_z, the blocks on 128 x 256 tiles
    offsets = plan.table[5::6]
    assert offsets[-1] + 512 * 512 == 48 * 512 + 3 * 512 * 512 + 2 * nb * 512 * 512


@pytest.mark.parametrize("NS", [1, 3])
def test_forwards_deepest_tower_renders_but_does_not_train_on_the_kernels(NS):
    """The forward's deepest tower at sn64's widths (62 blocks at one view,
    61 at NS views: up to 128 stored steps) fits the weights kernel's table
    and the data kernel's program (319 / 316 16-bit steps of 512), but is
    past the depth the card's gates hold: the route rule keeps it on the
    forward kernels and trains it plain."""
    nb = 62 if NS == 1 else 61
    assert rf.dense_steps(nb, 3, NS, 3, 512) <= 128 < rf.dense_steps(nb + 1, 3, NS, 3, 512)
    plan = rv.weight_plan(48, 512, 512, nb, 3, NS, 3 if NS > 1 else nb, 2000,
                          rv.WEIGHT_LIMITS[512], N_SMS)
    assert len(plan.maps) == 4 * nb + 3 and len(plan.table) // 6 == 2 * nb + 4
    rv.check_data_program(nb, 3, NS, 3 if NS > 1 else nb, rv.DATA_LIMITS[512], 512)
    assert rv.data_steps(nb, 3, NS, 3 if NS > 1 else nb, 512, 512) == (319 if NS == 1 else 316)
    with torch.device("meta"):
        t = ResnetFC(d_in=42, d_out=4, n_blocks=nb, d_latent=512, d_hidden=512, combine_layer=3,
                     impl="auto")
    cuda = torch.device("cuda")  # compared by type only: nothing is allocated on it
    assert t._kernel_route((NS, 64), cuda, False) and not t._kernel_route((NS, 64), cuda, True)


@pytest.mark.parametrize("H", rf.BWD_HIDDEN)
def test_every_tower_the_forward_takes_fits_the_weights_kernel(H):
    """For every depth and injection count whose program the forward
    kernels store (and so every one the data kernel's takes), at one view
    and at three (the mean after the injections, or at the last block), the
    weights kernel's plan fits its maps and products."""
    lim, flim, dlim = rv.WEIGHT_LIMITS[H], rf.TILE_LIMITS[H], rv.DATA_LIMITS[H]
    deepest = {"forward": 0, "data": 0}
    for nb in range(1, 66):
        for n_lin_z in range(nb + 1):
            for NS, pre in [(1, nb)] + [(3, p) for p in {n_lin_z, nb - 1} if n_lin_z <= p < nb]:
                if rf.dense_steps(nb, n_lin_z, NS, pre, 512) > flim.max_steps:
                    continue
                deepest["forward"] = max(deepest["forward"], nb)
                if rv.data_steps(nb, n_lin_z, NS, pre, 512, H) <= dlim.max_steps:
                    deepest["data"] = max(deepest["data"], nb)
                rv.weight_plan.__wrapped__(48, H, 512, nb, n_lin_z, NS, pre, 64 * NS, lim, N_SMS)
    # 1 + 2 n stored steps without a latent; the data kernel's 3 + 5 n
    assert deepest == {"forward": 63, "data": 63}


def test_deep_tower_takes_the_kernels_under_grad():
    """Under ``auto`` on a CUDA device 6-, 7- and 32-block towers take the
    kernels forward and under grad, from 1 and 3 views, at every width a
    library is built for and at d_hidden 200 (zero-padded onto the 256
    library); d_hidden 576 and 1024 take the forward kernels and train
    plain (no backward library past 512).  Decided from the Python mirrors:
    no library is built or loaded."""
    cuda = torch.device("cuda")  # compared by type only: nothing is allocated on it
    for H in rf.FWD_HIDDEN + (200, 576):
        for nb in (6, NB, GATED):
            with torch.device("meta"):
                t = ResnetFC(d_in=42, d_out=4, n_blocks=nb, d_latent=512, d_hidden=H,
                             combine_layer=3, impl="auto")
            assert all(t._kernel_route((NS, 64), cuda, grad) is (H <= 512 or not grad)
                       for NS in (1, 3) for grad in (False, True)), (H, nb)
    takes_the_kernels_on_a_card(64, 16)  # sn64's conf with 16-block heads
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("nb", [rv.GRAD_MAX_BLOCKS + 1, 48, 61])
def test_tower_past_the_gated_depth_trains_plain(nb):
    """Past ``GRAD_MAX_BLOCKS`` a tower inside the data kernel's program and
    the weights kernel's plan keeps the forward kernels and trains on the
    plain field under ``auto``, from 1 and 3 views; under ``cuda`` the grad
    route raises.  Decided from the Python mirrors: no library is built."""
    assert rv.GRAD_MAX_BLOCKS == GATED
    cuda = torch.device("cuda")  # compared by type only: nothing is allocated on it
    rv.check_data_program(nb, 3, 3, 3, rv.DATA_LIMITS[512], 512)
    with torch.device("meta"):
        t = ResnetFC(d_in=42, d_out=4, n_blocks=nb, d_latent=512, d_hidden=512, combine_layer=3,
                     impl="auto")
    for NS in (1, 3):
        assert t._kernel_route((NS, 64), cuda, False) and not t._kernel_route((NS, 64), cuda, True)
    t.impl = "cuda"
    with pytest.raises(ValueError, match=f"to {GATED} blocks"):
        t._kernel_route((1, 64), cuda, True)
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("nb,num_freqs", [(NB, None), (8, 11)])
def test_train_step_of_a_7_block_tower_matches_jax_trainer(tmp_path, monkeypatch, nb, num_freqs):
    """One ``-V 1`` step of the kernel route (the dense forward's plain
    version and the backward's plain transcription through the autograd
    Function) with 7-block heads at d_hidden 64, and with 8-block heads on
    a code of 11 frequencies over (xyz, viewdir) (d_in 138: kin 144),
    against the JAX trainer: the same weights, batch, host generator and
    render draws."""
    tr_p = train_step_matches_jax_trainer(tmp_path, monkeypatch, 64, nb, num_freqs)
    assert all(len(m.blocks) == nb for m in (tr_p.net.mlp_coarse, tr_p.net.mlp_fine))
    assert tr_p.net.mlp_fine.d_in == (42 if num_freqs is None else 138)
