"""The slice as a whole at d_hidden 384, on the CPU: ``conf/exp/sn64.conf``
with both heads' d_hidden set to 384 (5 blocks, the 512-wide latent in
blocks 0-2, the views' mean at block 3, the 6-frequency code; a random
encoder), the weights carried across from the JAX parameters by
``utils/jax_convert.py::from_jax_variables``.  At 384 a warpgroup's 192
columns are three 64-column pieces, the walk back forms dz in two steps of
384 columns (the second's last 256 past C = 512), and the weights kernel's
output tile is 128 x 192.

* ``query`` from 1 and 3 source views on the kernel route (``impl="cuda"``:
  on CPU tensors the kernels' plain versions, at a fused-gather cap above
  the views' 1024-row tables and at 0, so the gather and the dense routes)
  against the JAX model's Pallas kernels in interpret mode
  (``PIXELNERF_PALLAS_INTERPRET=1``), 1e-4 of max(1, max|ref|) (f32 sums
  reassociated), as ``tests/test_torch_multiview.py`` holds them at its
  small width.
* ``render_rays`` from 1 and 3 views against JAX's ``render_rays`` fed the
  same draws, at the same bar.
* One trainer step at ``-V 1`` on the kernel route (its autograd Function,
  the backward's plain transcription) against the JAX ``Trainer``: loss
  rtol 2e-3 and grad norm rtol 5e-3, the bars of
  ``tests/test_torch_train_step.py``.

The checks are ``tests/test_torch_hidden64.py``'s, at this width: sn64's
renderer cut to 8 coarse and 6 fine samples (3 around the depth) and its
images to 64 px, NMR's own size. The kernels themselves run on the card
only; ``chip_smoke.py`` (phases 17 and 18) holds them against these plain
versions there."""

import pytest

from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from test_torch_hidden64 import (make_jax_render, make_world, query_matches_jax,
                                 render_rays_matches_jax, takes_the_kernels_on_a_card,
                                 train_step_matches_jax_trainer)

H = 384


@pytest.fixture(scope="module")
def world():
    return make_world(H)


@pytest.fixture(scope="module")
def jax_render(world):
    return make_jax_render(world)


def test_d_hidden_384_takes_the_kernels_on_a_card():
    """Under ``auto`` the route rule sends this model's d_hidden 384 heads
    to the kernels on a CUDA device, forward and under grad, from 1 and 3
    views: the 384 library's mirrored limits take sn64's other widths (the
    weights kernel's 128 x 192 tile, the data kernel's 37 stored steps)."""
    takes_the_kernels_on_a_card(H)
    assert rv.WEIGHT_LIMITS[H].tile_n == 192 and rf.TILE_LIMITS[H].stages == 6
    assert rv.data_steps(5, 3, 1, 5, 512, H) == 37 and rv.dz_pieces(512, H) == 2


@pytest.mark.parametrize("NS,cap", [(1, 2048), (1, 0), (3, 4096), (3, 0)])
def test_query_at_d_hidden_384_matches_jax(world, monkeypatch, NS, cap):
    """The fused gather (row 1) or the dense forward (row 2) from one view,
    the multi-view gather (row 4) or dense forward (row 3) from three, in
    their plain versions, against the JAX Pallas kernels in interpret
    mode; both heads."""
    query_matches_jax(world, monkeypatch, NS, cap)


@pytest.mark.parametrize("NS", [1, 3])
def test_render_rays_at_d_hidden_384_matches_jax(world, jax_render, NS):
    """Encode, the kernel route's query (plain versions), the samplers and
    the compositing from NS views against JAX's render_rays on the same
    draws: weights, rgb and depth of both passes."""
    render_rays_matches_jax(world, jax_render, NS)


def test_train_step_at_d_hidden_384_matches_jax_trainer(tmp_path, monkeypatch):
    """One ``-V 1`` step of the kernel route (the dense forward's plain
    version and the backward's plain transcription through the autograd
    Function; remat off, as on the card) against the JAX trainer: the same
    weights, batch, host generator and render draws."""
    train_step_matches_jax_trainer(tmp_path, monkeypatch, H)
