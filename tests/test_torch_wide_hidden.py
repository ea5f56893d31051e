"""ResnetFC towers wider than 512 on the port's forward route, on the CPU.

Past 512 columns one CTA cannot hold a 64-point tile (its f32 stream alone
fills an SM's registers), so the forward kernels are built at d_hidden 1024
on a cluster of two CTAs, each owning 512 of the columns
(``csrc/tile64.cuh``, ``CLUSTER``), and every width from 513 to 1023 runs
zero-padded on that library (``rf.library_width``, ``rf.pack_tower``).  No
backward library is built past 512: such a tower trains on the plain field.

* The plain versions of rows 1-4 (the dense forward, the fused gather, the
  multi-view dense forward and gather) and of row 6 (their deferred code,
  ``RawCode``) at d_hidden 1024 and at 600 (packed at 1024) against the
  JAX ``_kernel_2d``, ``_kernel_2d_gather``, ``_kernel_2d_mv`` and
  ``_kernel_2d_mv_gather`` in interpret mode, from 1 and 3 views, at a
  ragged last tile and a 2- or 3-block tower, weights carried by
  ``from_jax_variables``: 1e-4 of max(1, max|ref|), the bar of
  ``tests/test_torch_fwd_*.py`` (f32 sums reassociated).
* The slice at 1024: ``query`` on the fused gather from 1 view and the
  multi-view dense route from 3, and ``render_rays`` from 1 view, against
  the JAX package (``tests/test_torch_hidden64.py``'s helpers and bars;
  the render at 2e-4, see its test).
* The route rule: the forward kernels at 513-1024 under ``auto`` on a
  (faked) card, plain under grad (and ``field_backward_in_kernel`` off),
  ``ValueError`` past 1024 and under grad with ``impl="cuda"``.
* The 1024 library's limits mirrored by hand: a cluster of 2, a 32 KB ring
  of 2 stages, a 128 KB block operand, 230,400 B of shared memory a CTA
  (<= 232,448), the multi-view kernels' pairs; ``build_all`` builds no
  backward library at 1024.  (``tests/test_torch_hidden_widths.py`` holds
  towers padded onto the 1024 library against the same towers unpadded.)
* ``chip_smoke.py``'s frame gate (``frame_gate``) and its bf16-alone route
  (``bf16_alone``: the four forward wrappers as their plain versions at
  bf16 operands, restored on leaving it).
* No kernel library is built or loaded on the CPU.

About 22 s alone, 27 s with the imports (one JAX interpret compile a case).  The kernels
themselves run on the card only; ``chip_smoke.py`` (phase 17's wide part)
holds them against these plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.ops import resnetfc_pallas as rp
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from test_torch_fwd_gather_mv import _setup
from test_torch_hidden64 import (_conf, make_jax_render, make_world, query_matches_jax,
                                 render_rays_matches_jax)

CUDA = torch.device("cuda")  # compared by type only: nothing is allocated on it
TOL = 1e-4


@pytest.mark.parametrize("H", [1024, 600])
@pytest.mark.parametrize("kind,NS,sb,B,nb,cl,raw_code", [
    ("dense", 1, 1, 100, 2, 1, False),  # row 2
    ("gather", 1, 1, 160, 2, 2, True),  # row 1, deferred code (row 6)
    ("dense_mv", 3, 2, 50, 3, 2, True),  # row 3, two objects
    ("gather_mv", 3, 1, 100, 2, 1, False),  # row 4
])
def test_plain_forwards_match_pallas_interpret(H, kind, NS, sb, B, nb, cl, raw_code):
    """Each forward row's plain version (CPU tensors: no launch) on the
    tower packed at 1024 against the JAX kernel in interpret mode at the
    tower's own width; taps outside each table in some rows."""
    C, T = 32, 64
    params, port, raw, code, enc, tables, idx, w = _setup(NS * sb, B, C, H, nb, cl, T,
                                                          seed=H + NS * B + raw_code)
    tw = port.tower(torch.device("cpu"))
    assert tw.w_in.shape[1] == 1024 and tw.d_hidden == H
    if raw_code:
        jx = rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code))
        x = rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code))
    else:
        jx, x = jnp.asarray(enc), torch.from_numpy(enc)
    gather = kind.startswith("gather")
    if gather:
        tabs = tables[:NS]
        jz = rp.LatentGather(jnp.asarray(tabs if NS > 1 else tabs[0]), jnp.asarray(idx),
                             jnp.asarray(w))
    else:
        z = np.random.default_rng(H + B).normal(size=(NS * sb * B, C)).astype(np.float32)
        jz = jnp.asarray(z)
    ref = rp.resnetfc_pallas(params, (jz, jx), NS=NS, d_latent=C, d_in=enc.shape[1],
                             n_blocks=nb, combine_layer=cl, sb=sb,
                             block_points=128, interpret=True, planar_out=True)
    ref = np.asarray(ref)[0]
    rf.reset_launches()
    ti, tww = torch.from_numpy(idx), torch.from_numpy(w)
    if kind == "dense":
        out = rf.resnetfc_dense(torch.from_numpy(z), x, tw, nb)
    elif kind == "gather":
        out = rf.resnetfc_gather(ti, tww, torch.from_numpy(tabs[0]), x, tw, nb)
    elif kind == "dense_mv":
        out = rf.resnetfc_dense_mv(torch.from_numpy(z), x, tw, nb, NS, cl, sb)
    else:
        out = rf.resnetfc_gather_mv(ti, tww, torch.from_numpy(tabs), x, tw, nb, cl)
    assert not any(rf.LAUNCHES.values())  # CPU tensors: the plain version, no launch
    assert tuple(out.shape) == ref.shape == (4, sb * B)
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), err
    assert not rf._LIBS


# ----------------------------------------------------------------------------
# the slice at d_hidden 1024
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world1024():
    return make_world(1024)


@pytest.mark.parametrize("NS,cap", [(1, 2048), (3, 0)])
def test_query_matches_jax(world1024, monkeypatch, NS, cap):
    """sn64's model with both heads at d_hidden 1024: the fused gather (row
    1) from one view, the multi-view dense forward (row 3) from three, in
    their plain versions, against the JAX Pallas kernels in interpret mode;
    both heads (rows 2 and 4 against their JAX kernels above)."""
    query_matches_jax(world1024, monkeypatch, NS, cap)


def test_render_rays_matches_jax(world1024):
    """Encode, the kernel route's query (plain versions), the samplers and
    the compositing from 1 view against JAX's render_rays on the same
    draws, at 2e-4 of max(1, max|ref|): the field's f32 sums run over 1024
    columns in another order, and the fine pass draws its samples from the
    coarse weights (the fine rgb reads 1.5e-4 here, the query 1e-4's bar)."""
    render_rays_matches_jax(world1024, make_jax_render(world1024, views=(1,)), 1, tol=2e-4)


# ----------------------------------------------------------------------------
# the route rule and the mirrored limits
# ----------------------------------------------------------------------------


def _tower(H, impl="auto"):
    with torch.device("meta"):
        return ResnetFC(d_in=42, d_out=4, n_blocks=5, d_latent=512, d_hidden=H,
                        combine_layer=3, impl=impl)


@pytest.mark.parametrize("H", [513, 600, 1000, 1024])
def test_route_takes_the_forward_kernels_and_trains_plain(H):
    """Under ``auto`` on a (faked) card a tower of 513-1024 takes the 1024
    library's forward kernels from 1 and 3 views (the fused gather's widths
    too) and the plain field under grad; under ``cuda`` the grad route
    raises ``ValueError`` (not a missing library's ``KeyError``) before any
    wrapper.  No library is built or loaded."""
    t = _tower(H)
    for NS in (1, 3):
        assert t._kernel_route((NS, 64), CUDA, False)
        assert t._kernel_route((NS, 64), CUDA, False, gather=True)
        assert not t._kernel_route((NS, 64), CUDA, True)
    t.impl = "cuda"
    with pytest.raises(ValueError, match="backward kernels take d_hidden up to 512"):
        t._kernel_route((1, 64), CUDA, True)
    assert rf.library_width(H) == 1024
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("H", [1025, 1536])
def test_route_refuses_towers_past_1024(H):
    """Past the widest library: plain under ``auto`` forward and under
    grad, ``ValueError`` under ``cuda``."""
    for grad in (False, True):
        t = _tower(H)
        assert not t._kernel_route((1, 64), CUDA, grad)
        t.impl = "cuda"
        with pytest.raises(ValueError, match="d_hidden 1 to 1024"):
            t._kernel_route((3, 64), CUDA, grad)
    with pytest.raises(ValueError, match="d_hidden 1 to 1024"):
        rf.tile_limits(H)


def test_wide_model_renders_on_the_kernels_and_trains_plain(monkeypatch):
    """sn64's model at d_hidden 1024 (both heads), built as
    ``chip_smoke.py``'s ``narrow_conf`` builds it: with card parameters the
    fused gather is taken and train steps leave the backward kernels
    (``field_backward_in_kernel`` off, so the trainer keeps its remat
    default); the card is faked, nothing is allocated on it."""
    from types import SimpleNamespace

    from pixelnerf_tpu_torch.config import hocon

    net = make_model(_conf(hocon.parse_file, 1024)["model"], mlp_impl="auto", device="meta",
                     diff_mode=True)
    assert net.mlp_fine.d_hidden == net.mlp_coarse.d_hidden == 1024
    monkeypatch.setattr(net, "parameters", lambda: iter([SimpleNamespace(device=CUDA)]))
    assert [net.field_backward_in_kernel(nv) for nv in (1, 3)] == [False, False]
    with net.eval_routes():  # a render under no_grad
        assert net._fused_gather_ok(torch.empty(1, 32, 32, 512, device="meta"), 1)
    for mlp in (net.mlp_coarse, net.mlp_fine):
        assert mlp._kernel_route((1, 64), CUDA, False, gather=True)
    assert not rf._LIBS and not rv._LIBS


def test_1024_limits_by_hand():
    """``csrc/tile64.cuh``'s constants at d_hidden 1024, by hand: a tile is
    a cluster of two CTAs, each the 512-wide layout (two warpgroups of 256
    columns, here in four m64n64k16 pieces, 128 stream registers a thread,
    so a view-sum slot of 128 x 256 f32 a CTA); the block products' operand
    the whole 1024-wide activation (64 x 1024 bf16, 128 KB) beside the 64
    KB code / latent tile, which leaves a 32 KB ring: 2 stages of 64 K rows
    x two warpgroups x one 64-column box (16 KB); the multi-view kernels'
    persistent grid in pairs."""
    lim = rf.TILE_LIMITS[1024]
    assert (lim.cluster, lim.hidden, lim.tile, lim.threads) == (2, 1024, 64, 256)
    assert rf.cluster_ctas(1024) == 2 and all(rf.cluster_ctas(H) == 1 for H in rf.BWD_HIDDEN)
    assert rf.piece_cols(1024) == 64
    stage = 2 * 64 * 64 * 2
    assert rf.ring_stage_bytes(1024) == stage == 16384 and lim.stages == 2
    assert lim.smem == 64 * 1024 * 2 + 64 * 512 * 2 + 2 * stage + 1024 == 230400
    assert lim.smem <= rf.MAX_SMEM_BYTES == 232448
    assert lim.slot_floats == 128 * 256 == rf.TILE_LIMITS[512].slot_floats
    assert (lim.max_k, lim.max_c, lim.max_gather_c, lim.max_out, lim.max_steps) == \
        (512, 4096, 4096, 4, 128)
    assert rf.dense_mv_grid(2000, 132, lim) == 2 * 32 and rf.dense_mv_grid(393216, 132, lim) == 132
    assert rf.dense_grid(2000, lim) == 32  # tiles; the library launches a pair each
    assert rf.FWD_HIDDEN == rf.BWD_HIDDEN + (1024,) and tuple(rf.TILE_LIMITS) == rf.FWD_HIDDEN
    assert 1024 not in rv.DATA_LIMITS and 1024 not in rv.WEIGHT_LIMITS
    with pytest.raises(ValueError, match="backward kernels take d_hidden up to 512"):
        rv.check_backward_width(1024)
    assert not rf._LIBS and not rv._LIBS


def test_build_all_builds_no_backward_at_1024(monkeypatch):
    """``build_all`` starts no ``nvcc`` for the backward at 1024 (its tile
    has no cluster layout: the header's ``static_assert``), and ``build`` /
    the backward's loader refuse that width with ``ValueError``."""

    def no_nvcc():
        raise AssertionError("nvcc started")

    monkeypatch.setattr(rf, "_nvcc", no_nvcc)
    assert rf.build_all(("bwd",), (1024,)) == {}
    for build in (lambda: rf.build("bwd", 1024), lambda: rv._lib(1024)):
        with pytest.raises(ValueError, match="no bwd library"):
            build()
    assert not rf._LIBS and not rv._LIBS



@pytest.mark.parametrize("p,p_alone,p_kernel,passes", [
    (40.0, 30.0, 10.0, True),  # the bar against the plain f32 route
    (39.9, 40.1, 60.0, False),  # bf16 alone reaches 40 dB: so must the kernels
    (39.77, 39.80, 62.4, True),  # bf16 alone misses it; the kernels read as bf16 alone
    (39.2, 39.80, 62.4, False),  # more than FRAME_ALONE_SLACK_DB below bf16 alone
    (39.77, 39.80, 39.9, False),  # the kernel frame off the bf16-alone frame
])
def test_chip_smoke_frame_gate(p, p_alone, p_kernel, passes):
    """``chip_smoke.frame_gate``: a kernel frame passes at >= 40 dB against
    the plain f32 route, or, where bf16 alone (the kernels' plain versions)
    reads below 40 dB there, at >= 40 dB against the bf16-alone frame and
    within ``FRAME_ALONE_SLACK_DB`` (0.5 dB) of bf16 alone's reading."""
    import chip_smoke

    assert chip_smoke.FRAME_ALONE_SLACK_DB == 0.5
    assert chip_smoke.frame_gate(p, p_alone, p_kernel) is passes


def test_chip_smoke_bf16_alone_is_the_plain_bf16_version():
    """Inside ``chip_smoke.bf16_alone`` the four forward wrappers compute
    their plain versions at bf16 operands (the latent looked up and rounded
    to bf16) -- on CPU tensors too, where the wrappers otherwise take the f32
    plain versions -- and on leaving it the wrappers are restored."""
    import chip_smoke

    NS, B, C, H, nb, cl = 3, 40, 64, 128, 2, 1
    _, port, _, _, enc, tables, idx, w = _setup(NS, B, C, H, nb, cl, T=64)
    tw = port.tower(torch.device("cpu"))
    b16 = torch.bfloat16
    idx, w = torch.as_tensor(idx), torch.as_tensor(w)
    x, tables = torch.as_tensor(enc), torch.as_tensor(tables)
    z = rf.gather_reference(idx, w, tables, b16)
    saved = {n: getattr(rf, n) for n in ("resnetfc_dense", "resnetfc_gather",
                                         "resnetfc_dense_mv", "resnetfc_gather_mv")}
    with chip_smoke.bf16_alone():
        got = {
            "gather": rf.resnetfc_gather(idx[:B], w[:B], tables[0], x[:B], tw, nb),
            "dense": rf.resnetfc_dense(z[:B], x[:B], tw, nb),
            "gather_mv": rf.resnetfc_gather_mv(idx, w, tables, x, tw, nb, cl),
            "dense_mv": rf.resnetfc_dense_mv(z, x, tw, nb, NS, cl),
        }
    assert {n: getattr(rf, n) for n in saved} == saved
    want = {
        "gather": rf.resnetfc_reference(z[:B], x[:B], tw, nb, compute_dtype=b16),
        "dense": rf.resnetfc_reference(z[:B], x[:B], tw, nb, compute_dtype=b16),
        "gather_mv": rf.resnetfc_reference(z, x, tw, nb, compute_dtype=b16, NS=NS,
                                           combine_layer=cl),
        "dense_mv": rf.resnetfc_reference(z, x, tw, nb, compute_dtype=b16, NS=NS,
                                          combine_layer=cl),
    }
    for n in want:
        assert torch.equal(got[n], want[n]), n
    # outside it, the CPU wrappers take the f32 plain versions, which differ
    assert not torch.equal(rf.resnetfc_dense(z[:B], x[:B], tw, nb), want["dense"])
