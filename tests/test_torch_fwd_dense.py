"""The port's one-view dense forward (row 2 of PERF.md: ``_kernel_2d``):
``ops/resnetfc_fused.py::resnetfc_dense``, its plain version
``resnetfc_reference`` and the launch helpers of ``resnetfc_fwd_dense``
(``dense_grid``, ``dense_steps``, ``check_dense_widths``, ``check_tma``),
at sn64's d_hidden 512 and at the narrow widths 64, 128 and 256 that the kernels
also take (one library a width).

``resnetfc_fwd_dense`` walks 64-point tiles; every B here leaves its last
tile ragged (2000 = 31 x 64 + 16, and 64 k + 32).  On the CPU the wrapper's
plain version, in f32, is held against the JAX package's ``_kernel_2d``
through ``resnetfc_pallas`` in interpret mode, with the encoded code and
with a ``RawCode``, planar and row-major, to 1e-4 of max(1, max|ref|), the
bar of ``tests/test_torch_multiview.py`` (f32 sums reassociated).  On the
card (``cuda``-marked, skipped here) the kernel is held against the same
plain version in bf16 at the bar of ``tests/test_pallas.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.code import PositionalEncoding as JPositionalEncoding
from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops import resnetfc_pallas as rp
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

# what resnetfc_fwd_dense_kernel fixes, by hand (the library reports it on
# the card): 64-point tiles, 256 threads, 3 stages of 32 KB, at most 4
# outputs, 128 steps a tile and a 512-wide code or latent; a multi-view
# slot of 128 f32 a thread; two 64 KB operand tiles + the ring + 1 KB slack;
# a plan of three tensor maps
LIMITS = rf.DenseLimits(tile=64, threads=256, stages=3, max_out=4, max_steps=128, max_k=512,
                        slot_floats=128 * 256, smem=2 * 65536 + 3 * 32768 + 1024, plan_bytes=448)
PE = dict(num_freqs=6, d_in=3, freq_factor=1.5, include_input=True)  # sn64's code
# the narrow towers' shapes: tests/test_pallas.py's own (d_in 10, C 64, 3
# blocks, the latent in blocks 0-1) and sn64's other widths (the code's 42
# columns, C 512, 5 blocks, the latent in blocks 0-2)
NARROW = {"small": dict(d_in=10, C=64, nb=3, cl=2), "sn64": dict(d_in=None, C=512, nb=5, cl=3)}


def _setup(B, d_latent, H, nb, seed=0, cl=None, d_in=None):
    """JAX ResnetFC parameters drawn from numpy (every parameter live), the
    port module holding the same weights, the sn64 code's raw coordinates
    and flat arrays, the encoded code (or, given ``d_in``, a normal (B,
    d_in) code in its place) and a latent; the latent in the first ``cl``
    blocks (default all)."""
    W, f, p, m = JPositionalEncoding(**PE).flat_arrays(tail=3)
    d_code = W.shape[1]
    d_in = d_code if d_in is None else d_in
    cl = nb if cl is None else cl
    jm = JResnetFC(d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H, combine_layer=cl)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, d_latent + d_in)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * (0.05 if a.ndim == 1 else 1.0 / np.sqrt(a.shape[0])))
        .astype(np.float32), params)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H,
                    combine_layer=cl, impl="cuda")
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    xyz = rng.uniform(-1.4, 1.4, size=(B, 3))
    vd = rng.normal(size=(B, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    raw = np.concatenate([xyz, vd], axis=-1).astype(np.float32)
    enc = (raw.astype(np.float64) @ W).astype(np.float32)
    enc = np.where(m > 0, np.sin(enc * f + p), enc).astype(np.float32)
    if d_in != d_code:
        enc = rng.normal(size=(B, d_in)).astype(np.float32)
    z = rng.normal(size=(B, d_latent)).astype(np.float32)
    return params, port, raw, (W, f, p, m), enc, z


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("raw_code", [False, True])
@pytest.mark.parametrize("B", [2000, 160])
def test_dense_plain_matches_pallas_interpret(B, raw_code, planar):
    """resnetfc_dense on CPU tensors (its plain version) against
    resnetfc_pallas (_kernel_2d) in interpret mode, at a ragged last tile."""
    C, H, nb = 32, 64, 3
    params, port, raw, code, enc, z = _setup(B, C, H, nb, seed=B + raw_code)
    if raw_code:
        jx = rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code))
        x = rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code))
    else:
        jx, x = jnp.asarray(enc), torch.from_numpy(enc)
    ref = rp.resnetfc_pallas(params, (jnp.asarray(z), jx), NS=1, d_latent=C, d_in=enc.shape[1],
                             n_blocks=nb, combine_layer=nb, block_points=512, interpret=True,
                             planar_out=planar)
    ref = np.asarray(ref)[0]
    rf.reset_launches()
    out = rf.resnetfc_dense(torch.from_numpy(z), x, port.tower(torch.device("cpu")), nb, planar)
    assert not any(rf.LAUNCHES.values())  # CPU tensors: the plain version, no launch
    assert tuple(out.shape) == ref.shape == ((4, B) if planar else (B, 4))
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


# the narrower widths these checks were written for; tests/test_torch_hidden_widths.py
# holds the plain versions at 192 and at a padded width against the JAX kernels
@pytest.mark.parametrize("H", [64, 128, 256, 384])
@pytest.mark.parametrize("shape,B,raw_code,planar", [("small", 150, False, True),
                                                     ("sn64", 160, False, False),
                                                     ("sn64", 160, True, True)])
def test_dense_plain_at_narrow_widths_matches_pallas_interpret(H, shape, B, raw_code, planar):
    """The narrow towers the kernels take (d_hidden 64, 128 and 256): the plain
    version against ``_kernel_2d`` in interpret mode at tests/test_pallas.py's
    small shape and at sn64's other widths, the last tile ragged, weights
    carried by ``from_jax_variables``."""
    d_in, C, nb, cl = NARROW[shape].values()
    params, port, raw, code, enc, z = _setup(B, C, H, nb, seed=H + B + raw_code, cl=cl, d_in=d_in)
    if raw_code:
        jx = rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code))
        x = rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code))
    else:
        jx, x = jnp.asarray(enc), torch.from_numpy(enc)
    ref = rp.resnetfc_pallas(params, (jnp.asarray(z), jx), NS=1, d_latent=C, d_in=enc.shape[1],
                             n_blocks=nb, combine_layer=cl, block_points=512, interpret=True,
                             planar_out=planar)
    ref = np.asarray(ref)[0]
    tw = port.tower(torch.device("cpu"))
    assert tuple(tw.w_blk.shape) == (nb, 2, H, H) and tw.w_z.shape[0] == cl
    rf.reset_launches()
    out = rf.resnetfc_dense(torch.from_numpy(z), x, tw, nb, planar)
    assert not any(rf.LAUNCHES.values())
    assert tuple(out.shape) == ref.shape == ((4, B) if planar else (B, 4))
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("H", rf.FWD_HIDDEN)
def test_sn64_latent_is_one_piece_at_every_width(H):
    """The latent's pieces follow the operand tile's 512-column capacity,
    not the tower's width: sn64's C = 512 is one piece (14 steps at one view,
    15 at any view count) at every library's width alike, 1024 two;
    each width's limits take its own H and refuse the others' (and 576,
    which runs zero-padded on the 1024 library, and 1025, past it)."""
    lim = rf.TILE_LIMITS[H]
    assert rf.latent_pieces(512) == 1 and rf.latent_pieces(1024) == 2
    assert rf.dense_steps(5, 3, C=512) == 14 and rf.dense_steps(5, 3, 3, 3, C=512) == 15
    rf.check_dense_widths(48, H, 512, 3, 5, 4, lim)  # sn64's other widths
    rf.check_dense_widths(48, H, 1024, 3, 5, 4, lim)
    rf.check_dense_widths(512, H, 16, 1, 1, 1, lim)  # the widest code: one operand tile
    rf._check_gather_width(512, lim)
    for other in (576, 1025) + tuple(h for h in rf.FWD_HIDDEN if h != H):
        with pytest.raises(ValueError, match="d_hidden"):
            rf.check_dense_widths(48, other, 512, 3, 5, 4, lim)


@pytest.mark.parametrize("B,tiles", [(1, 1), (64, 1), (65, 2), (2000, 32), (49152, 768),
                                     (393216, 6144)])
def test_dense_grid_is_one_cta_a_64_point_tile(B, tiles):
    assert rf.dense_grid(B, LIMITS) == tiles


def test_dense_program_is_the_data_kernels_recompute():
    """A dense tile's steps are those of the data kernel's recompute at one
    view: lin_in, the injections, fc_0 and fc_1 of every block (14 at sn64)."""
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv

    assert rf.dense_steps(5, 3) == 14
    for nb, nlz in ((1, 0), (2, 1), (5, 3), (6, 6)):
        # data_steps at NS = 1: the recompute, lin_out, the walk back
        walk_back = 1 + 3 * nb + nlz + 1
        assert rf.dense_steps(nb, nlz) == rv.data_steps(nb, nlz, 1, nb, 512, 512) - walk_back


def test_check_dense_widths_takes_sn64_and_refuses_the_rest():
    rf.check_dense_widths(48, 512, 512, 3, 5, 4, LIMITS)  # sn64
    rf.check_dense_widths(512, 512, 16, 1, 1, 1, LIMITS)
    rf.check_dense_widths(48, 512, 40, 0, 2, 4, LIMITS)  # no latent: C is not read
    for args, what in [((48, 256, 512, 3, 5, 4), "d_hidden"),
                       ((40, 512, 512, 3, 5, 4), "kin"),
                       ((528, 512, 512, 3, 5, 4), "kin"),
                       ((48, 512, 520, 3, 5, 4), "C"),
                       ((48, 512, 40, 3, 5, 4), "C"),
                       ((48, 512, 512, 6, 5, 4), "n_lin_z"),
                       ((48, 512, 512, 3, 5, 5), "outputs"),
                       ((48, 512, 512, 3, 63, 4), "steps")]:
        with pytest.raises(ValueError, match=what):
            rf.check_dense_widths(*args, LIMITS)


def test_check_tma_refuses_what_tma_cannot_read_in_place():
    a = torch.zeros(64, 512, dtype=torch.bfloat16)
    rf.check_tma(a, "a")
    with pytest.raises(ValueError, match="contiguous"):
        rf.check_tma(a[:, ::2], "a")
    with pytest.raises(ValueError, match="16-byte"):
        rf.check_tma(a.flatten()[1:513].reshape(1, 512), "a")
    with pytest.raises(ValueError, match="16-byte"):
        rf.check_tma(torch.zeros(64, 4, dtype=torch.bfloat16), "a")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("raw_code", [False, True])
@pytest.mark.parametrize("B", [2000, 160])
def test_dense_kernel_matches_plain_on_card(cuda_device, B, raw_code):
    """sn64 widths at a ragged last tile: the kernel against its plain
    version in bf16 (the bar of tests/test_pallas.py), planar and row-major,
    one launch each, bit-identical on a second call."""
    _, port, raw, code, enc, z = _setup(B, 512, 512, 5)
    port = port.to(cuda_device)
    tw = port.tower(cuda_device)
    z = torch.from_numpy(z).to(cuda_device).bfloat16()
    x = (rf.RawCode(*(torch.from_numpy(a).to(cuda_device) for a in (raw,) + code)) if raw_code
         else torch.from_numpy(enc).to(cuda_device))
    name = "resnetfc_fwd_dense" + ("_code" if raw_code else "")
    for planar in (True, False):
        before = rf.LAUNCHES[name]
        out = rf.resnetfc_dense(z, x, tw, 5, planar)
        torch.cuda.synchronize()
        assert rf.LAUNCHES[name] == before + 1
        ref = rf.resnetfc_reference(z, x, tw, 5, planar, compute_dtype=torch.bfloat16)
        assert (out - ref).abs().max().item() <= 0.015 * max(1.0, ref.abs().max().item())
        assert torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1] > 0.999
        assert torch.equal(out, rf.resnetfc_dense(z, x, tw, 5, planar))
