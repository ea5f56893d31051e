"""The port's multi-view fused-gather forward (row 4 of PERF.md:
``_kernel_2d_mv_gather``): ``ops/resnetfc_fused.py::resnetfc_gather_mv``, its
plain version (``gather_reference`` on the ``(NS, T, C)`` tables, then
``resnetfc_reference`` at NS views) and the checks of
``resnetfc_fwd_gather_mv`` (``check_gather_mv``), at sn64's d_hidden 512 and
at the narrow widths 64, 128 and 256 (one library a width).

``resnetfc_fwd_gather_mv`` walks 64-point tiles of one object's output
points on persistent CTAs, view v's lookup reading idx / w rows ``v B + g``
and table v.  Every B here leaves its last tile ragged (2000 = 31 x 64 + 16,
and 160 = 2 x 64 + 32), and idx holds taps at -1 and at T, which contribute
nothing.  On the CPU the wrapper's plain version, in f32, is held against the
JAX package's ``_kernel_2d_mv_gather`` through ``resnetfc_pallas`` in
interpret mode, as ``tests/test_torch_multiview.py`` runs it, with the
encoded code and with a ``RawCode``, planar and row-major, to 1e-4 of
max(1, max|ref|) (f32 sums reassociated).  A numpy emulation of the kernel's
per-view lookup (view v's tap row ``v T + idx`` of the stacked tables, from
+0, each tap's f32 product rounded, then added, in tap order, then rounded to
bf16) must give ``gather_reference``'s bf16 latent bit for bit: that is what
lets the card hold the kernel bit for bit against ``resnetfc_dense_mv`` on
that latent.  On the card (``cuda``-marked, skipped here) the kernel is held
against its plain version in bf16 at the bar of ``tests/test_pallas.py`` and
against ``resnetfc_dense_mv`` on the gathered latent, bit for bit.
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

# what the tile kernels fix, by hand (the library reports it on the card), as
# in tests/test_torch_fwd_dense.py
LIMITS = rf.DenseLimits(tile=64, threads=256, stages=3, max_out=4, max_steps=128, max_k=512,
                        slot_floats=128 * 256, smem=2 * 65536 + 3 * 32768 + 1024, plan_bytes=448)
PE = dict(num_freqs=6, d_in=3, freq_factor=1.5, include_input=True)  # sn64's code
TAPS = 8  # sn64 pads the 4 bilinear taps to 8 (ops/grid_sample.py::bilinear_taps)
# the narrow towers' shapes, as in tests/test_torch_fwd_dense.py
NARROW = {"small": dict(d_in=10, C=64, nb=3, cl=2), "sn64": dict(d_in=None, C=512, nb=5, cl=3)}


def _taps(rng, rows, T):
    """(rows, TAPS) int32 rows and f32 weights: 4 live taps (some at -1 or
    T, outside the view's table) and zero-weight padding."""
    idx = rng.integers(0, T, size=(rows, TAPS)).astype(np.int32)
    w = rng.uniform(0, 1, size=(rows, TAPS)).astype(np.float32)
    w[:, 4:] = 0.0
    out = rng.random(size=(rows, 4)) < 0.1
    idx[:, :4][out] = rng.choice(np.array([-1, T], np.int32), size=int(out.sum()))
    return idx, w


def _setup(NS, B, C, H, nb, cl, T, seed=0, d_in=None):
    """JAX ResnetFC parameters drawn from numpy (every parameter live), the
    port module holding the same weights, NS views of B points: the sn64
    code's raw coordinates and flat arrays, the encoded code (or, given
    ``d_in``, a normal (NS B, d_in) code in its place), (NS, T, C) tables and
    view-major taps."""
    W, f, p, m = JPositionalEncoding(**PE).flat_arrays(tail=3)
    d_code = W.shape[1]
    d_in = d_code if d_in is None else d_in
    jm = JResnetFC(d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=cl)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, C + d_in)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * (0.05 if a.ndim == 1 else 1.0 / np.sqrt(a.shape[0])))
        .astype(np.float32), params)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=cl,
                    impl="cuda")
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    rows = NS * B
    xyz = rng.uniform(-1.4, 1.4, size=(rows, 3))
    vd = rng.normal(size=(rows, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    raw = np.concatenate([xyz, vd], axis=-1).astype(np.float32)
    enc = (raw.astype(np.float64) @ W).astype(np.float32)
    enc = np.where(m > 0, np.sin(enc * f + p), enc).astype(np.float32)
    if d_in != d_code:
        enc = rng.normal(size=(rows, d_in)).astype(np.float32)
    tables = rng.normal(size=(NS, T, C)).astype(np.float32)
    idx, w = _taps(rng, rows, T)
    return params, port, raw, (W, f, p, m), enc, tables, idx, w


@pytest.mark.parametrize("NS,B,raw_code,planar", [
    (2, 2000, False, True),
    (2, 160, True, False),
    (3, 2000, True, True),
    (3, 160, False, False),
    (2, 2000, True, False),
    (3, 160, True, True),
    (2, 160, False, True),
    (3, 2000, False, False),
])
def test_gather_mv_plain_matches_pallas_interpret(NS, B, raw_code, planar):
    """resnetfc_gather_mv on CPU tensors (its plain version) against
    resnetfc_pallas (_kernel_2d_mv_gather) in interpret mode, at a ragged
    last tile, with taps outside each view's table."""
    C, H, nb, cl, T = 32, 64, 3, 2, 64
    params, port, raw, code, enc, tables, idx, w = _setup(NS, B, C, H, nb, cl, T,
                                                          seed=NS * B + raw_code)
    assert ((idx[:, :4] < 0) | (idx[:, :4] >= T)).any()
    if raw_code:
        jx = rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code))
        x = rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code))
    else:
        jx, x = jnp.asarray(enc), torch.from_numpy(enc)
    jz = rp.LatentGather(jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(w))
    ref = rp.resnetfc_pallas(params, (jz, jx), NS=NS, d_latent=C, d_in=enc.shape[1], n_blocks=nb,
                             combine_layer=cl, block_points=512, interpret=True,
                             planar_out=planar)
    ref = np.asarray(ref)[0]
    rf.reset_launches()
    out = rf.resnetfc_gather_mv(torch.from_numpy(idx), torch.from_numpy(w),
                                torch.from_numpy(tables), x, port.tower(torch.device("cpu")), nb,
                                cl, planar)
    assert not any(rf.LAUNCHES.values())  # CPU tensors: the plain version, no launch
    assert tuple(out.shape) == ref.shape == ((4, B) if planar else (B, 4))
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


# the narrower widths these checks were written for; tests/test_torch_hidden_widths.py
# holds the plain versions at 192 and at a padded width against the JAX kernels
@pytest.mark.parametrize("H", [64, 128, 256, 384])
@pytest.mark.parametrize("shape,NS,B,raw_code,planar", [
    ("small", 2, 150, False, True),
    ("sn64", 2, 160, True, False),
    ("sn64", 3, 160, False, True),
    ("sn64", 3, 160, True, False),
])
def test_gather_mv_plain_at_narrow_widths_matches_pallas_interpret(H, shape, NS, B, raw_code,
                                                                   planar):
    """The narrow towers the kernels take (d_hidden 64, 128 and 256): the plain
    version against ``_kernel_2d_mv_gather`` in interpret mode at
    tests/test_pallas.py's small shape and at sn64's other widths (512-wide
    tables), NS 2 and 3, a ragged last tile, taps outside each view's table."""
    d_in, C, nb, cl = NARROW[shape].values()
    T = 64
    params, port, raw, code, enc, tables, idx, w = _setup(NS, B, C, H, nb, cl, T,
                                                          seed=H + NS * B + raw_code, d_in=d_in)
    assert ((idx[:, :4] < 0) | (idx[:, :4] >= T)).any()
    if raw_code:
        jx = rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code))
        x = rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code))
    else:
        jx, x = jnp.asarray(enc), torch.from_numpy(enc)
    jz = rp.LatentGather(jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(w))
    ref = rp.resnetfc_pallas(params, (jz, jx), NS=NS, d_latent=C, d_in=enc.shape[1], n_blocks=nb,
                             combine_layer=cl, block_points=512, interpret=True,
                             planar_out=planar)
    ref = np.asarray(ref)[0]
    tw = port.tower(torch.device("cpu"))
    assert tw.w_in.shape[1] == H
    rf.reset_launches()
    out = rf.resnetfc_gather_mv(torch.from_numpy(idx), torch.from_numpy(w),
                                torch.from_numpy(tables), x, tw, nb, cl, planar)
    assert not any(rf.LAUNCHES.values())
    assert tuple(out.shape) == ref.shape == ((4, B) if planar else (B, 4))
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 -> the bf16 bit pattern, rounded to nearest even (finite values)."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _kernel_lookup_mv(idx, w, tables_bf16):
    """The multi-view gather kernel's lookup in numpy: point g of view v reads
    idx / w row v B + g; a tap inside [0, T) reads row v T + idx of the
    (NS T, C) stack of tables, one outside reads a zero row; per point, from
    +0, tap j's f32 product w_j t_j rounded, then added, j = 0..3; the sum
    rounded to bf16."""
    NS, T, C = tables_bf16.shape
    stack = tables_bf16.reshape(NS * T, C)
    view = np.repeat(np.arange(NS), idx.shape[0] // NS)
    acc = np.zeros((idx.shape[0], C), np.float32)
    for j in range(4):
        ij = idx[:, j]
        valid = (ij >= 0) & (ij < T)
        row = np.where(valid, ij + view * T, 0)
        t = np.where(valid[:, None], stack[row], np.float32(0))
        prod = (w[:, j : j + 1] * t).astype(np.float32)  # rounded on its own: no FMA in numpy
        acc = (acc + prod).astype(np.float32)
    return _bf16_bits(acc)


@pytest.mark.parametrize("NS,seed", [(2, 0), (3, 1), (5, 2)])
def test_kernel_tap_order_gives_gather_reference_bits_per_view(NS, seed):
    """The kernel's per-view lookup, emulated in numpy, gives
    gather_reference(..., bfloat16) on the (NS, T, C) tables bit for bit: a
    tap at T reads nothing (not the next view's row 0), zero and negative
    products and cancellations to zero included."""
    rng = np.random.default_rng(seed)
    B, T, C = 1000, 96, 40
    tables = torch.from_numpy(rng.normal(size=(NS, T, C)).astype(np.float32)).bfloat16()
    tables[:, :8] = 0.0
    tables[:, 8:16] = -tables[:, 16:24]
    idx, w = _taps(rng, NS * B, T)
    w[::7, 1] = 0.0
    w[::5, 2] = -w[::5, 2]
    idx[::11, 1] = idx[::11, 0]  # equal rows, weights of opposite sign below
    w[::11, 1] = -w[::11, 0]
    idx[::13, 3] = T  # one past a view's table: the next view's first row
    ref = rf.gather_reference(torch.from_numpy(idx), torch.from_numpy(w), tables, torch.bfloat16)
    ref_bits = ref.bfloat16().view(torch.int16).numpy().view(np.uint16)
    mine = _kernel_lookup_mv(idx, w, tables.float().numpy())
    np.testing.assert_array_equal(mine, ref_bits)


def _tower(kin=48, H=512, C=512, n_lin_z=3, nb=5, d_out=4):
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    f = lambda *s: torch.zeros(*s)  # noqa: E731
    return rf.Tower(w_in=z(kin, H), b_in=f(H), w_z=z(n_lin_z, C, H), b_z=f(n_lin_z, H),
                    w_blk=z(nb, 2, H, H), b_blk=f(nb, 2, H), w_out=z(H, d_out), b_out=f(d_out),
                    d_in=42, d_hidden=H)


def _operands(NS=2, B=100, T=1024, C=512):
    idx = torch.zeros(NS * B, TAPS, dtype=torch.int32)
    return idx, torch.zeros(NS * B, TAPS), torch.zeros(NS, T, C, dtype=torch.bfloat16)


@pytest.mark.parametrize("NS", [2, 3, 12, 255])
def test_check_gather_mv_takes_sn64(NS):
    """sn64 (5 blocks, 3 injections, the mean at block 3) from 2 to 255
    views, with 8 taps and with 4."""
    idx, w, tables = _operands(NS, 4)
    rf.check_gather_mv(idx, w, tables, NS * 4, 3, _tower(), 5, LIMITS)
    rf.check_gather_mv(idx[:, :4].contiguous(), w[:, :4].contiguous(), tables, NS * 4, 3, _tower(),
                       5, LIMITS)


def test_check_gather_mv_refuses_views_it_cannot_take():
    idx, w, tables = _operands(256, 2)
    with pytest.raises(ValueError, match="at most 255 views"):
        rf.check_gather_mv(idx, w, tables, 512, 3, _tower(), 5, LIMITS)
    idx, w, tables = _operands(1)
    with pytest.raises(ValueError, match="views"):
        rf.check_gather_mv(idx, w, tables, 100, 3, _tower(), 5, LIMITS)


def test_check_gather_mv_refuses_fewer_than_4_taps():
    idx, w, tables = _operands()
    with pytest.raises(ValueError, match="at least 4 taps"):
        rf.check_gather_mv(idx[:, :3].contiguous(), w[:, :3].contiguous(), tables, 200, 3,
                           _tower(), 5, LIMITS)


def test_check_gather_mv_refuses_misaligned_tables():
    idx, w, _ = _operands()
    flat = torch.zeros(2 * 1024 * 512 + 8, dtype=torch.bfloat16)
    tables = flat[1 : 1 + 2 * 1024 * 512].view(2, 1024, 512)  # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        rf.check_gather_mv(idx, w, tables, 200, 3, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match="contiguous"):
        rf.check_gather_mv(idx, w, torch.zeros(2, 512, 1024, dtype=torch.bfloat16).transpose(1, 2),
                           200, 3, _tower(), 5, LIMITS)


def test_check_gather_mv_refuses_rows_and_tables_of_other_shapes():
    idx, w, tables = _operands()
    with pytest.raises(ValueError, match="idx must have shape"):
        rf.check_gather_mv(idx, w, tables, 198, 3, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match="w must have shape"):
        rf.check_gather_mv(idx, w[:, :6].contiguous(), tables, 200, 3, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match="objects x NS=2 views"):
        rf.check_gather_mv(idx[:199].contiguous(), w[:199].contiguous(), tables, 199, 3, _tower(),
                           5, LIMITS)
    with pytest.raises(ValueError, match=r"\(NS, T, C=512\) tables"):
        rf.check_gather_mv(idx, w, tables[:, :, :256].contiguous(), 200, 3, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match=r"\(NS, T, C=512\) tables"):
        rf.check_gather_mv(idx, w, tables[0], 200, 3, _tower(), 5, LIMITS)


@pytest.mark.parametrize("tower,cl,what", [
    (dict(H=256), 3, "d_hidden"),
    (dict(C=40), 3, "C"),
    (dict(kin=40), 3, "kin"),
    (dict(d_out=5), 3, "outputs"),
    (dict(nb=63), 3, "steps"),
    (dict(n_lin_z=3), 2, "below the view mean"),
    (dict(), 5, "combine_layer"),
])
def test_check_gather_mv_refuses_widths_the_tile_does_not_take(tower, cl, what):
    tw = _tower(**tower)
    idx, w, tables = _operands(C=tw.w_z.shape[1])
    with pytest.raises(ValueError, match=what):
        rf.check_gather_mv(idx, w, tables, 200, cl, tw, tw.w_blk.shape[0], LIMITS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("raw_code", [False, True])
@pytest.mark.parametrize("NS,B", [(2, 2000), (3, 160)])
def test_gather_mv_kernel_matches_plain_and_dense_mv_on_card(cuda_device, NS, B, raw_code):
    """sn64 widths at a ragged last tile, taps outside the tables: the kernel
    against its plain version in bf16 (the bar of tests/test_pallas.py),
    planar and row-major, one launch each, bit-identical on a second call and
    to resnetfc_dense_mv on gather_reference's bf16 per-view latent."""
    nb, cl = 5, 3
    _, port, raw, code, enc, tables, idx, w = _setup(NS, B, 512, 512, nb, cl, 1024)
    port = port.to(cuda_device)
    tw = port.tower(cuda_device)
    tables = torch.from_numpy(tables).to(cuda_device).bfloat16()
    idx, w = (torch.from_numpy(a).to(cuda_device) for a in (idx, w))
    x = (rf.RawCode(*(torch.from_numpy(a).to(cuda_device) for a in (raw,) + code)) if raw_code
         else torch.from_numpy(enc).to(cuda_device))
    z = rf.gather_reference(idx, w, tables, torch.bfloat16)
    name = "resnetfc_fwd_gather_mv" + ("_code" if raw_code else "")
    for planar in (True, False):
        before = rf.LAUNCHES[name]
        out = rf.resnetfc_gather_mv(idx, w, tables, x, tw, nb, cl, planar)
        torch.cuda.synchronize()
        assert rf.LAUNCHES[name] == before + 1
        ref = rf.resnetfc_reference(z, x, tw, nb, planar, compute_dtype=torch.bfloat16, NS=NS,
                                    combine_layer=cl)
        assert (out - ref).abs().max().item() <= 0.015 * max(1.0, ref.abs().max().item())
        assert torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1] > 0.999
        assert torch.equal(out, rf.resnetfc_gather_mv(idx, w, tables, x, tw, nb, cl, planar))
        assert torch.equal(out, rf.resnetfc_dense_mv(z.bfloat16(), x, tw, nb, NS, cl, 1, planar))
