"""The port's one-view fused-gather forward (row 1 of PERF.md:
``_kernel_2d_gather``): ``ops/resnetfc_fused.py::resnetfc_gather``, its plain
version (``gather_reference`` then ``resnetfc_reference``) and the checks of
``resnetfc_fwd_gather`` (``check_gather``), at sn64's d_hidden 512 and at
the narrow widths 64, 128 and 256 (one library a width).

``resnetfc_fwd_gather`` walks the dense kernel's 64-point tiles; every B here
leaves its last tile ragged (2000 = 31 x 64 + 16, and 160 = 2 x 64 + 32),
and idx holds taps at -1 and at T, which contribute nothing.  On the CPU the
wrapper's plain version, in f32, is held against the JAX package's
``_kernel_2d_gather`` through ``resnetfc_pallas`` in interpret mode, with the
encoded code and with a ``RawCode``, planar and row-major, to 1e-4 of
max(1, max|ref|), the bar of ``tests/test_torch_fwd_dense.py`` (f32 sums
reassociated).  A numpy emulation of the kernel's lookup (from +0, each tap's
f32 product rounded, then added, in tap order, then rounded to bf16) must
give ``gather_reference``'s bf16 latent bit for bit: that is what lets the
card hold the gather kernel bit for bit against the dense one.  On the card
(``cuda``-marked, skipped here) the kernel is held against its plain version
in bf16 at the bar of ``tests/test_pallas.py`` and against
``resnetfc_dense`` on the gathered latent, bit for bit.
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

# what the one-view tile kernels fix, by hand (the library reports it on the
# card), as in tests/test_torch_fwd_dense.py
LIMITS = rf.DenseLimits(tile=64, threads=256, stages=3, max_out=4, max_steps=128, max_k=512,
                        slot_floats=128 * 256, smem=2 * 65536 + 3 * 32768 + 1024, plan_bytes=448)
PE = dict(num_freqs=6, d_in=3, freq_factor=1.5, include_input=True)  # sn64's code
TAPS = 8  # sn64 pads the 4 bilinear taps to 8 (ops/grid_sample.py::bilinear_taps)
# the narrow towers' shapes, as in tests/test_torch_fwd_dense.py
NARROW = {"small": dict(d_in=10, C=64, nb=3, cl=2), "sn64": dict(d_in=None, C=512, nb=5, cl=3)}


def _taps(rng, B, T):
    """(B, TAPS) int32 rows and f32 weights: 4 live taps (some at -1 or T,
    outside the table) and zero-weight padding, as bilinear_taps pads."""
    idx = rng.integers(0, T, size=(B, TAPS)).astype(np.int32)
    w = rng.uniform(0, 1, size=(B, TAPS)).astype(np.float32)
    w[:, 4:] = 0.0
    out = rng.random(size=(B, 4)) < 0.1
    idx[:, :4][out] = rng.choice(np.array([-1, T], np.int32), size=int(out.sum()))
    return idx, w


def _setup(B, C, H, nb, combine_layer, T, seed=0, d_in=None):
    """JAX ResnetFC parameters drawn from numpy (every parameter live), the
    port module holding the same weights, the sn64 code's raw coordinates and
    flat arrays, the encoded code (or, given ``d_in``, a normal (B, d_in)
    code in its place), a (T, C) table and its taps."""
    W, f, p, m = JPositionalEncoding(**PE).flat_arrays(tail=3)
    d_code = W.shape[1]
    d_in = d_code if d_in is None else d_in
    jm = JResnetFC(d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=combine_layer)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, C + d_in)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * (0.05 if a.ndim == 1 else 1.0 / np.sqrt(a.shape[0])))
        .astype(np.float32), params)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=C, d_hidden=H,
                    combine_layer=combine_layer, impl="cuda")
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
    table = rng.normal(size=(T, C)).astype(np.float32)
    idx, w = _taps(rng, B, T)
    return params, port, raw, (W, f, p, m), enc, table, idx, w


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("raw_code", [False, True])
@pytest.mark.parametrize("B", [2000, 160])
def test_gather_plain_matches_pallas_interpret(B, raw_code, planar):
    """resnetfc_gather on CPU tensors (its plain version) against
    resnetfc_pallas (_kernel_2d_gather) in interpret mode, at a ragged last
    tile, with taps outside the table."""
    C, H, nb, cl, T = 32, 64, 3, 2, 64
    params, port, raw, code, enc, table, idx, w = _setup(B, C, H, nb, cl, T, seed=B + raw_code)
    assert ((idx[:, :4] < 0) | (idx[:, :4] >= T)).any()
    if raw_code:
        jx = rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code))
        x = rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code))
    else:
        jx, x = jnp.asarray(enc), torch.from_numpy(enc)
    jz = rp.LatentGather(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w))
    ref = rp.resnetfc_pallas(params, (jz, jx), NS=1, d_latent=C, d_in=enc.shape[1], n_blocks=nb,
                             combine_layer=cl, block_points=512, interpret=True,
                             planar_out=planar)
    ref = np.asarray(ref)[0]
    rf.reset_launches()
    out = rf.resnetfc_gather(torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(table),
                             x, port.tower(torch.device("cpu")), nb, planar)
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
def test_gather_plain_at_narrow_widths_matches_pallas_interpret(H, shape, B, raw_code, planar):
    """The narrow towers the kernels take (d_hidden 64, 128 and 256): the plain
    version against ``_kernel_2d_gather`` in interpret mode at
    tests/test_pallas.py's small shape and at sn64's other widths (a 512-wide
    table: one operand tile at every width), the last tile ragged, taps
    outside the table."""
    d_in, C, nb, cl = NARROW[shape].values()
    T = 64
    params, port, raw, code, enc, table, idx, w = _setup(B, C, H, nb, cl, T,
                                                         seed=H + B + raw_code, d_in=d_in)
    assert ((idx[:, :4] < 0) | (idx[:, :4] >= T)).any()
    if raw_code:
        jx = rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code))
        x = rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code))
    else:
        jx, x = jnp.asarray(enc), torch.from_numpy(enc)
    jz = rp.LatentGather(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w))
    ref = rp.resnetfc_pallas(params, (jz, jx), NS=1, d_latent=C, d_in=enc.shape[1], n_blocks=nb,
                             combine_layer=cl, block_points=512, interpret=True,
                             planar_out=planar)
    ref = np.asarray(ref)[0]
    tw = port.tower(torch.device("cpu"))
    assert tw.w_in.shape[1] == H
    rf.reset_launches()
    out = rf.resnetfc_gather(torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(table),
                             x, tw, nb, planar)
    assert not any(rf.LAUNCHES.values())
    assert tuple(out.shape) == ref.shape == ((4, B) if planar else (B, 4))
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 -> the bf16 bit pattern, rounded to nearest even (finite values)."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _kernel_lookup(idx, w, table_bf16):
    """The gather kernel's lookup in numpy: per point, from +0, tap j's f32
    product w_j t_j rounded, then added, j = 0..3; a tap outside [0, T)
    reads a zero row; the sum rounded to bf16."""
    T, C = table_bf16.shape
    acc = np.zeros((idx.shape[0], C), np.float32)
    for j in range(4):
        ij = idx[:, j]
        valid = (ij >= 0) & (ij < T)
        t = np.where(valid[:, None], table_bf16[np.clip(ij, 0, T - 1)], np.float32(0))
        prod = (w[:, j : j + 1] * t).astype(np.float32)  # rounded on its own: no FMA in numpy
        acc = (acc + prod).astype(np.float32)
    return _bf16_bits(acc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_tap_order_gives_gather_reference_bits(seed):
    """The kernel's tap order and rounding, emulated in numpy, give
    gather_reference(..., bfloat16) bit for bit: taps outside the table,
    zero and negative products, cancellations to zero included."""
    rng = np.random.default_rng(seed)
    B, T, C = 3000, 96, 40
    table = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).bfloat16()
    table[:8] = 0.0
    table[8:16] = -table[16:24]
    idx, w = _taps(rng, B, T)
    w[::7, 1] = 0.0
    w[::5, 2] = -w[::5, 2]
    idx[::11, 1] = idx[::11, 0]  # equal rows, weights of opposite sign below
    w[::11, 1] = -w[::11, 0]
    ref = rf.gather_reference(torch.from_numpy(idx), torch.from_numpy(w), table, torch.bfloat16)
    ref_bits = ref.bfloat16().view(torch.int16).numpy().view(np.uint16)
    mine = _kernel_lookup(idx, w, table.float().numpy())
    np.testing.assert_array_equal(mine, ref_bits)


def _tower(kin=48, H=512, C=512, n_lin_z=3, nb=5, d_out=4, dtype=torch.bfloat16):
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    f = lambda *s: torch.zeros(*s)  # noqa: E731
    return rf.Tower(w_in=z(kin, H), b_in=f(H), w_z=z(n_lin_z, C, H), b_z=f(n_lin_z, H),
                    w_blk=z(nb, 2, H, H), b_blk=f(nb, 2, H), w_out=z(H, d_out), b_out=f(d_out),
                    d_in=42, d_hidden=H)


def _operands(B=100, T=1024, C=512):
    idx = torch.zeros(B, TAPS, dtype=torch.int32)
    return idx, torch.zeros(B, TAPS), torch.zeros(T, C, dtype=torch.bfloat16)


def test_check_gather_takes_sn64():
    idx, w, table = _operands()
    rf.check_gather(idx, w, table, 100, _tower(), 5, LIMITS)
    rf.check_gather(idx[:, :4].contiguous(), w[:, :4].contiguous(), table, 100, _tower(), 5,
                    LIMITS)


def test_check_gather_refuses_fewer_than_4_taps():
    idx, w, table = _operands()
    with pytest.raises(ValueError, match="at least 4 taps"):
        rf.check_gather(idx[:, :3].contiguous(), w[:, :3].contiguous(), table, 100, _tower(), 5,
                        LIMITS)


def test_check_gather_refuses_a_misaligned_table():
    idx, w, _ = _operands()
    flat = torch.zeros(1024 * 512 + 8, dtype=torch.bfloat16)
    table = flat[1 : 1 + 1024 * 512].view(1024, 512)  # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        rf.check_gather(idx, w, table, 100, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match="contiguous"):
        rf.check_gather(idx, w, torch.zeros(512, 1024, dtype=torch.bfloat16).t(), 100, _tower(),
                        5, LIMITS)


@pytest.mark.parametrize("tower,what", [
    (dict(H=256), "d_hidden"),
    (dict(C=40), "C"),
    (dict(kin=40), "kin"),
    (dict(d_out=5), "outputs"),
    (dict(nb=63), "steps"),
])
def test_check_gather_refuses_widths_the_tile_does_not_take(tower, what):
    tw = _tower(**tower)
    idx, w, table = _operands(C=tw.w_z.shape[1])
    with pytest.raises(ValueError, match=what):
        rf.check_gather(idx, w, table, 100, tw, tw.w_blk.shape[0], LIMITS)


def test_check_gather_refuses_rows_and_tables_of_other_shapes():
    idx, w, table = _operands()
    with pytest.raises(ValueError, match="idx must have shape"):
        rf.check_gather(idx, w, table, 99, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match="w must have shape"):
        rf.check_gather(idx, w[:, :6].contiguous(), table, 100, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match=r"\(T, C=512\) table"):
        rf.check_gather(idx, w, table[:, :256].contiguous(), 100, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match=r"\(T, C=512\) table"):
        rf.check_gather(idx, w, table[None], 100, _tower(), 5, LIMITS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("raw_code", [False, True])
@pytest.mark.parametrize("B", [2000, 160])
def test_gather_kernel_matches_plain_and_dense_on_card(cuda_device, B, raw_code):
    """sn64 widths at a ragged last tile, taps outside the table: the kernel
    against its plain version in bf16 (the bar of tests/test_pallas.py),
    planar and row-major, one launch each, bit-identical on a second call and
    to resnetfc_dense on gather_reference's bf16 latent."""
    _, port, raw, code, enc, table, idx, w = _setup(B, 512, 512, 5, 3, 1024)
    port = port.to(cuda_device)
    tw = port.tower(cuda_device)
    table = torch.from_numpy(table).to(cuda_device).bfloat16()
    idx, w = (torch.from_numpy(a).to(cuda_device) for a in (idx, w))
    x = (rf.RawCode(*(torch.from_numpy(a).to(cuda_device) for a in (raw,) + code)) if raw_code
         else torch.from_numpy(enc).to(cuda_device))
    z = rf.gather_reference(idx, w, table, torch.bfloat16)
    name = "resnetfc_fwd_gather" + ("_code" if raw_code else "")
    for planar in (True, False):
        before = rf.LAUNCHES[name]
        out = rf.resnetfc_gather(idx, w, table, x, tw, 5, planar)
        torch.cuda.synchronize()
        assert rf.LAUNCHES[name] == before + 1
        ref = rf.resnetfc_reference(z, x, tw, 5, planar, compute_dtype=torch.bfloat16)
        assert (out - ref).abs().max().item() <= 0.015 * max(1.0, ref.abs().max().item())
        assert torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1] > 0.999
        assert torch.equal(out, rf.resnetfc_gather(idx, w, table, x, tw, 5, planar))
        assert torch.equal(out, rf.resnetfc_dense(z.bfloat16(), x, tw, 5, planar))
