"""The fused gathers past a 512-wide table, ResNet50's latent on the forward
rows and the repair of the fused-gather route, on the CPU.

* ``resnetfc_gather`` / ``resnetfc_gather_mv`` (rows 1 and 4 of PERF.md,
  and row 6's deferred code) take a (T, C) table up to C = 4096, building
  the latent a piece of 512 columns at a time: ResNet50's unified map is C
  = 832 / 1856 / 3904 at 3 / 4 / 5 layers.  Their plain versions
  (``gather_reference`` then ``resnetfc_reference``) are held against the
  JAX ``_kernel_2d_gather`` / ``_kernel_2d_mv_gather`` through
  ``resnetfc_pallas`` in interpret mode, with a ``LatentGather`` on both
  sides, at d_hidden 64, 2 blocks and a ragged last tile, to 1e-4 of
  max(1, max|ref|) (f32 sums reassociated), as
  ``tests/test_torch_wide_latent.py`` holds the dense rows at C = 640; so
  are the dense rows 2 and 3 at 1856.  A numpy emulation of the kernel's
  lookup piece by piece (each piece's sums from +0 in tap order) gives
  ``gather_reference``'s bf16 latent bit for bit at those widths.
* The repair: at C = 832 (ResNet50, 3 layers) and C = 1024 (ResNet34, 5
  layers) the route rule took the kernels and ``_fused_gather_ok`` the fused
  gather at one view, and the gather wrapper then raised on the card
  (``the gather kernels take a latent of at most 512 columns``).  Decided
  from the Python mirrors, with no library loaded: whenever both take the
  fused gather, the gathers' mirrored limits take the width, and so do the
  wrappers' checks.

The kernels themselves run on the card only: ``chip_smoke.py`` (phase 21)
holds them against these plain versions there.
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
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

PE = dict(num_freqs=6, d_in=3, freq_factor=1.5, include_input=True)  # sn64's code
TAPS = 8  # sn64 pads the 4 bilinear taps to 8 (ops/grid_sample.py::bilinear_taps)
T = 64  # table rows (an 8 x 8 map)
H, NB, CL = 64, 2, 1  # a small tower: the latent in block 0, the views' mean at block 1
B = 200  # points a view: the last 64-point tile ragged
CUDA = torch.device("cuda")  # only compared by type: nothing is allocated on it


def _taps(rng, rows):
    """(rows, TAPS) int32 rows and f32 weights: 4 live taps (some at -1 or T,
    outside the table) and zero-weight padding, as bilinear_taps pads."""
    idx = rng.integers(0, T, size=(rows, TAPS)).astype(np.int32)
    w = rng.uniform(0, 1, size=(rows, TAPS)).astype(np.float32)
    w[:, 4:] = 0.0
    out = rng.random(size=(rows, 4)) < 0.1
    idx[:, :4][out] = rng.choice(np.array([-1, T], np.int32), size=int(out.sum()))
    return idx, w


def _setup(NS, C, seed, sb=1):
    """JAX ResnetFC parameters drawn from numpy (every parameter live), the
    port module holding them, NS views of SB x B points: the sn64 code's raw
    coordinates and flat arrays, the encoded code, (NS, T, C) tables with
    view-major taps, and a dense (rows, C) latent."""
    W, f, p, m = JPositionalEncoding(**PE).flat_arrays(tail=3)
    d_in = W.shape[1]
    jm = JResnetFC(d_out=4, n_blocks=NB, d_latent=C, d_hidden=H, combine_layer=CL)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, C + d_in)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * (0.05 if a.ndim == 1 else 1.0 / np.sqrt(a.shape[0])))
        .astype(np.float32), params)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=NB, d_latent=C, d_hidden=H, combine_layer=CL,
                    impl="cuda")
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    rows = sb * NS * B
    xyz = rng.uniform(-1.4, 1.4, size=(rows, 3))
    vd = rng.normal(size=(rows, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    raw = np.concatenate([xyz, vd], axis=-1).astype(np.float32)
    enc = (raw.astype(np.float64) @ W).astype(np.float32)
    enc = np.where(m > 0, np.sin(enc * f + p), enc).astype(np.float32)
    tables = rng.normal(size=(NS, T, C)).astype(np.float32)
    idx, w = _taps(rng, rows)
    z = rng.normal(size=(rows, C)).astype(np.float32)
    return params, port, raw, (W, f, p, m), enc, tables, idx, w, z


def _x(raw_code, raw, code, enc):
    if raw_code:
        return (rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code)),
                rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code)))
    return jnp.asarray(enc), torch.from_numpy(enc)


def _close(out, ref):
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("C,NS,raw_code", [
    (832, 1, False),  # ResNet50 at 3 layers: 2 pieces (512 + 320)
    (832, 2, True),
    (1856, 1, True),  # at 4 layers, sn64's: 4 pieces, the last 320
    (1856, 2, False),
    (3904, 1, False),  # at 5 layers: 8 pieces, the last 320
    (3904, 2, True),
])
def test_gathers_plain_at_resnet50_widths_match_pallas_interpret(C, NS, raw_code):
    """resnetfc_gather (NS 1) and resnetfc_gather_mv (NS 2) on CPU tensors
    against ``_kernel_2d_gather`` / ``_kernel_2d_mv_gather`` in interpret
    mode with a LatentGather, taps outside each table, encoded and deferred
    code; the wrappers' checks, which the card runs before a launch, take
    the same operands at the width's library."""
    params, port, raw, code, enc, tables, idx, w, _ = _setup(NS, C, seed=C + NS)
    assert ((idx[:, :4] < 0) | (idx[:, :4] >= T)).any()
    jx, x = _x(raw_code, raw, code, enc)
    jtab = tables[0] if NS == 1 else tables
    jz = rp.LatentGather(jnp.asarray(jtab), jnp.asarray(idx), jnp.asarray(w))
    ref = rp.resnetfc_pallas(params, (jz, jx), NS=NS, d_latent=C, d_in=enc.shape[1], n_blocks=NB,
                             combine_layer=CL, block_points=512, interpret=True,
                             planar_out=NS == 1)
    ref = np.asarray(ref)[0]
    tw = port.tower(torch.device("cpu"))
    I, Wt, tab = torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(jtab)
    rf.reset_launches()
    if NS == 1:
        out = rf.resnetfc_gather(I, Wt, tab, x, tw, NB, True)
        rf.check_gather(I, Wt, tab, B, tw, NB, rf.tile_limits(H))
    else:
        out = rf.resnetfc_gather_mv(I, Wt, tab, x, tw, NB, CL, False)
        rf.check_gather_mv(I, Wt, tab, NS * B, CL, tw, NB, rf.tile_limits(H))
    assert not any(rf.LAUNCHES.values())  # CPU tensors: the plain version, no launch
    assert tuple(out.shape) == ref.shape == ((4, B) if NS == 1 else (B, 4))
    _close(out, ref)


@pytest.mark.parametrize("NS,sb,raw_code", [(1, 1, False), (1, 1, True), (3, 2, True),
                                            (3, 1, False)])
def test_dense_rows_plain_at_1856_match_pallas_interpret(NS, sb, raw_code):
    """resnetfc_dense (row 2) and resnetfc_dense_mv (row 3; SB 2 puts tiles
    across two objects), with the deferred code (row 6), at ResNet50's C =
    1856 against ``_kernel_2d`` / ``_kernel_2d_mv`` in interpret mode."""
    C = 1856
    params, port, raw, code, enc, _, _, _, z = _setup(NS, C, seed=7 + NS + sb, sb=sb)
    jx, x = _x(raw_code, raw, code, enc)
    ref = rp.resnetfc_pallas(params, (jnp.asarray(z), jx), NS=NS, d_latent=C, d_in=enc.shape[1],
                             n_blocks=NB, combine_layer=CL, sb=sb, block_points=128,
                             interpret=True, planar_out=True)
    ref = np.asarray(ref)[0]
    tw = port.tower(torch.device("cpu"))
    Z = torch.from_numpy(z)
    out = (rf.resnetfc_dense(Z, x, tw, NB) if NS == 1
           else rf.resnetfc_dense_mv(Z, x, tw, NB, NS, CL, sb))
    assert tuple(out.shape) == ref.shape == (4, sb * B)
    _close(out, ref)


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 -> the bf16 bit pattern, rounded to nearest even (finite values)."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _kernel_lookup_in_pieces(idx, w, table_bf16):
    """The gather kernel's lookup in numpy, a piece of 512 columns at a time
    as the tile builds it: per point and piece, from +0, tap j's f32
    product w_j t_j rounded, then added, j = 0..3; a tap outside [0, T)
    reads a zero row; each sum rounded to bf16 into the piece's columns."""
    C = table_bf16.shape[1]
    pieces = []
    for off in range(0, C, rf.TILE_K):
        piece = table_bf16[:, off : off + rf.TILE_K]
        acc = np.zeros((idx.shape[0], piece.shape[1]), np.float32)
        for j in range(4):
            ij = idx[:, j]
            valid = (ij >= 0) & (ij < T)
            t = np.where(valid[:, None], piece[np.clip(ij, 0, T - 1)], np.float32(0))
            acc = (acc + (w[:, j : j + 1] * t).astype(np.float32)).astype(np.float32)
        pieces.append(_bf16_bits(acc))
    assert len(pieces) == rf.latent_pieces(C)
    return np.concatenate(pieces, axis=1)


@pytest.mark.parametrize("C", [832, 1856, 3904])
def test_kernel_pieces_give_gather_reference_bits(C):
    """Piece by piece, the kernel's tap order and rounding give
    ``gather_reference(..., bfloat16)`` bit for bit: each column's sum is its
    own, so the card can hold the widened gathers bit for bit against the
    dense kernels on that latent."""
    rng = np.random.default_rng(C)
    table = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).bfloat16()
    table[:4] = 0.0
    idx, w = _taps(rng, 300)
    w[::5, 2] = -w[::5, 2]
    ref = rf.gather_reference(torch.from_numpy(idx), torch.from_numpy(w), table, torch.bfloat16)
    ref_bits = ref.bfloat16().view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(_kernel_lookup_in_pieces(idx, w, table.float().numpy()),
                                  ref_bits)


def _tower(C, H=512, nb=5, n_lin_z=3):
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    f = lambda *s: torch.zeros(*s)  # noqa: E731
    return rf.Tower(w_in=z(48, H), b_in=f(H), w_z=z(n_lin_z, C, H), b_z=f(n_lin_z, H),
                    w_blk=z(nb, 2, H, H), b_blk=f(nb, 2, H), w_out=z(H, 4), b_out=f(4), d_in=42,
                    d_hidden=H)


@pytest.mark.parametrize("H", rf.FWD_HIDDEN)
@pytest.mark.parametrize("C", [832, 1024, 1856, 3904, 4096])
def test_check_gathers_take_tables_to_4096(C, H):
    """The gathers' wrapper checks take sn64's tower at every library's
    width with a (1024, C) table from one view and (2, 1024, C) tables from
    two, and refuse a table past 4096 columns."""
    lim = rf.tile_limits(H)
    idx, w = torch.zeros(100, TAPS, dtype=torch.int32), torch.zeros(100, TAPS)
    rf.check_gather(idx, w, torch.zeros(1024, C, dtype=torch.bfloat16), 100, _tower(C, H), 5, lim)
    rf.check_gather_mv(torch.zeros(200, TAPS, dtype=torch.int32), torch.zeros(200, TAPS),
                       torch.zeros(2, 1024, C, dtype=torch.bfloat16), 200, 3, _tower(C, H), 5, lim)
    with pytest.raises(ValueError, match="gather kernels take a latent of at most 4096"):
        rf._check_gather_width(4112, lim)


@pytest.mark.parametrize("backbone,num_layers,C", [
    ("resnet50", 3, 832),  # the fault: the fused gather raised on the card
    ("resnet34", 5, 1024),  # and here
    ("resnet50", 4, 1856),  # sn64's layers with ResNet50: the kernels, no longer plain
    ("resnet50", 5, 3904),
])
def test_fused_gather_route_takes_only_widths_the_gathers_take(backbone, num_layers, C):
    """sn64's model with the encoder's backbone and layers overridden (as
    ``chip_smoke.py``'s phase 21 builds it) on a (faked) card under
    ``auto``: from 1 and 2 views (1024 and 2048 table rows, inside the
    fused-gather cap) ``_fused_gather_ok`` and the field's route take the
    fused gather, and then the gathers' mirrored limits, and the wrappers'
    checks on those tables, take the width -- so the card's wrapper never
    refuses a call the route sent it.  No library is built or loaded."""
    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.models import make_model

    conf = entry.load_conf(pretrained=False)
    conf.put("model.encoder.backbone", backbone)
    conf.put("model.encoder.num_layers", num_layers)
    net = make_model(conf["model"], mlp_impl="auto", device="meta")
    assert net.encoder.latent_size == net.mlp_fine.d_latent == C
    for NS in (1, 2):
        latents = torch.empty((NS, 32, 32, C), device="meta")  # 64 px, no first pool
        assert net._fused_gather_ok(latents, NS)
        for mlp in (net.mlp_coarse, net.mlp_fine):
            assert mlp._kernel_route((NS, 64), CUDA, False)
            lim = rf.TILE_LIMITS[mlp.d_hidden]
            rf._check_gather_width(C, lim)  # raised at C > 512 before the gathers took pieces
            tw = _tower(C)
            tabs = torch.zeros(NS, 1024, C, dtype=torch.bfloat16)
            idx, w = torch.zeros(NS * 64, TAPS, dtype=torch.int32), torch.zeros(NS * 64, TAPS)
            if NS == 1:
                rf.check_gather(idx, w, tabs[0], 64, tw, mlp.n_blocks, lim)
            else:
                rf.check_gather_mv(idx, w, tabs, NS * 64, mlp.combine_layer, tw, mlp.n_blocks,
                                   lim)
            assert mlp._kernel_route((NS, 64), CUDA, False, gather=True)
            assert all(mlp._kernel_route((nv, 64), CUDA, True) for nv in (1, 3))  # train
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("backbone", ["resnet18", "resnet34", "resnet50"])
@pytest.mark.parametrize("num_layers", [1, 2, 3, 4, 5])
def test_route_takes_every_resnet_latent(backbone, num_layers):
    """Every unified map the encoder options give (ResNet18 / 34: 64 to
    1024 channels; ResNet50: 64, 320, 832, 1856, 3904) takes the kernels
    under ``auto`` on a (faked) card at sn64's other widths (d_hidden 512, 5
    blocks, the views' mean at block 3), from 1, 2 and 3 views, eval (dense
    and fused gather) and grad, decided from the mirrors alone."""
    from pixelnerf_tpu_torch.models.resnet import stage_channels

    C = sum(stage_channels(backbone)[:num_layers])
    with torch.device("meta"):
        mlp = ResnetFC(d_in=42, d_out=4, n_blocks=5, d_latent=C, d_hidden=512, combine_layer=3,
                       impl="auto")
    for NS in (1, 2, 3):
        assert mlp._kernel_route((NS, 64), CUDA, False)
        assert mlp._kernel_route((NS, 64), CUDA, False, gather=True)
        assert mlp._kernel_route((NS, 64), CUDA, True)
    assert not rf._LIBS and not rv._LIBS
