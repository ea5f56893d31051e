"""The port's multi-view dense forward (row 3 of PERF.md: ``_kernel_2d_mv``):
``ops/resnetfc_fused.py::resnetfc_dense_mv``, its plain version
``resnetfc_reference`` and the launch helpers of ``resnetfc_fwd_dense_mv``
(``dense_steps`` at NS views, ``dense_mv_grid``, ``check_dense_mv``), and a
Python mirror of the kernel's program: one view's steps stored once and
walked NS times, which must walk the same steps as the flat program of
every view written out; the plain version also at the narrow widths
d_hidden 64, 128 and 256 (one library a width).

``resnetfc_fwd_dense_mv`` walks 64-point tiles of output points on
persistent CTAs; its input rows are object-major (SB objects x NS views x
B_obj points), so at B_obj = 100 and 333 tiles straddle two objects and the
last one is ragged.  On the CPU the wrapper's plain version, in f32, is held
against the JAX package's ``_kernel_2d_mv`` through ``resnetfc_pallas`` in
interpret mode, with the encoded code and with a ``RawCode``, planar and
row-major, to 1e-4 of max(1, max|ref|), the bar of
``tests/test_torch_multiview.py`` (f32 sums reassociated).  On the card
(``cuda``-marked, skipped here) the kernel is held against the same plain
version in bf16 at the bar of ``tests/test_pallas.py``, and against lin_out of
the backward's data kernel's stashed t.
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

# what the tile kernels fix, by hand (the library reports it on the card), as
# in tests/test_torch_fwd_dense.py
LIMITS = rf.DenseLimits(tile=64, threads=256, stages=3, max_out=4, max_steps=128, max_k=512,
                        slot_floats=128 * 256, smem=2 * 65536 + 3 * 32768 + 1024, plan_bytes=448)
PE = dict(num_freqs=6, d_in=3, freq_factor=1.5, include_input=True)  # sn64's code
# the narrow towers' shapes, as in tests/test_torch_fwd_dense.py
NARROW = {"small": dict(d_in=10, C=64, nb=3, cl=2), "sn64": dict(d_in=None, C=512, nb=5, cl=3)}


def _setup(rows, d_latent, H, nb, cl, seed=0, d_in=None):
    """JAX ResnetFC parameters drawn from numpy (every parameter live), the
    port module holding the same weights, the sn64 code's raw coordinates
    and flat arrays, the encoded code (or, given ``d_in``, a normal (rows,
    d_in) code in its place) and a latent, for ``rows`` input rows."""
    W, f, p, m = JPositionalEncoding(**PE).flat_arrays(tail=3)
    d_code = W.shape[1]
    d_in = d_code if d_in is None else d_in
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
    xyz = rng.uniform(-1.4, 1.4, size=(rows, 3))
    vd = rng.normal(size=(rows, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    raw = np.concatenate([xyz, vd], axis=-1).astype(np.float32)
    enc = (raw.astype(np.float64) @ W).astype(np.float32)
    enc = np.where(m > 0, np.sin(enc * f + p), enc).astype(np.float32)
    if d_in != d_code:
        enc = rng.normal(size=(rows, d_in)).astype(np.float32)
    z = rng.normal(size=(rows, d_latent)).astype(np.float32)
    return params, port, raw, (W, f, p, m), enc, z


@pytest.mark.parametrize("NS,sb,B_obj,raw_code,planar", [
    (2, 1, 100, False, True),
    (2, 2, 333, True, False),
    (3, 1, 333, False, False),
    (3, 2, 100, True, True),
    (3, 2, 333, False, True),
    (2, 2, 100, False, False),
    (3, 1, 100, True, False),
    (2, 1, 333, True, True),
])
def test_dense_mv_plain_matches_pallas_interpret(NS, sb, B_obj, raw_code, planar):
    """resnetfc_dense_mv on CPU tensors (its plain version) against
    resnetfc_pallas (_kernel_2d_mv) in interpret mode, with tiles that
    straddle objects and a ragged last tile."""
    C, H, nb, cl = 32, 64, 4, 2
    rows = sb * NS * B_obj
    params, port, raw, code, enc, z = _setup(rows, C, H, nb, cl, seed=rows + raw_code)
    if raw_code:
        jx = rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code))
        x = rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code))
    else:
        jx, x = jnp.asarray(enc), torch.from_numpy(enc)
    ref = rp.resnetfc_pallas(params, (jnp.asarray(z), jx), NS=NS, d_latent=C, d_in=enc.shape[1],
                             n_blocks=nb, combine_layer=cl, sb=sb, block_points=128,
                             interpret=True, planar_out=planar)
    ref = np.asarray(ref)[0]
    rf.reset_launches()
    out = rf.resnetfc_dense_mv(torch.from_numpy(z), x, port.tower(torch.device("cpu")), nb, NS, cl,
                               sb, planar)
    assert not any(rf.LAUNCHES.values())  # CPU tensors: the plain version, no launch
    B = sb * B_obj
    assert tuple(out.shape) == ref.shape == ((4, B) if planar else (B, 4))
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


# the narrower widths these checks were written for; tests/test_torch_hidden_widths.py
# holds the plain versions at 192 and at a padded width against the JAX kernels
@pytest.mark.parametrize("H", [64, 128, 256, 384])
@pytest.mark.parametrize("shape,NS,sb,B_obj,raw_code,planar", [
    ("small", 2, 1, 75, False, True),
    ("sn64", 2, 1, 160, True, False),
    ("sn64", 3, 2, 80, False, True),
    ("sn64", 3, 2, 80, True, False),
])
def test_dense_mv_plain_at_narrow_widths_matches_pallas_interpret(H, shape, NS, sb, B_obj,
                                                                  raw_code, planar):
    """The narrow towers the kernels take (d_hidden 64, 128 and 256): the plain
    version against ``_kernel_2d_mv`` in interpret mode at
    tests/test_pallas.py's small shape and at sn64's other widths, NS 2 and
    NS 3 x SB 2 (tiles straddling objects, a ragged last tile): the view
    mean over an H-wide stream."""
    d_in, C, nb, cl = NARROW[shape].values()
    rows = sb * NS * B_obj
    params, port, raw, code, enc, z = _setup(rows, C, H, nb, cl, seed=H + rows + raw_code,
                                             d_in=d_in)
    if raw_code:
        jx = rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code))
        x = rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code))
    else:
        jx, x = jnp.asarray(enc), torch.from_numpy(enc)
    ref = rp.resnetfc_pallas(params, (jnp.asarray(z), jx), NS=NS, d_latent=C, d_in=enc.shape[1],
                             n_blocks=nb, combine_layer=cl, sb=sb, block_points=128,
                             interpret=True, planar_out=planar)
    ref = np.asarray(ref)[0]
    tw = port.tower(torch.device("cpu"))
    assert tw.w_in.shape[1] == H
    rf.reset_launches()
    out = rf.resnetfc_dense_mv(torch.from_numpy(z), x, tw, nb, NS, cl, sb, planar)
    assert not any(rf.LAUNCHES.values())
    B = sb * B_obj
    assert tuple(out.shape) == ref.shape == ((4, B) if planar else (B, 4))
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


def _walk_back(nb, nlz, NS, pre):
    """The data kernel's stored steps after its recompute (data_steps):
    lin_out, the shared blocks' walk back, then one view's (its dview, the
    blocks below the mean, its injections and lin_in), walked NS times."""
    mv = int(NS > 1)
    return 1 + 3 * (nb - pre) + (mv + 3 * pre + nlz + 1)


@pytest.mark.parametrize("nb,nlz,pre", [(5, 3, 3), (4, 2, 2), (3, 0, 1), (2, 1, 1), (5, 0, 0)])
def test_dense_mv_program_is_the_data_kernels_recompute(nb, nlz, pre):
    """A tile's steps at NS views are those of the data kernel's recompute:
    per view lin_in, the injections and blocks below the mean and the fold,
    then the shared blocks; at NS = 1 the one-view program."""
    assert rf.dense_steps(nb, nlz, 1, pre) == rf.dense_steps(nb, nlz)
    walk_back = _walk_back(nb, nlz, 1, nb)
    assert rf.dense_steps(nb, nlz) == rv.data_steps(nb, nlz, 1, nb, 512, 512) - walk_back
    for NS in range(2, 10):
        want = rv.data_steps(nb, nlz, NS, pre, 512, 512) - _walk_back(nb, nlz, NS, pre)
        assert rf.dense_steps(nb, nlz, NS, pre) == want


def test_dense_mv_program_takes_every_view_count_of_the_data_kernel():
    """At sn64 (5 blocks, 3 injections, the mean at block 3) a tile stores 15
    steps at every view count (one view's 11, the shared blocks' 4) and the
    data kernel 36, within the forward's 128 and the data kernel's 256: the
    stored programs do not grow with the views."""
    assert rf.dense_steps(5, 3) == 14
    for NS in (2, 3, 9, 10, 12, 24, 25, 64, 255):
        assert rf.dense_steps(5, 3, NS, 3) == 15 <= LIMITS.max_steps
        assert rv.data_steps(5, 3, NS, 3, 512, 512) == 36 <= 256


@pytest.mark.parametrize("B,n_sms,grid", [(1, 132, 1), (64, 132, 1), (65, 132, 2), (666, 132, 11),
                                          (8448, 132, 132), (8449, 132, 132), (49152, 132, 132),
                                          (393216, 132, 132), (49152, 114, 114)])
def test_dense_mv_grid_is_persistent(B, n_sms, grid):
    """min(tiles, SMs): each CTA holds a view-sum slot and walks its tiles."""
    assert rf.dense_mv_grid(B, n_sms, LIMITS) == grid == min(-(-B // 64), n_sms)


# ---- a Python mirror of the tile's program and of its two walks ----
# Kinds and the step word as csrc/tile64.cuh has them; FOLD is the only kind
# here that is not a product.  A walked step is (step word, view).
IN_FWD, Z_FWD, B0_FWD, B1_FWD, FOLD = range(5)


def _step(kind, k, aux):
    return kind | (k << 4) | (aux << 10)


def _flat_program(nb, nlz, NS, pre):
    """The flat program: every view's steps written out in turn, then the
    shared blocks (of no view)."""
    mv, out = NS > 1, []
    for v in range(NS):
        out.append((_step(IN_FWD, 0, int(nlz == 0 and pre > 0)), v))
        for k in range(pre):
            if k < nlz:
                out.append((_step(Z_FWD, k, 0), v))
            out.append((_step(B0_FWD, k, 0), v))
            out.append((_step(B1_FWD, k, int(k + 1 >= nlz and (k + 1 < pre or not mv))), v))
        if mv:
            out.append((_step(FOLD, 0, 0), v))
    for k in range(pre, nb):
        out += [(_step(B0_FWD, k, 0), None), (_step(B1_FWD, k, 1), None)]
    return out


def _stored_program(nb, nlz, mv, pre):
    """fwd_program: one view's segment, then the shared blocks."""
    return [s for s, v in _flat_program(nb, nlz, 2 if mv else 1, pre) if v in (0, None)]


def _body_walk(prog, NS, pre):
    """fwd_body's walk at NS views (MV): si holds the index in its low 12 bits
    and the view above them; FOLD goes on to the next view's segment, or
    after the last view on into the shared blocks, which read no view (the
    last one's stays in si) to the walk's end."""
    out, si, end = [], 0, len(prog) | ((NS - 1) << 12)
    while si < end:
        s = prog[si & 0xFFF]
        shared = s & 15 in (B0_FWD, B1_FWD) and (s >> 4) & 63 >= pre
        out.append((s, None if shared else si >> 12))
        if s & 15 == FOLD and (si >> 12) + 1 < NS:
            si = (((si >> 12) + 1) << 12) - 1
        si += 1
    return out


def _feeder_walk(prog, NS, tiles):
    """dense_feed's walk of the products at NS views (MV) over a CTA's tiles:
    the segment's products once for each view (a compare and a reset of the
    views left), then the shared blocks', then the next tile."""
    gprog = [s for s in prog if s & 15 != FOLD]
    seg = [s & 15 for s in prog].index(FOLD)
    out, g, vleft, left = [], 0, NS - 1, tiles
    while left > 0:
        out.append(gprog[g])
        g += 1
        if g == seg and vleft > 0:
            g, vleft = 0, vleft - 1
        elif g == len(gprog):
            g, vleft, left = 0, NS - 1, left - 1
    return out


@pytest.mark.parametrize("nb,nlz,pre", [(5, 3, 3), (4, 2, 2), (3, 0, 1), (2, 1, 1), (5, 0, 0),
                                        (3, 3, 3)])
def test_looped_program_walks_the_flat_program(nb, nlz, pre):
    """At NS 2-64 the stored program (dense_steps long), walked as the body
    walks it, is the flat program step for step, with the view of every step
    that reads one; the feeders' walk of its products is the flat program's
    products over two tiles (their weights: gemm_of reads no view).  At NS =
    1 the stored program is the one-view program itself."""
    one = _stored_program(nb, nlz, False, nb)
    assert one == [s for s, _ in _flat_program(nb, nlz, 1, nb)]
    assert len(one) == rf.dense_steps(nb, nlz)
    if pre == nb:
        return
    prog = _stored_program(nb, nlz, True, pre)
    assert len(prog) == rf.dense_steps(nb, nlz, 2, pre)
    for NS in range(2, 65):
        flat = _flat_program(nb, nlz, NS, pre)
        assert _body_walk(prog, NS, pre) == flat
        products = [s for s, _ in flat if s & 15 != FOLD]
        assert _feeder_walk(prog, NS, 2) == products * 2


def _tower(kin=48, H=512, C=512, n_lin_z=3, nb=5, d_out=4):
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    f = lambda *s: torch.zeros(*s)  # noqa: E731
    return rf.Tower(w_in=z(kin, H), b_in=f(H), w_z=z(n_lin_z, C, H), b_z=f(n_lin_z, H),
                    w_blk=z(nb, 2, H, H), b_blk=f(nb, 2, H), w_out=z(H, d_out), b_out=f(d_out),
                    d_in=42, d_hidden=H)


def _z(rows, C=512, dtype=torch.bfloat16):
    return torch.zeros(rows, C, dtype=dtype)


def test_check_dense_mv_takes_sn64():
    """sn64 at 3 views (the mean at block 3), SB 1 and the -V 3 train layout,
    and at 9 views."""
    rf.check_dense_mv(_z(3 * 4096), 3 * 4096, 3, 1, 3, _tower(), 5, LIMITS)
    rf.check_dense_mv(_z(4 * 3 * 333), 4 * 3 * 333, 3, 4, 3, _tower(), 5, LIMITS)
    rf.check_dense_mv(_z(9 * 64), 9 * 64, 9, 1, 3, _tower(), 5, LIMITS)
    # no latent: z is not read
    rf.check_dense_mv(None, 2 * 100, 2, 1, 3, _tower(n_lin_z=0), 5, LIMITS)


@pytest.mark.parametrize("NS", [1, 0])
def test_check_dense_mv_refuses_fewer_than_two_views(NS):
    with pytest.raises(ValueError, match="views"):
        rf.check_dense_mv(_z(300), 300, NS, 1, 3, _tower(), 5, LIMITS)


@pytest.mark.parametrize("NS", [12, 24, 64, 255])
def test_check_dense_mv_takes_any_view_count(NS):
    """sn64 from 12, 24, 64 and 255 views, SB 1 and 2: the stored program is
    one view's segment and the shared blocks, 15 steps at any NS."""
    rf.check_dense_mv(_z(NS * 64), NS * 64, NS, 1, 3, _tower(), 5, LIMITS)
    rf.check_dense_mv(_z(2 * NS * 3), 2 * NS * 3, NS, 2, 3, _tower(), 5, LIMITS)


def test_check_dense_mv_refuses_views_past_the_program():
    """A step holds its view in 8 bits: 256 views are past the program; and
    a tower whose stored program is past max_steps is refused at any NS."""
    rows = 256 * 4
    with pytest.raises(ValueError, match="at most 255 views"):
        rf.check_dense_mv(_z(rows), rows, 256, 1, 3, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match="steps"):
        rf.check_dense_mv(_z(2 * 64), 2 * 64, 2, 1, 3, _tower(), 5, LIMITS._replace(max_steps=14))


def test_check_dense_mv_refuses_a_latent_it_cannot_read():
    rows = 3 * 100
    with pytest.raises(ValueError, match="bf16"):
        rf.check_dense_mv(_z(rows, dtype=torch.float32), rows, 3, 1, 3, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match="bf16"):
        rf.check_dense_mv(None, rows, 3, 1, 3, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match="shape"):
        rf.check_dense_mv(_z(rows - 3), rows, 3, 1, 3, _tower(), 5, LIMITS)
    with pytest.raises(ValueError, match="shape"):
        rf.check_dense_mv(_z(rows, 256), rows, 3, 1, 3, _tower(), 5, LIMITS)
    flat = torch.zeros(rows * 512 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):  # 2 bytes past a 16-byte boundary
        rf.check_dense_mv(flat[1:1 + rows * 512].view(rows, 512), rows, 3, 1, 3, _tower(), 5,
                          LIMITS)


@pytest.mark.parametrize("rows,NS,sb", [(3 * 100 + 1, 3, 1), (2 * 3 * 100 + 3, 3, 2),
                                        (100, 3, 1)])
def test_check_dense_mv_refuses_rows_that_are_not_objects_x_views(rows, NS, sb):
    with pytest.raises(ValueError, match="objects x"):
        rf.check_dense_mv(_z(rows), rows, NS, sb, 3, _tower(), 5, LIMITS)


@pytest.mark.parametrize("tower,cl,what", [
    (dict(H=256), 3, "d_hidden"),
    (dict(C=40), 3, "C"),
    (dict(kin=40), 3, "kin"),
    (dict(d_out=5), 3, "outputs"),
    (dict(), 2, "below the view mean"),
    (dict(), 5, "combine_layer"),
])
def test_check_dense_mv_refuses_widths_the_tile_does_not_take(tower, cl, what):
    tw = _tower(**tower)
    rows = 3 * 100
    with pytest.raises(ValueError, match=what):
        rf.check_dense_mv(_z(rows, tw.w_z.shape[1]), rows, 3, 1, cl, tw, tw.w_blk.shape[0], LIMITS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("raw_code", [False, True])
def test_dense_mv_kernel_matches_plain_on_card(cuda_device, raw_code):
    """sn64 widths, SB 2 x NS 3 x B_obj 333 (tiles straddling the objects, the
    last one ragged): the kernel against its plain version in bf16 (the bar
    of tests/test_pallas.py), planar and row-major, one launch each,
    bit-identical on a second call; the encoded kernel's output against
    lin_out of the data kernel's stashed t (the same products in the same
    order)."""
    NS, sb, B_obj, nb, cl = 3, 2, 333, 5, 3
    rows, B = sb * NS * B_obj, sb * B_obj
    _, port, raw, code, enc, z = _setup(rows, 512, 512, nb, cl)
    port = port.to(cuda_device)
    tw = port.tower(cuda_device)
    z = torch.from_numpy(z).to(cuda_device).bfloat16()
    x = (rf.RawCode(*(torch.from_numpy(a).to(cuda_device) for a in (raw,) + code)) if raw_code
         else torch.from_numpy(enc).to(cuda_device))
    name = "resnetfc_fwd_dense_mv" + ("_code" if raw_code else "")
    for planar in (True, False):
        before = rf.LAUNCHES[name]
        out = rf.resnetfc_dense_mv(z, x, tw, nb, NS, cl, sb, planar)
        torch.cuda.synchronize()
        assert rf.LAUNCHES[name] == before + 1
        ref = rf.resnetfc_reference(z, x, tw, nb, planar, compute_dtype=torch.bfloat16, NS=NS,
                                    sb=sb, combine_layer=cl)
        assert (out - ref).abs().max().item() <= 0.015 * max(1.0, ref.abs().max().item())
        assert torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1] > 0.999
        assert torch.equal(out, rf.resnetfc_dense_mv(z, x, tw, nb, NS, cl, sb, planar))
    if not raw_code:
        g = torch.zeros(4, B, device=cuda_device)
        data = rv.bwd_data(g, z, x, tw, nb, False, NS=NS, sb=sb, combine_layer=cl)
        out = rf.resnetfc_dense_mv(z, x, tw, nb, NS, cl, sb).double()
        t_out = (data.ws_act[-1, :B].double() @ tw.w_out.double()).t() + tw.b_out.double()[:, None]
        assert (out - t_out).abs().max().item() <= 1e-5 * max(1.0, out.abs().max().item())
