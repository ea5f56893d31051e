"""The data half of the port's ResnetFC backward (``ops/resnetfc_vjp.py``:
``bwd_data``, its plain version ``workspace_reference``, and the launch
helpers ``data_grid``, ``data_slots``' size, ``check_data_widths`` and
``check_data_program``), and a Python mirror of the kernel's program: one
view's recompute and walk back stored once each and walked NS times, which
must walk the same steps as the flat program of every view written out.

``resnetfc_bwd_data`` walks 64-point tiles but keeps the DataOut contract of
32-row tiles: ``B_pad`` is B rounded up to 32, and ``rows`` holds one row of
column sums per 32 rows.  So every case here leaves a half-filled 64-point
tile (B_pad an odd multiple of 32), and some an odd B.

On the CPU the plain workspace, in f32, is held against the JAX package's
``_bwd_kernel`` through ``resnetfc_pallas_diff`` in interpret mode (as
``tests/test_torch_train_vjp.py`` runs it): dz and dx, every bias gradient
and dW_out as the tile sums of ``rows``, and the stashed forward operand t
through lin_out against the JAX forward's value, each to 5e-4 of
max(max|ref|, 1e-3), the tolerance of ``tests/test_pallas_vjp.py``.  On the
card (``cuda``-marked, skipped here) the kernel is held against the same
plain workspace in bf16.
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

# what resnetfc_bwd_data_kernel fixes, by hand (the library reports it on the
# card): 64-point tiles, 256 threads, a 128 KB multi-view slot, 3 stages of
# 32 KB, at most 4 outputs and 512 (16-bit) steps a tile, a latent up to
# 4096 wide, a code up to 512, 64 blocks; two 64 KB operand tiles + the ring
# + 1 KB slack
LIMITS = rv.DataLimits(tile=64, threads=256, slot_floats=32768, stages=3, max_out=4,
                       max_steps=512, max_c=4096, smem=2 * 65536 + 3 * 32768 + 1024,
                       hidden=512, max_k=512, max_blocks=64)
# the narrower libraries' (d_hidden 384, 256, 128 and 64): a slot of the 64 x
# H stream (H / 4 f32 a thread), the same 96 KB ring in 3 stages of 32 KB, 6
# of 16 KB or 12 of 8 KB
LIMITS_AT = {512: LIMITS,
             384: LIMITS._replace(slot_floats=24576, stages=6, hidden=384),
             256: LIMITS._replace(slot_floats=16384, hidden=256),
             128: LIMITS._replace(slot_floats=8192, stages=6, hidden=128),
             64: LIMITS._replace(slot_floats=4096, stages=12, hidden=64)}

CASES = [
    # NS, sb, B_obj, d_in, d_latent, d_hidden, n_blocks, combine_layer
    (1, 1, 96, 42, 64, 64, 3, 2),  # B_pad 96: the last 64-point tile half full
    (1, 1, 151, 39, 0, 32, 2, 1),  # odd B, no latent
    (2, 1, 80, 42, 32, 64, 3, 2),  # two views, B_pad 96
    (3, 2, 37, 42, 32, 64, 3, 2),  # three views, two objects, B = 74, B_pad 96
]
# sn64's tower (H 512, 5 blocks, the latent in blocks 0-2, the mean at block
# 3) at the latent widths past 512 and below it that the kernels take in
# pieces: the global encoder's 128 + 512 = 640 (two pieces an injection) and
# the ConvEncoder's 128 (one piece of K = 128); B_pad an odd multiple of 32
WIDE_CASES = [
    (1, 1, 96, 42, 640, 512, 5, 3),
    (3, 2, 48, 42, 640, 512, 5, 3),
    (1, 1, 160, 42, 128, 512, 5, 3),
]
# sn64's depth at the narrow widths, d_hidden 256, 128 and 64 (each a
# library of its own): C = 512 (one piece, 2, 4 or 8 dz steps an injection)
# and 640, from 1 and 3 views, a ragged B (150) and a small batch (SB 1 x 20:
# one half-filled tile)
NARROW_CASES = [
    (1, 1, 96, 42, 512, 256, 5, 3),
    (3, 2, 48, 42, 640, 256, 5, 3),
    (1, 1, 150, 42, 640, 128, 5, 3),
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
    kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
    Z = None if z is None else torch.from_numpy(z)
    g = torch.from_numpy(cot[0]).t().contiguous()
    return params, x, z, cot, tw, Z, torch.from_numpy(x), g, kw


def _close(b, a, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, atol=5e-4 * max(np.abs(a).max(), 1e-3), err_msg=what)


def _dz_rows(data, C):
    """dz of the DataOut (view-major, B_pad rows a view) in z's rows."""
    B_pad = data.ws_x.shape[0] // data.NS
    parts = list(data.dz.reshape(data.NS, B_pad, C)[:, : data.B])
    return rv.join_views(parts, data.sb)


@pytest.mark.parametrize("NS,sb,B_obj,d_in,d_latent,H,nb,cl", CASES + WIDE_CASES + NARROW_CASES)
def test_workspace_matches_pallas_interpret(NS, sb, B_obj, d_in, d_latent, H, nb, cl):
    params, x, z, cot, tw, Z, X, g, kw = _setup(NS, sb, B_obj, d_in, d_latent, H, nb, cl)

    def loss(p, z, x):
        out = resnetfc_pallas_diff(p, (z, x), NS=NS, d_latent=d_latent, d_in=d_in, n_blocks=nb,
                                   combine_layer=cl, sb=sb, block_points=128,
                                   bwd_block_points=128, interpret=True)
        return jnp.sum(out * cot), out

    zj = None if z is None else jnp.asarray(z)
    argnums = (0, 2) if z is None else (0, 1, 2)
    (_, out), grads = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(
        params, zj, jnp.asarray(x))
    ref = {k[len("mlp_coarse."):]: v.numpy() for k, v in from_jax_variables(
        {"params": {"mlp_coarse": jax.tree.map(np.asarray, grads[0])}}).items()}
    data = rv.workspace_reference(g, Z, X, tw, nb, compute_dtype=torch.float32, need_dx=True, **kw)
    B = sb * B_obj
    B_pad = -(-B // 32) * 32
    assert (B_pad // 32) % 2 == 1  # a half-filled 64-point tile
    assert data.rows.shape[0] == B_pad // 32

    # the stashed operand t, through lin_out, is the forward's value
    t = data.ws_act[-1, :B]
    _close((t @ tw.w_out + tw.b_out).numpy(), np.asarray(out).reshape(B, 4), "t W_out + b_out")
    # rows: the bias gradients and dW_out, summed over the 32-row tiles; a
    # tower packed zero-padded onto a wider library's width (H = 32 on the 64
    # library) has its own H columns there, and zeros past them
    s = data.rows.sum(0)
    assert tw.w_in.shape[1] == rf.library_width(H) and not s[:, H:].any()
    s = s[:, :H]
    n_lin_z = tw.w_z.shape[0]
    r_out = 1 + n_lin_z + 2 * nb
    got = {"lin_in.bias": s[0], "lin_out.bias": s[r_out, :4], "lin_out.weight": s[r_out + 1:]}
    for k in range(n_lin_z):
        got[f"lin_z.{k}.bias"] = s[1 + k]
    for k in range(nb):
        for i in (0, 1):
            got[f"blocks.{k}.fc_{i}.bias"] = s[1 + n_lin_z + 2 * k + i]
    for name, v in got.items():
        _close(v.numpy(), ref[name], name)
    _close(data.dx.numpy(), grads[-1], "dx")
    if z is not None:
        _close(_dz_rows(data, d_latent).numpy(), grads[1], "dz")


@pytest.mark.parametrize("NS,sb,B_obj,d_in,d_latent,H,nb,cl", CASES[::2] + [CASES[3]])
def test_workspace_rows_are_sums_of_32_row_tiles(NS, sb, B_obj, d_in, d_latent, H, nb, cl):
    """Each bias row of ``rows`` sums its f32 cotangent over one 32-row tile
    (views summed); rows past B are zero in every plane, and the pad half of
    the last 64-point tile sums to zero."""
    _, _, _, _, tw, Z, X, g, kw = _setup(NS, sb, B_obj, d_in, d_latent, H, nb, cl)
    data = rv.workspace_reference(g, Z, X, tw, nb, compute_dtype=torch.float32, **kw)
    B = sb * B_obj
    n_tiles = data.rows.shape[0]
    n_lin_z = tw.w_z.shape[0]
    NP = (data.ws_cot.shape[0] - NS) // 2
    assert not data.ws_act[:, B:].any() and not data.ws_cot[:, B:].any()
    # fc_1 of the last block: its cotangent is plane NP - 1 of ws_cot (one view above the mean)
    gb = data.ws_cot[NP - 1].reshape(n_tiles, 32, -1).sum(1)
    torch.testing.assert_close(data.rows[:, 1 + n_lin_z + 2 * (nb - 1) + 1], gb,
                               rtol=1e-5, atol=1e-5 * gb.abs().max().item())
    # db_in: lin_in's cotangent, summed over the views
    g_in = data.ws_cot[2 * NP:].reshape(NS, n_tiles, 32, -1).sum((0, 2))
    torch.testing.assert_close(data.rows[:, 0], g_in, rtol=1e-5, atol=1e-5 * g_in.abs().max().item())
    last = B - 32 * (n_tiles - 1)  # points in the last 32-row tile
    assert 0 < last <= 32
    if last < 32:
        assert not data.ws_x.reshape(NS, -1, data.ws_x.shape[1])[:, B:].any()


@pytest.mark.parametrize("NS,sb,B_obj,d_in,d_latent,H,nb,cl", [CASES[0], CASES[3]])
@pytest.mark.parametrize("need_dx", [False, True])
def test_workspace_dx_is_the_plain_backwards(NS, sb, B_obj, d_in, d_latent, H, nb, cl, need_dx):
    """need_dx adds the plain backward's dx (bf16(dv) W_in^T, in x's rows)
    and changes nothing else; the weights half takes the DataOut as it is."""
    _, _, _, _, tw, Z, X, g, kw = _setup(NS, sb, B_obj, d_in, d_latent, H, nb, cl)
    Zb = Z.bfloat16()
    got = rv.workspace_reference(g, Zb, X, tw, nb, need_dx=need_dx, **kw)
    base = rv.workspace_reference(g, Zb, X, tw, nb, **kw)
    for name in ("dz", "ws_act", "ws_cot", "ws_x", "ws_z", "rows"):
        a, b = getattr(got, name), getattr(base, name)
        if b is None:
            assert a is None, name
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert base.dx is None and (got.dx is not None) == need_dx
    if need_dx:
        ref = rv.resnetfc_bwd_reference(g, Zb, X, tw, nb, True, torch.bfloat16,
                                        operands=got.ws_act[:, : sb * B_obj].float(), **kw)
        assert got.dx.shape == X.shape
        torch.testing.assert_close(got.dx, ref.dx, rtol=0, atol=0)
    gr = rv.bwd_weights(Zb, got, tw, nb)
    assert gr.w_blk.shape == tw.w_blk.shape and gr.dx is got.dx


@pytest.mark.parametrize("B,NS,n_sms,want", [
    (4 * 128 * 96, 1, 132, (49152, 768, 768)),  # -V 1 fine pass: a CTA a tile
    (4 * 128 * 64, 3, 132, (32768, 512, 132)),  # -V 3 coarse: persistent, one CTA an SM
    (1000, 1, 132, (1024, 16, 16)),
    (990, 3, 132, (992, 16, 16)),  # B_pad 31 x 32: the last tile half full
    (33, 1, 132, (64, 1, 1)),
    (20, 3, 8, (32, 1, 1)),  # one half-filled tile
])
def test_data_grid(B, NS, n_sms, want):
    assert rv.data_grid(B, NS, n_sms, LIMITS) == want
    B_pad, tiles, _ = want
    assert B_pad % 32 == 0 and 0 <= tiles * 64 - B_pad < 64


@pytest.mark.parametrize("H", [512, 384, 256, 128, 64])
def test_data_limits_fit_the_card(H):
    """Two 64 KB operand tiles and 96 KB of ring stages fit the 227 KB a
    CTA may ask for at every width; the multi-view slot holds the 64 x H
    f32 stream (at 512 twice the forward kernels' old 64 KB slot of 32
    points); the mirrors are these."""
    lim = LIMITS_AT[H]
    assert rv.DATA_LIMITS[H] == lim
    rv.check_data_widths(48, H, 512, 3, 5, 4, lim)
    assert lim.smem <= rf.MAX_SMEM_BYTES
    assert lim.slot_floats * 4 == 64 * H * 4
    assert lim.slot_floats == lim.threads * H // 4  # H / 4 f32 a thread
    with pytest.raises(ValueError, match="shared memory"):
        rv.check_data_widths(48, H, 512, 3, 5, 4, lim._replace(smem=rf.MAX_SMEM_BYTES + 1))


@pytest.mark.parametrize("kin,H,C,n_lin_z,nb,d_out,match", [
    (48, 576, 512, 3, 5, 4,
     "d_hidden 512, one library each of \\(64, 128, 192, 256, 320, 384, 512\\)"),
    (48, 256, 512, 3, 5, 4, "this library needs d_hidden 512"),  # another width's library
    (48, 512, 4112, 3, 5, 4, "d_latent a multiple of 16 in \\[16, 4096\\]"),
    (528, 512, 512, 3, 5, 4, "kin a multiple of 16 in \\[16, 512\\]"),
    (40, 512, 512, 3, 5, 4, "multiple of 16"),
    (48, 512, 512, 0, 0, 4, "n_blocks >= 1"),
    (48, 512, 512, 3, 5, 5, "1 to 4 outputs"),
])
def test_check_data_widths_refuses(kin, H, C, n_lin_z, nb, d_out, match):
    with pytest.raises(ValueError, match=match):
        rv.check_data_widths(kin, H, C, n_lin_z, nb, d_out, LIMITS)


@pytest.mark.parametrize("nb,nlz,NS,pre,C,want", [
    # lin_in, 3 injections, 10 block layers; lin_out; 5 x (cotangent, fc_1,
    # fc_0), 3 injections, lin_in's cotangent
    (5, 3, 1, 5, 512, 14 + 1 + 19),
    # -V 3: one view's recompute below the mean and its fold (11), blocks 3-4
    # and lin_out and their walk back (11), one view's walk back (14); the
    # tile walks the first and the last part once for each view
    (5, 3, 3, 3, 512, 11 + 11 + 14),
    (3, 0, 1, 3, 512, 7 + 1 + 10),
    (5, 0, 2, 0, 512, 2 + 10 + 1 + 15 + 2),  # no latent, the mean at lin_in's output
    # the global encoder's C = 640: two pieces an injection each way
    (5, 3, 1, 5, 640, 17 + 1 + 22),
    (5, 3, 3, 3, 640, 14 + 11 + 17),
    (5, 3, 1, 5, 1024, 40),
    (5, 3, 1, 5, 128, 34),  # the ConvEncoder's C = 128: one piece
])
def test_data_steps(nb, nlz, NS, pre, C, want):
    assert rv.data_steps(nb, nlz, NS, pre, C, 512) == want
    assert want <= LIMITS.max_steps


@pytest.mark.parametrize("NS", [10, 24, 64, 255])
def test_check_data_program_takes_any_view_count(NS):
    """-V 10, 24, 64 and 255 at sn64: 36 steps stored at any view count."""
    rv.check_data_program(5, 3, NS, 3, LIMITS, 512)
    assert rv.data_steps(5, 3, NS, 3, 512, 512) == 36


def test_check_data_program_refuses_views_past_the_step_and_long_towers():
    with pytest.raises(ValueError, match="at most 255 views"):
        rv.check_data_program(5, 3, 256, 3, LIMITS, 512)
    with pytest.raises(ValueError, match="stores at most 35 steps"):
        rv.check_data_program(5, 3, 3, 3, LIMITS._replace(max_steps=35), 512)


# ---- a Python mirror of the data kernel's program and of its two walks ----
# Kinds and the step word as csrc/tile64.cuh has them.  A walked step is
# (step word, view); the shared steps are walked at view 0.
IN_FWD, Z_FWD, B0_FWD, B1_FWD, FOLD, T_OUT, GB, Z_BWD, B1_BWD, B0_BWD, DVIEW, G_IN = range(12)
NOT_PRODUCTS = (FOLD, T_OUT, GB, DVIEW, G_IN)


def _step(kind, k, aux):
    return kind | (k << 4) | (aux << 10)


def _flat_program(nb, nlz, NS, pre, pieces=1, dz_steps=None):
    """The flat program: every view's recompute, the shared steps, every
    view's walk back, written out in turn; each injection ``pieces`` steps
    in the recompute (Z_FWD's aux the piece) and ``dz_steps`` (default
    ``pieces``) in the walk back (Z_BWD's aux the dz step)."""
    dz_steps = pieces if dz_steps is None else dz_steps
    mv, out = NS > 1, []
    for v in range(NS):
        out.append((_step(IN_FWD, 0, int(nlz == 0 and pre > 0)), v))
        for k in range(pre):
            if k < nlz:
                out += [(_step(Z_FWD, k, j), v) for j in range(pieces)]
            out.append((_step(B0_FWD, k, 0), v))
            out.append((_step(B1_FWD, k, int(k + 1 >= nlz and (k + 1 < pre or not mv))), v))
        if mv:
            out.append((_step(FOLD, 0, 0), v))
    for k in range(pre, nb):
        out += [(_step(B0_FWD, k, 0), 0), (_step(B1_FWD, k, 1), 0)]
    out.append((_step(T_OUT, 0, 0), 0))
    for k in range(nb - 1, pre - 1, -1):
        out += [(_step(GB, k, 0), 0), (_step(B1_BWD, k, 0), 0), (_step(B0_BWD, k, 0), 0)]
    for v in range(NS):
        if mv:
            out.append((_step(DVIEW, 0, 0), v))
        for k in range(pre - 1, -1, -1):
            out.append((_step(GB, k, 0), v))
            if k + 1 < nlz:
                out += [(_step(Z_BWD, k + 1, j), v) for j in range(dz_steps)]
            out += [(_step(B1_BWD, k, 0), v), (_step(B0_BWD, k, 0), v)]
        out.append((_step(G_IN, 0, 0), v))
        if nlz > 0:
            out += [(_step(Z_BWD, 0, j), v) for j in range(dz_steps)]
    return out


def _stored_program(nb, nlz, mv, pre, pieces=1, dz_steps=None):
    """data_program: one view's recompute, the shared steps, one view's walk
    back."""
    return [s for s, v in _flat_program(nb, nlz, 2 if mv else 1, pre, pieces, dz_steps) if v == 0]


def _segments(prog):
    """(d_seg1, d_seg3): the end of the recompute segment (after FOLD) and
    the start of the walk-back segment (DVIEW)."""
    kinds = [s & 15 for s in prog]
    return kinds.index(FOLD) + 1, kinds.index(DVIEW)


def _body_walk(prog, NS):
    """The kernel's step loop at NS views (MV): si holds the index in its low
    12 bits and the view above them; FOLD goes on to the next view's
    recompute or into the shared steps (view 0); the end of a view's walk
    back goes on to the next view's, to the walk's end."""
    _, seg3 = _segments(prog)
    out, si, end = [], 0, len(prog) | ((NS - 1) << 12)
    while si < end:
        if (si & 0xFFF) == len(prog):
            si = seg3 | (((si >> 12) + 1) << 12)
        s = prog[si & 0xFFF]
        out.append((s, si >> 12))
        if s & 15 == FOLD:
            v = si >> 12
            si = ((v + 1) << 12) - 1 if v + 1 < NS else si & 0xFFF
        si += 1
    return out


def _feeder_walk(prog, NS, tiles):
    """feed's walk of the products at NS views (MV) over a CTA's tiles:
    next_step (one compare a step against where the walk next turns), each
    product's successor skipping what is not a product."""
    seg1, seg3 = _segments(prog)
    out, g, v, bound, tile = [], 0, 0, seg1, 0

    def next_step():
        nonlocal g, v, bound, tile
        g += 1
        if g != bound:
            return
        if g == seg1:
            v += 1
            if v < NS:
                g = 0
            else:
                v, bound = 0, len(prog)
        else:
            v += 1
            if v < NS:
                g = seg3
            else:
                v, bound, g, tile = 0, seg1, 0, tile + 1

    while tile < tiles:
        out.append(prog[g])
        next_step()
        while tile < tiles and prog[g] & 15 in NOT_PRODUCTS:
            next_step()
    return out


@pytest.mark.parametrize("nb,nlz,pre,C,H", [(5, 3, 3, 512, 512), (4, 2, 2, 512, 512),
                                            (3, 0, 1, 512, 512), (2, 1, 1, 512, 512),
                                            (5, 0, 0, 512, 512), (5, 3, 3, 640, 512),
                                            (2, 1, 1, 1024, 512), (5, 3, 3, 512, 256),
                                            (5, 3, 3, 640, 128), (2, 1, 1, 1024, 128),
                                            (5, 3, 3, 512, 64)])
def test_looped_data_program_walks_the_flat_program(nb, nlz, pre, C, H):
    """At NS 2-64 the stored program (data_steps long), walked as the kernel
    walks it, is the flat program step for step, views included; thread 0's
    feed walks the flat program's products over two tiles (their weights:
    piece_gemm_of reads no view).  At NS = 1 the stored program is the
    one-view program itself.  A latent past 512 columns walks two pieces an
    injection in the recompute, and the walk back takes one step per H
    columns of dz (dz_pieces: 5 at C = 640 and d_hidden 128)."""
    pieces, dz_steps = rf.latent_pieces(C), rv.dz_pieces(C, H)
    one = _stored_program(nb, nlz, False, nb, pieces, dz_steps)
    assert one == [s for s, _ in _flat_program(nb, nlz, 1, nb, pieces, dz_steps)]
    assert len(one) == rv.data_steps(nb, nlz, 1, nb, C, H)
    prog = _stored_program(nb, nlz, True, pre, pieces, dz_steps)
    assert len(prog) == rv.data_steps(nb, nlz, 2, pre, C, H)
    for NS in range(2, 65):
        flat = _flat_program(nb, nlz, NS, pre, pieces, dz_steps)
        assert _body_walk(prog, NS) == flat
        products = [s for s, _ in flat if s & 15 not in NOT_PRODUCTS]
        assert _feeder_walk(prog, NS, 2) == products * 2


def test_check_data_widths_takes_any_latent_width_without_a_latent():
    rv.check_data_widths(128, 512, 96, 0, 2, 1, LIMITS)
    rv.check_data_widths(16, 512, 512, 3, 5, 4, LIMITS)
    rv.check_data_widths(48, 512, 24, 0, 5, 4, LIMITS)


@pytest.mark.parametrize("H", [512, 384, 256, 128, 64])
@pytest.mark.parametrize("C", [16, 128, 512, 528, 640, 1024, 832, 1856, 3904, 4096])
def test_check_data_widths_takes_the_forwards_latent_widths(C, H):
    """With a latent, C a multiple of 16 up to the forward's 4096: the
    ConvEncoder's 128 (one piece of K = 128), sn64's 512, the global
    encoder's 640 (two pieces), ResNet50's 832, 1856 and 3904 (2, 4 and 8
    pieces), the widest; at sn64's depth the program fits at every tower
    width (at d_hidden 128 and C = 1024, 8 dz steps an injection; 16 at
    d_hidden 64, 61 at 64 and C = 3904: 235 steps of 512, 64 at 4096)."""
    rv.check_data_widths(48, H, C, 3, 5, 4, LIMITS_AT[H])
    for NS, pre in ((1, 5), (3, 3), (255, 3)):
        rv.check_data_program(5, 3, NS, pre, LIMITS_AT[H], C)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H", [512, 384, 256, 128, 64])
@pytest.mark.parametrize("NS,B_obj", [(1, 1000), (1, 1008), (3, 333)])
def test_data_kernel_matches_plain_on_card(cuda_device, NS, B_obj, H):
    """sn64 widths (and the narrower towers' d_hidden 384, 256, 128 and 64, a
    library each), ragged B (B = 2000, 2016 and 666: B_pad an odd multiple
    of 32 each): the kernel's stashed operands against the plain recompute
    (relu-mask flips <= 1e-3) and to the bar of tests/test_pallas.py; its
    cotangent planes, dz, dx and rows, which an independent recompute's mask
    flips move locally, at corr > 0.999; bit-identical on a second call."""
    nb, cl, sb = 5, 3, 2
    _, x, z, _, _, _, _, _, kw = _setup(NS, sb, B_obj, 42, 512, H, nb, cl)
    port = ResnetFC(d_in=42, d_out=4, n_blocks=nb, d_latent=512, d_hidden=H, combine_layer=cl,
                    impl="cuda").to(cuda_device)
    tw = port.tower(cuda_device)
    x = torch.from_numpy(x).to(cuda_device)
    z = torch.from_numpy(z).to(cuda_device).to(torch.bfloat16)
    B = sb * B_obj
    g = torch.randn(4, B, device=cuda_device)
    before = rv.LAUNCHES["resnetfc_bwd_data"]
    data = rv.bwd_data(g, z, x, tw, nb, True, **kw)
    torch.cuda.synchronize()
    assert rv.LAUNCHES["resnetfc_bwd_data"] == before + 1
    ops_p = rv.forward_operands(z, x, tw, nb, torch.bfloat16, **kw)
    ops_k = data.ws_act[:, :B].float()
    assert ((ops_k > 0) != (ops_p > 0)).float().mean().item() <= 1e-3
    ref = rv.workspace_reference(g, z, x, tw, nb, need_dx=True, **kw)
    for name in ("ws_act", "ws_cot", "ws_x", "ws_z", "dz", "dx", "rows"):
        out, r = getattr(data, name).float(), getattr(ref, name).float()
        assert out.shape == r.shape, name
        assert (out - r).abs().max().item() <= 0.015 * max(1.0, r.abs().max().item()) or name in (
            "ws_cot", "dz", "dx", "rows"), name
        assert torch.corrcoef(torch.stack([out.flatten(), r.flatten()]))[0, 1] > 0.999, name
    again = rv.bwd_data(g, z, x, tw, nb, True, **kw)
    assert all(torch.equal(getattr(data, n), getattr(again, n))
               for n in ("ws_act", "ws_cot", "ws_x", "dz", "dx", "rows"))
