"""The train route past a 128-wide code and 6 blocks, on the CPU.

The backward kernels take what the forward kernels take: a code of up to
512 columns (kin, a multiple of 16; the data kernel's code tile is the
forward's 64 x 512 operand tile, its dx a dot product a thread, and the
weights kernel's lin_in product a ragged last M tile past 128 rows), and a
tower as deep as the forward's stored program (62 blocks at sn64's other
widths and one view, 61 at NS views) in the data kernel's program, stored
as 16-bit step words (512 of them, 64 blocks at most); the route rule trains
to the depth the card's gates hold (``GRAD_MAX_BLOCKS``, 32 blocks).

* The port's plain backward (``resnetfc_bwd_reference``: dz, dx and every
  weight and bias gradient; the weights kernel's plain version on the plain
  workspace) and its plain forward against the JAX ``_bwd_kernel`` through
  ``resnetfc_pallas_diff`` in interpret mode, at d_hidden 64 and 12 blocks:
  kin 512 (d_in 500) from one view and kin 144 (d_in 132) from three,
  each JAX run shared by a module fixture; 5e-4 of max(max|ref|, 1e-3), the
  tolerance of ``tests/test_torch_bwd_weights.py``.
* The route rule from the mirrors alone (no library built): kin 144 and 512
  and 7, 16 and 32 blocks train on the kernels from 1 and 3 views; kin 528,
  33, 48 and 62 blocks (past the gated depth, the forward's program at 62 from
  3 views) and a tower past the data kernel's program (d_hidden 64, four
  4096-wide injections) stay plain under ``auto`` and raise under
  ``cuda``.
* The stored program at 62 / 61 blocks for each library at C = 512, by
  hand: its steps, each a 16-bit word.
* A ragged lin_in plan at kin 144 walked in bounds (``check_plan_image`` on
  a table built by hand as the library builds it), and a table that gives
  lin_in's rows past 128 no tile refused.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bwd_weights as bwt
from pixelnerf_tpu.ops.resnetfc_vjp import resnetfc_pallas_diff
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables
from test_torch_bwd_data import Z_BWD, _stored_program

# NS, sb, B_obj, d_in, d_latent, d_hidden, n_blocks, combine_layer
CASES = {"kin512-V1": (1, 1, 70, 500, 64, 64, 12, 3),
         "kin144-V3": (3, 2, 20, 132, 64, 64, 12, 3)}
CUDA = torch.device("cuda")  # compared by type only: nothing is allocated on it


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_run(request):
    """One case's JAX run (the value and every gradient through the TPU
    kernels in interpret mode) beside the port's plain versions."""
    NS, sb, B_obj, d_in, C, H, nb, cl = CASES[request.param]
    params, x, z, cot, tw, Z, X, g, kw = bwt._setup(NS, sb, B_obj, d_in, C, H, nb, cl, seed=1)
    edge = bwt._relu_edge_points(tw, Z, X, nb, NS, sb, cl)
    assert int(edge.sum()) <= max(1, 0.02 * edge.numel())
    cot[0, edge.numpy()] = 0.0  # as tests/test_torch_bwd_weights.py does
    g = torch.from_numpy(cot[0]).t().contiguous()

    def loss(p, z, x):
        out = resnetfc_pallas_diff(p, (z, x), NS=NS, d_latent=C, d_in=d_in, n_blocks=nb,
                                   combine_layer=cl, sb=sb, block_points=128,
                                   bwd_block_points=128, interpret=True)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(z), jnp.asarray(x))
    g_ref, dz_ref, dx_ref = grads
    ref = {k[len("mlp_coarse."):]: v.numpy() for k, v in from_jax_variables(
        {"params": {"mlp_coarse": jax.tree.map(np.asarray, g_ref)}}).items()}
    ref.update(dz=np.asarray(dz_ref), dx=np.asarray(dx_ref))
    plain = rv.resnetfc_bwd_reference(g, Z, X, tw, nb, True, **kw)
    ws = rv.workspace_reference(g, Z, X, tw, nb, compute_dtype=torch.float32, **kw)
    value = rf.resnetfc_reference(Z, X, tw, nb, False, NS=NS, sb=sb, combine_layer=cl)
    return dict(ref=ref, out=np.asarray(out).reshape(-1, 4), plain=plain, value=value,
                weights=rv.bwd_weights_reference(Z, ws, tw, nb), tw=tw, nb=nb, d_in=d_in, H=H)


def _named(gr, d_in, H, nb):
    """The gradients by the module's parameter names."""
    got = {"lin_in.weight": gr.w_in[:d_in, :H].t(), "lin_in.bias": gr.b_in[:H],
           "lin_out.weight": gr.w_out[:H].t(), "lin_out.bias": gr.b_out}
    for k in range(gr.w_z.shape[0]):
        got[f"lin_z.{k}.weight"] = gr.w_z[k, :, :H].t()
        got[f"lin_z.{k}.bias"] = gr.b_z[k, :H]
    for k in range(nb):
        for i in (0, 1):
            got[f"blocks.{k}.fc_{i}.weight"] = gr.w_blk[k, i, :H, :H].t()
            got[f"blocks.{k}.fc_{i}.bias"] = gr.b_blk[k, i, :H]
    return got


def _close(got, ref, what):
    a, b = np.asarray(ref), got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, atol=5e-4 * max(np.abs(a).max(), 1e-3), err_msg=what)


def test_value_matches_jax(jax_run):
    """The tower's output through the dense forward's plain version."""
    _close(jax_run["value"], jax_run["out"], "value")


def test_plain_backward_matches_jax_bwd_kernel(jax_run):
    """dz, dx (500 and 132 columns) and every weight and bias gradient of
    the plain backward."""
    r = jax_run
    got = dict(_named(r["plain"], r["d_in"], r["H"], r["nb"]), dz=r["plain"].dz, dx=r["plain"].dx)
    assert sorted(got) == sorted(r["ref"])
    for k, v in got.items():
        _close(v, r["ref"][k], k)


def test_weights_kernels_plain_version_matches_jax_bwd_kernel(jax_run):
    """The weights kernel's plain version on the plain workspace: lin_in's
    product of M = kin (512 or 144 rows) among them."""
    r = jax_run
    got = _named(r["weights"], r["d_in"], r["H"], r["nb"])
    assert r["tw"].w_in.shape[0] in (144, 512)
    for k, v in got.items():
        _close(v, r["ref"][k], k)


def _tower(**kw):
    args = dict(d_in=42, d_out=4, n_blocks=5, d_latent=512, d_hidden=512, combine_layer=3,
                impl="auto")
    args.update(kw)
    with torch.device("meta"):
        return ResnetFC(**args)


@pytest.mark.parametrize("kw", [dict(d_in=132), dict(d_in=500), dict(d_in=144, n_blocks=8),
                                dict(n_blocks=7), dict(n_blocks=16), dict(n_blocks=32),
                                dict(n_blocks=32, d_hidden=192),
                                dict(n_blocks=32, d_hidden=64, d_in=500)])
def test_route_trains_wide_codes_and_deep_towers_on_the_kernels(kw):
    """Under ``auto`` on a CUDA device, forward and under grad, from 1 and 3
    views.  No library is built or loaded."""
    assert rv.GRAD_MAX_BLOCKS == 32
    t = _tower(**kw)
    for NS in (1, 3):
        assert t._kernel_route((NS, 64), CUDA, False) and t._kernel_route((NS, 64), CUDA, True)
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("kw,NS,match", [
    (dict(d_in=520), 1, "kin"),  # kin 528: past the operand tile, forward and backward
    (dict(n_blocks=33), 1, "to 32 blocks"),  # one block past the gated depth
    (dict(n_blocks=48), 3, "to 32 blocks"),  # past the gated depth (its step drifts)
    (dict(n_blocks=62), 1, "to 32 blocks"),  # the forward's deepest, past the gated depth
    (dict(n_blocks=62), 3, "steps"),  # at NS views the forward stores 61
    # the data kernel's program: 64 walk-back steps an injection of a 4096-wide
    # latent at d_hidden 64, four injections: 516 steps of 512 at 45 blocks
    (dict(d_latent=4096, d_hidden=64, combine_layer=4, n_blocks=45), 1, "512 steps"),
])
def test_route_keeps_towers_past_the_envelope_plain_under_grad(kw, NS, match):
    t = _tower(**kw)
    assert t._kernel_route((NS, 64), CUDA, True) is False
    t.impl = "cuda"
    with pytest.raises(ValueError, match=match):
        t._kernel_route((NS, 64), CUDA, True)
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("H", rf.BWD_HIDDEN)
def test_stored_program_at_the_forwards_depth_in_16_bit_steps(H):
    """At C = 512, 62 blocks from one view and 61 from NS views: 316 steps
    and 3 walk-back steps a dz piece (1 at 512, 2 at 256-384, 3 at 192, 4 at
    128, 8 at 64) -- each a 16-bit word (kind, k < 64, aux < 64), 1 KB at
    most."""
    dz = {512: 1, 384: 2, 320: 2, 256: 2, 192: 3, 128: 4, 64: 8}[H]
    lim = rv.DATA_LIMITS[H]
    assert (lim.max_steps, lim.max_blocks, lim.max_k) == (512, 64, 512)
    for nb, NS, pre, want in ((62, 1, 62, 316 + 3 * dz), (61, 3, 3, 313 + 3 * dz)):
        prog = _stored_program(nb, 3, NS > 1, pre, 1, rv.dz_pieces(512, H))
        assert len(prog) == rv.data_steps(nb, 3, NS, pre, 512, H) == want <= lim.max_steps
        assert all(0 <= s < 1 << 16 and (s >> 4) & 63 < nb and s >> 10 < 64 for s in prog)
        assert sorted({s >> 10 for s in prog if s & 15 == Z_BWD}) == list(range(dz))
        rv.check_data_program(nb, 3, NS, pre, lim, 512)


def _hand_built_params(plan, lim, lin_in_tiles=None):
    """The bytes ``resnetfc_bwd_weights_plan`` writes for ``plan`` on a
    library of limits ``lim``, built by hand: the head (split_cta0, n_tasks,
    n_splits, N, pts, tiles, units) at 0, and 4 KB on the table, its tensor
    maps (left zero: the walker reads none) and then a ``_TaskImage`` a task
    (its M tiles, first output tile and first f32 partial); lin_in's task
    row given ``lin_in_tiles`` M tiles where set.  Returns (bytes, offset and
    size of the table)."""
    H = plan.key[1]
    ntn, tasks, tiles, units, n_splits = H // lim.tile_n, [], 0, 0, 0
    for k in range(len(plan.table) // 6):
        a, g, M, P, sp, out = plan.table[6 * k : 6 * k + 6]
        m_tiles = -(-M // lim.tile_m)
        tasks.append(rv._TaskImage(out, a, g, M, P, sp, m_tiles, tiles, units))
        tiles += m_tiles * ntn
        units += m_tiles * ntn * sp if sp > 1 else 0
        n_splits = max(n_splits, sp)
    split_cta0, ctas = [], 0
    for s in range(n_splits + 1):
        split_cta0.append(ctas)
        ctas += sum(T.m_tiles * ntn for T in tasks if T.splits > s)
    if lin_in_tiles is not None:
        tasks[0].m_tiles = lin_in_tiles

    class Head(ctypes.Structure):
        _fields_ = [("table", ctypes.c_void_p),
                    ("split_cta0", ctypes.c_int * (lim.max_splits + 1))] + [
            (n, ctypes.c_int) for n in ("n_tasks", "n_splits", "N", "pts", "tiles", "units")]

    off, t_size = 4096, ctypes.sizeof(rv._TaskImage)
    size = 128 * lim.max_maps + t_size * lim.max_tasks
    raw = ctypes.create_string_buffer(off + size)
    head = Head.from_buffer(raw)
    head.split_cta0[: n_splits + 1] = split_cta0
    head.n_tasks, head.n_splits, head.N, head.pts = len(tasks), n_splits, H, plan.pts
    head.tiles, head.units = tiles, units
    for k, T in enumerate(tasks):
        ctypes.memmove(ctypes.addressof(raw) + off + 128 * lim.max_maps + k * t_size,
                       ctypes.addressof(T), t_size)
    return raw, off, size


def test_ragged_lin_in_plan_walks_in_bounds(monkeypatch):
    """kin 144: lin_in's product of M = 144 takes two 128-row tiles, the
    second holding rows 128-143 only.  ``check_plan_image`` walks the plan
    over a table built by hand as the library builds it, in bounds, at one
    view and at three, at sn64's width and at 62 blocks; a table that gives
    lin_in one M tile (rows 128-143 in none) is refused."""
    lim = rv.WEIGHT_LIMITS[512]
    for NS, nb, B in ((1, 5, 1000), (3, 5, 333), (1, 62, 100)):
        pre = nb if NS == 1 else 3
        B_pad, NP = -(-B // 32) * 32, NS * pre + nb - pre
        data = rv.DataOut(
            dz=None, dx=None, ws_act=torch.empty((2 * NP + 1, B_pad, 512), dtype=torch.bfloat16),
            ws_cot=torch.empty((2 * NP + NS, B_pad, 512), dtype=torch.bfloat16),
            ws_x=torch.empty((NS * B_pad, 144), dtype=torch.bfloat16),
            ws_z=torch.empty((NS * B_pad, 512), dtype=torch.bfloat16) if NS > 1 else None,
            rows=torch.empty((B_pad // 32, 1, 512)), B=B, NS=NS, sb=1, pre=pre)
        z = torch.empty((NS * B, 512), dtype=torch.bfloat16)
        plan = rv.weight_plan(144, 512, 512, nb, 3, NS, pre, B, lim, 132)
        assert plan.table[2] == 144  # lin_in's M
        for lin_in_tiles in (None, 1):
            raw, off, size = _hand_built_params(plan, lim, lin_in_tiles)
            monkeypatch.setattr(rv, "_launch_params", lambda *a, raw=raw: (raw, None, None))
            monkeypatch.setattr(rv, "_limits_and_bytes",
                                lambda H, n=off + size, t=(off, size): (lim, n, t))
            if lin_in_tiles is None:
                walked = rv.check_plan_image(plan, z, data)
                assert walked["tasks"] == 2 * nb + 4
                assert walked["ctas"] == sum(
                    -(-M // 128) * (512 // lim.tile_n) * sp
                    for M, sp in zip(plan.table[2::6], plan.table[4::6]))
            else:
                with pytest.raises(ValueError, match="task 0 reads past its maps"):
                    rv.check_plan_image(plan, z, data)
    assert not rv._LIBS
