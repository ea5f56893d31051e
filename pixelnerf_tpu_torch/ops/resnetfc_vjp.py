"""Differentiable ResnetFC: the forward kernels plus a hand-written backward
for Hopper.

Counterpart of ``pixelnerf_tpu/ops/resnetfc_vjp.py``, for one view and for
NS > 1 views (object-major rows, as in :mod:`.resnetfc_fused`):

* :class:`ResnetFCFunction` is the ``torch.autograd.Function`` of the dense
  kernel route (the counterpart of ``_core`` / ``resnetfc_pallas_diff``).  Its
  inputs are the latent ``z``, the code ``x`` and the ResnetFC parameters
  themselves; ``forward`` launches ``resnetfc_fwd_dense`` (NS > 1:
  ``resnetfc_fwd_dense_mv``), ``backward`` launches the backward kernels, and
  it saves only its inputs.
* :func:`resnetfc_bwd_reference` is the plain backward: a step-by-step
  transcription of the TPU ``_bwd_kernel`` (recompute, then dz, dx, dW, db),
  not autograd.  With ``compute_dtype=torch.bfloat16`` it rounds where the
  kernel rounds; in float32 it is the counterpart of the Pallas kernels'
  interpret mode.
* :func:`bwd_data` and :func:`bwd_weights` launch ``resnetfc_bwd_data`` and
  ``resnetfc_bwd_weights`` from ``csrc/resnetfc_bwd.cu`` (which notes what
  bounds them); :func:`resnetfc_bwd` runs both, or the plain backward for CPU
  tensors.  On a CUDA tensor they launch or raise; there is no fallback.

Weight gradients are cast to the packed weights' dtype (bf16 on the card), as
the TPU kernel casts them, so that both packages take the same step.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from . import resnetfc_fused as rf

LAUNCHES = {"resnetfc_bwd_data": 0, "resnetfc_bwd_weights": 0}
_LIB: Optional[ctypes.CDLL] = None
# points per split of the weight-gradient products' point axis, and at most
# this many splits (f32 partials summed in split order)
SPLIT_POINTS = 4096
MAX_SPLITS = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Grads(NamedTuple):
    """Gradients in the packed layouts of :class:`~.resnetfc_fused.Tower`."""

    dz: Optional[torch.Tensor]  # (NS * B, C) f32 in z's rows, None without a latent
    dx: Optional[torch.Tensor]  # (NS * B, d_in) f32, None when not asked for
    w_in: torch.Tensor  # (kin, H), the packed weight dtype
    b_in: torch.Tensor  # (H,) f32
    w_z: torch.Tensor  # (n_lin_z, C, H)
    b_z: torch.Tensor  # (n_lin_z, H)
    w_blk: torch.Tensor  # (n_blocks, 2, H, H)
    b_blk: torch.Tensor  # (n_blocks, 2, H)
    w_out: torch.Tensor  # (H, d_out)
    b_out: torch.Tensor  # (d_out,)


# ----------------------------------------------------------------------------
# plain backward
# ----------------------------------------------------------------------------


def split_views(a: torch.Tensor, NS: int, sb: int):
    """Object-major rows ``(sb * NS * B_obj, D)`` -> NS views of
    ``(sb * B_obj, D)``, rows in output-column order."""
    if NS == 1:
        return [a]
    a4 = a.reshape(sb, NS, -1, a.shape[-1])
    return [a4[:, v].reshape(-1, a.shape[-1]) for v in range(NS)]


def join_views(parts, sb: int) -> torch.Tensor:
    """The inverse of :func:`split_views`."""
    if len(parts) == 1:
        return parts[0]
    D = parts[0].shape[-1]
    return torch.stack([t.reshape(sb, -1, D) for t in parts], dim=1).reshape(-1, D)


def forward_operands(z: Optional[torch.Tensor], x: torch.Tensor, tower: rf.Tower, n_blocks: int,
                     compute_dtype=torch.float32, NS: int = 1, sb: int = 1,
                     combine_layer: Optional[int] = None) -> torch.Tensor:
    """The plain forward's product operands, as the backward recomputes them,
    in the backward kernel's workspace order: ``(2 NP + 1, B, H)`` f32 holding
    r_k = relu(x) entering fc_0 and s_k = relu(fc_0) entering fc_1 of every
    block -- for a block below the view mean, r_k of views 0..NS-1 and then
    their s_k -- then t = relu(x) entering lin_out, each rounded to
    ``compute_dtype`` (NP = NS * pre + n_blocks - pre; n_blocks when NS == 1)."""

    def rnd(t):
        return t.to(compute_dtype).float()

    n_lin_z = tower.w_z.shape[0]
    pre = rf.blocks_per_view(n_blocks, NS, combine_layer)
    w_blk, w_z = rnd(tower.w_blk.float()), rnd(tower.w_z.float())
    w_in = rnd(tower.w_in[: tower.d_in].float())
    zs = split_views(rnd(z.float()), NS, sb) if n_lin_z > 0 else None
    hs = [xv @ w_in + tower.b_in for xv in split_views(rnd(x.float()), NS, sb)]

    def block(k, h, zc):
        if k < n_lin_z:
            h = h + (zc @ w_z[k] + tower.b_z[k])
        r = rnd(torch.relu(h))
        s = rnd(torch.relu(r @ w_blk[k, 0] + tower.b_blk[k, 0]))
        return h + (s @ w_blk[k, 1] + tower.b_blk[k, 1]), r, s

    ops = []
    for k in range(pre):
        rs = [block(k, hs[v], zs[v] if zs else None) for v in range(NS)]
        hs = [h for h, _, _ in rs]
        ops += [r for _, r, _ in rs] + [s for _, _, s in rs]
    h = hs[0] if NS == 1 else rf.view_mean(join_views(hs, sb), NS, sb)
    for k in range(pre, n_blocks):
        h, r, s = block(k, h, None)
        ops += [r, s]
    return torch.stack(ops + [rnd(torch.relu(h))])


def resnetfc_bwd_reference(g: torch.Tensor, z: Optional[torch.Tensor], x: torch.Tensor,
                           tower: rf.Tower, n_blocks: int, need_dx: bool = True,
                           compute_dtype=torch.float32,
                           operands: Optional[torch.Tensor] = None, NS: int = 1, sb: int = 1,
                           combine_layer: Optional[int] = None) -> Grads:
    """Plain backward of the tower for the planar cotangent ``g (d_out, B)``:
    recompute the forward (:func:`forward_operands`), then walk it back as
    ``_bwd_kernel`` does: the blocks above the view mean once, then each view
    from ``dview = dxc * (1 / NS)`` through its own operands.  Every result
    is f32 (weight gradients not yet cast).

    :param operands: the forward operands to walk back through instead of the
        recompute, e.g. those the backward kernel stashed: two independent
        recomputes sum in different orders, so a few relu masks in a million
        differ between them, and each such flip moves one cotangent element
        by its full size
    """

    def rnd(t):
        return t.to(compute_dtype).float()

    n_lin_z = tower.w_z.shape[0]
    d_in = tower.d_in
    pre = rf.blocks_per_view(n_blocks, NS, combine_layer)
    W = lambda t: rnd(t.float())  # noqa: E731
    w_in = W(tower.w_in[:d_in])
    w_blk = W(tower.w_blk)
    w_z = W(tower.w_z)
    x_ins = split_views(rnd(x.float()), NS, sb)
    zcs = split_views(rnd(z.float()), NS, sb) if n_lin_z > 0 else None
    if operands is None:
        operands = forward_operands(z, x, tower, n_blocks, compute_dtype, NS, sb, combine_layer)
    below = [(operands[2 * NS * k: 2 * NS * k + NS], operands[2 * NS * k + NS: 2 * NS * (k + 1)])
             for k in range(pre)]  # per block: r of each view, s of each view
    above = {k: (operands[2 * NS * pre + 2 * (k - pre)], operands[2 * NS * pre + 2 * (k - pre) + 1])
             for k in range(pre, n_blocks)}
    t = operands[-1]

    # ---- backward ----
    gT = g.t().float()
    gt = rnd(gT)
    dw_out = t.t() @ gt
    db_out = gT.sum(0)
    dxc = (gt @ W(tower.w_out).t()) * (t > 0)
    dw_blk = torch.zeros(tower.w_blk.shape, device=x.device)
    db_blk = torch.zeros(tower.b_blk.shape, device=x.device)
    dw_z = torch.zeros(tower.w_z.shape, device=x.device)
    db_z = torch.zeros(tower.b_z.shape, device=x.device)
    dw_in = torch.zeros(tower.w_in.shape, device=x.device)
    db_in = torch.zeros(tower.b_in.shape, device=x.device)

    def block_bwd(k, d, r, s):
        gb = rnd(d)
        dw_blk[k, 1] += s.t() @ gb
        db_blk[k, 1] += d.sum(0)
        dh = (gb @ w_blk[k, 1].t()) * (s > 0)
        dht = rnd(dh)
        dw_blk[k, 0] += r.t() @ dht
        db_blk[k, 0] += dh.sum(0)
        return d + (dht @ w_blk[k, 0].t()) * (r > 0)

    for k in reversed(range(pre, n_blocks)):
        dxc = block_bwd(k, dxc, *above[k])
    dview = dxc if NS == 1 else dxc * (1.0 / NS)
    dzs, dxs = [], []
    for v in range(NS):
        dv, dz = dview, None
        for k in reversed(range(pre)):
            dv = block_bwd(k, dv, below[k][0][v], below[k][1][v])
            if k < n_lin_z:
                dvt = rnd(dv)
                dw_z[k] += zcs[v].t() @ dvt
                db_z[k] += dv.sum(0)
                c = dvt @ w_z[k].t()
                dz = c if dz is None else dz + c
        dvt = rnd(dv)
        dw_in[:d_in] += x_ins[v].t() @ dvt
        db_in += dv.sum(0)
        dzs.append(dz)
        dxs.append(dvt @ w_in.t() if need_dx else None)
    dz = None
    if z is not None:
        dz = (join_views(dzs, sb) if dzs[0] is not None
              else torch.zeros(z.shape, device=x.device))
    return Grads(
        dz=dz, dx=join_views(dxs, sb) if need_dx else None, w_in=dw_in, b_in=db_in,
        w_z=dw_z, b_z=db_z, w_blk=dw_blk, b_blk=db_blk, w_out=dw_out, b_out=db_out,
    )


# ----------------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(rf.build("bwd").library))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.resnetfc_bwd_data.argtypes = [P] * 18 + [I] * 12 + [P]
        lib.resnetfc_bwd_data.restype = I
        lib.resnetfc_bwd_weights.argtypes = [P] * 12 + [I] * 10 + [P]
        lib.resnetfc_bwd_weights.restype = I
        lib.resnetfc_bwd_smem_bytes.argtypes = [I, I, I]
        lib.resnetfc_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.resnetfc_bwd_rows.argtypes = [I, I, I]
        lib.resnetfc_bwd_rows.restype = I
        lib.resnetfc_bwd_weight_tiles.argtypes = [I] * 5
        lib.resnetfc_bwd_weight_tiles.restype = I
        lib.resnetfc_bwd_error_string.argtypes = [I]
        lib.resnetfc_bwd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launched(name: str, err: int) -> None:
    if err != 0:
        msg = _lib().resnetfc_bwd_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


class DataOut(NamedTuple):
    """What ``resnetfc_bwd_data`` leaves for ``resnetfc_bwd_weights``.  NP is
    the number of planes of one kind over all blocks: NS * pre + n_blocks -
    pre, with pre the blocks below the view mean (n_blocks when NS == 1)."""

    dz: Optional[torch.Tensor]  # (NS * B_pad, C) f32, view v's rows at v * B_pad
    dx: Optional[torch.Tensor]  # (NS * B, d_in) f32 in x's rows
    ws_act: torch.Tensor  # (2 NP + 1, B_pad, H) bf16: r_k, s_k, t
    ws_cot: torch.Tensor  # (2 NP + NS, B_pad, H) bf16: gb_k, dh_k, g_in
    ws_x: torch.Tensor  # (NS * B_pad, kin) bf16
    ws_z: Optional[torch.Tensor]  # (NS * B_pad, C) bf16, NS > 1 with a latent
    rows: torch.Tensor  # (B_pad / 32, R, H) f32 per-tile column sums
    B: int  # output points, SB * B_obj
    NS: int
    sb: int
    pre: int


def _dims(tower: rf.Tower, n_blocks: int):
    kin, H = tower.w_in.shape
    n_lin_z, C = tower.w_z.shape[0], tower.w_z.shape[1]
    return kin, H, C, n_lin_z, tower.w_out.shape[1]


def bwd_data(g: torch.Tensor, z: Optional[torch.Tensor], x: torch.Tensor, tower: rf.Tower,
             n_blocks: int, need_dx: bool, NS: int = 1, sb: int = 1,
             combine_layer: Optional[int] = None) -> DataOut:
    """Launch ``resnetfc_bwd_data`` for the planar cotangent ``g (d_out, B)``
    (f32), the bf16 latent ``z (NS * B, C)`` (None without injection) and the
    code ``x (NS * B, d_in)`` (f32), rows object-major when NS > 1."""
    rf._tower_args(tower, x, n_blocks, True)  # validates weights, widths and x
    kin, H, C, n_lin_z, d_out = _dims(tower, n_blocks)
    pre = rf.blocks_per_view(n_blocks, NS, combine_layer)
    if NS > 1:
        B, B_obj = rf.mv_shape(x.shape[0], NS, sb, combine_layer, n_blocks)
    else:
        B = B_obj = x.shape[0]
    dev = x.device
    if n_lin_z > 0 and C != rf.HIDDEN:
        raise ValueError(f"the backward kernel needs d_latent {rf.HIDDEN} with a latent (C={C})")
    if kin // 16 > 8 or n_blocks < 1:
        raise ValueError(f"backward kernel widths: kin <= 128 and n_blocks >= 1 (kin={kin})")
    rf._check(g, "g", torch.float32, (d_out, B))
    if n_lin_z > 0:
        rf._check(z, "z", torch.bfloat16, (NS * B, C))
    lib = _lib()
    smem = lib.resnetfc_bwd_smem_bytes(C, kin, n_lin_z)
    if smem > rf.MAX_SMEM_BYTES:
        raise ValueError(f"widths need {smem} B of shared memory per CTA (> {rf.MAX_SMEM_BYTES})")
    B_pad = -(-B // 32) * 32
    NP = NS * pre + n_blocks - pre
    R = lib.resnetfc_bwd_rows(n_blocks, n_lin_z, d_out)
    bf = torch.bfloat16
    out = DataOut(
        dz=torch.empty((NS * B_pad, C), device=dev) if n_lin_z > 0 else None,
        dx=torch.empty((NS * B, tower.d_in), device=dev) if need_dx else None,
        ws_act=torch.empty((2 * NP + 1, B_pad, H), device=dev, dtype=bf),
        ws_cot=torch.empty((2 * NP + NS, B_pad, H), device=dev, dtype=bf),
        ws_x=torch.empty((NS * B_pad, kin), device=dev, dtype=bf),
        ws_z=torch.empty((NS * B_pad, C), device=dev, dtype=bf) if NS > 1 and n_lin_z > 0 else None,
        rows=torch.empty((B_pad // 32, R, H), device=dev),
        B=B, NS=NS, sb=sb, pre=pre,
    )
    if B == 0:
        return out
    slots = rf.view_slots(dev) if NS > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.resnetfc_bwd_data(
        g.data_ptr(), ptr(z) if n_lin_z > 0 else None, x.data_ptr(),
        tower.w_in.data_ptr(), tower.b_in.data_ptr(), tower.w_z.data_ptr(), tower.b_z.data_ptr(),
        tower.w_blk.data_ptr(), tower.b_blk.data_ptr(), tower.w_out.data_ptr(),
        ptr(out.dz), ptr(out.dx), out.ws_act.data_ptr(), out.ws_cot.data_ptr(),
        out.ws_x.data_ptr(), ptr(out.ws_z), out.rows.data_ptr(), ptr(slots),
        B, tower.d_in, kin, H, C, n_blocks, n_lin_z, d_out, NS, B_obj, pre,
        0 if slots is None else slots.shape[0], torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("resnetfc_bwd_data", err)
    return out


def bwd_weights(z: Optional[torch.Tensor], data: DataOut, tower: rf.Tower,
                n_blocks: int) -> Grads:
    """Launch ``resnetfc_bwd_weights`` on what :func:`bwd_data` left: every
    weight gradient (cast to bf16) and the bias gradients (f32)."""
    kin, H, C, n_lin_z, d_out = _dims(tower, n_blocks)
    dev, B, bf = data.ws_x.device, data.B, torch.bfloat16
    NS = data.NS
    B_pad = data.ws_x.shape[0] // NS
    lib = _lib()
    R = lib.resnetfc_bwd_rows(n_blocks, n_lin_z, d_out)
    tiles = lib.resnetfc_bwd_weight_tiles(kin, H, C, n_blocks, n_lin_z)
    splits = max(1, min(MAX_SPLITS, B_pad // SPLIT_POINTS))
    w_in = torch.empty((kin, H), device=dev, dtype=bf)
    w_z = torch.empty((n_lin_z, C, H), device=dev, dtype=bf)
    w_blk = torch.empty((n_blocks, 2, H, H), device=dev, dtype=bf)
    rows_out = torch.empty((R, H), device=dev)
    if B > 0:
        partial = torch.empty((tiles, splits, 128 * 128), device=dev)
        counters = torch.zeros((tiles,), device=dev, dtype=torch.int32)
        err = lib.resnetfc_bwd_weights(
            z.data_ptr() if n_lin_z > 0 else None, data.ws_act.data_ptr(), data.ws_cot.data_ptr(),
            data.ws_x.data_ptr(), None if data.ws_z is None else data.ws_z.data_ptr(),
            data.rows.data_ptr(), w_in.data_ptr(), w_z.data_ptr(), w_blk.data_ptr(),
            rows_out.data_ptr(), partial.data_ptr(), counters.data_ptr(),
            B, kin, H, C, n_blocks, n_lin_z, d_out, NS, data.pre, splits,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _launched("resnetfc_bwd_weights", err)
    else:
        for t in (w_in, w_z, w_blk, rows_out):
            t.zero_()
    r_out = 1 + n_lin_z + 2 * n_blocks
    dz = None
    if data.dz is not None:
        # tile order, view-major -> z's object-major rows
        dz = data.dz[:B] if NS == 1 else join_views(
            list(data.dz.reshape(NS, B_pad, C)[:, :B]), data.sb)
    return Grads(
        dz=dz, dx=data.dx, w_in=w_in, b_in=rows_out[0], w_z=w_z,
        b_z=rows_out[1 : 1 + n_lin_z], b_blk=rows_out[1 + n_lin_z : r_out].reshape(n_blocks, 2, H),
        w_blk=w_blk, w_out=rows_out[r_out + 1 : r_out + 1 + d_out].t().to(bf).contiguous(),
        b_out=rows_out[r_out, :d_out],
    )


def resnetfc_bwd(g: torch.Tensor, z: Optional[torch.Tensor], x: torch.Tensor, tower: rf.Tower,
                 n_blocks: int, need_dx: bool = True, NS: int = 1, sb: int = 1,
                 combine_layer: Optional[int] = None) -> Grads:
    """The tower's backward for the planar cotangent ``g (d_out, B)``: the two
    kernels on CUDA tensors, the plain f32 backward on CPU tensors."""
    if x.device.type == "cpu":
        return resnetfc_bwd_reference(g, z, x, tower, n_blocks, need_dx, NS=NS, sb=sb,
                                      combine_layer=combine_layer)
    data = bwd_data(g, z, x, tower, n_blocks, need_dx, NS, sb, combine_layer)
    gr = bwd_weights(z, data, tower, n_blocks)
    if z is not None and gr.dz is None:
        gr = gr._replace(dz=torch.zeros(z.shape, device=z.device))
    return gr


# ----------------------------------------------------------------------------
# the autograd Function
# ----------------------------------------------------------------------------


def param_names(d_in: int, n_lin_z: int, n_blocks: int) -> Sequence[str]:
    """The ResnetFC parameters the Function takes, in its argument order."""
    names = ["lin_in.weight", "lin_in.bias"] if d_in > 0 else []
    for k in range(n_lin_z):
        names += [f"lin_z.{k}.weight", f"lin_z.{k}.bias"]
    for k in range(n_blocks):
        names += [f"blocks.{k}.fc_{i}.{p}" for i in (0, 1) for p in ("weight", "bias")]
    return names + ["lin_out.weight", "lin_out.bias"]


class ResnetFCFunction(torch.autograd.Function):
    """``(z, x, *params) -> (d_out, B)`` planar (or ``(B, d_out)``) tower
    output through the kernels; ``params`` in :func:`param_names` order,
    ``tower`` the same parameters packed for the kernels (``ResnetFC.tower``)
    and ``cfg = (d_in, n_blocks, n_lin_z, planar_out, NS, sb,
    combine_layer)``.  Saves only its inputs and recomputes in the
    backward."""

    @staticmethod
    def forward(ctx, tower: rf.Tower, cfg: tuple, z, x, *params):
        _, n_blocks, _, planar_out, NS, sb, combine_layer = cfg
        ctx.tower, ctx.cfg = tower, cfg
        ctx.save_for_backward(z, x, *params)
        if NS > 1:
            return rf.resnetfc_dense_mv(z, x, tower, n_blocks, NS, combine_layer, sb, planar_out)
        return rf.resnetfc_dense(z, x, tower, n_blocks, planar_out)

    @staticmethod
    def backward(ctx, gout):
        d_in, n_blocks, n_lin_z, planar_out, NS, sb, combine_layer = ctx.cfg
        z, x, *params = ctx.saved_tensors
        tower = ctx.tower
        g = (gout if planar_out else gout.t()).float().contiguous()
        gr = resnetfc_bwd(g, z, x, tower, n_blocks, need_dx=ctx.needs_input_grad[3], NS=NS,
                          sb=sb, combine_layer=combine_layer)
        wdt = tower.w_in.dtype  # the packed weights' dtype: bf16 on the card
        grads = []
        if d_in > 0:
            grads += [gr.w_in[:d_in].to(wdt).t(), gr.b_in]
        for k in range(n_lin_z):
            grads += [gr.w_z[k].to(wdt).t(), gr.b_z[k]]
        for k in range(n_blocks):
            for i in (0, 1):
                grads += [gr.w_blk[k, i].to(wdt).t(), gr.b_blk[k, i]]
        grads += [gr.w_out.to(wdt).t(), gr.b_out]
        grads = [d.to(p.dtype) for d, p in zip(grads, params)]
        dz = gr.dz.to(z.dtype) if z is not None and ctx.needs_input_grad[2] else None
        dx = gr.dx.to(wdt).to(x.dtype) if gr.dx is not None else None
        return (None, None, dz, dx, *grads)
