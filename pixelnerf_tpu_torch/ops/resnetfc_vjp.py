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
* :func:`weight_tasks` is the weights kernel's table of products (which
  planes, how many points), :func:`bwd_weights_reference` its plain version
  on a :class:`DataOut`, and :func:`workspace_reference` the DataOut that
  the data kernel leaves, in plain form, so that the weights kernel's plain
  version runs without a card.

Weight gradients are cast to the packed weights' dtype (bf16 on the card), as
the TPU kernel casts them, so that both packages take the same step.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from . import resnetfc_fused as rf

LAUNCHES = {"resnetfc_bwd_data": 0, "resnetfc_bwd_weights": 0}
_LIB: Optional[ctypes.CDLL] = None
# launch parameters of the weights kernel kept per operand addresses, newest last
_PARAMS: "collections.OrderedDict[tuple, ctypes.Array]" = collections.OrderedDict()
MAX_KEPT_PARAMS = 16


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
                           combine_layer: Optional[int] = None,
                           record: Optional[dict] = None) -> Grads:
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
    :param record: when given, filled with the f32 cotangents the backward
        kernel stashes (rounded) for the weight products: ``("gb", k, v)`` at
        block k's output, ``("dh", k, v)`` after its fc_1, ``("in", v)`` at
        lin_in's output (v = 0 above the view mean)
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

    def block_bwd(k, v, d, r, s):
        gb = rnd(d)
        dw_blk[k, 1] += s.t() @ gb
        db_blk[k, 1] += d.sum(0)
        dh = (gb @ w_blk[k, 1].t()) * (s > 0)
        if record is not None:
            record["gb", k, v], record["dh", k, v] = d, dh
        dht = rnd(dh)
        dw_blk[k, 0] += r.t() @ dht
        db_blk[k, 0] += dh.sum(0)
        return d + (dht @ w_blk[k, 0].t()) * (r > 0)

    for k in reversed(range(pre, n_blocks)):
        dxc = block_bwd(k, 0, dxc, *above[k])
    dview = dxc if NS == 1 else dxc * (1.0 / NS)
    dzs, dxs = [], []
    for v in range(NS):
        dv, dz = dview, None
        for k in reversed(range(pre)):
            dv = block_bwd(k, v, dv, below[k][0][v], below[k][1][v])
            if k < n_lin_z:
                dvt = rnd(dv)
                dw_z[k] += zcs[v].t() @ dvt
                db_z[k] += dv.sum(0)
                c = dvt @ w_z[k].t()
                dz = c if dz is None else dz + c
        if record is not None:
            record["in", v] = dv
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
        lib.resnetfc_bwd_weights_plan.argtypes = [P, P, P, I, P, I, I, I]
        lib.resnetfc_bwd_weights_plan.restype = I
        lib.resnetfc_bwd_weights.argtypes = [P, P, P, P, I, I, P, P, P]
        lib.resnetfc_bwd_weights.restype = I
        lib.resnetfc_bwd_weights_limits.argtypes = [P]
        lib.resnetfc_bwd_weights_limits.restype = ctypes.c_size_t
        lib.resnetfc_bwd_weights_smem_bytes.argtypes = []
        lib.resnetfc_bwd_weights_smem_bytes.restype = ctypes.c_size_t
        lib.resnetfc_bwd_data_limits.argtypes = [P]
        lib.resnetfc_bwd_data_limits.restype = ctypes.c_size_t
        lib.resnetfc_bwd_rows.argtypes = [I, I, I]
        lib.resnetfc_bwd_rows.restype = I
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


class WTask(NamedTuple):
    """One weight-gradient product ``dW = A^T G`` of ``resnetfc_bwd_weights``
    over the first P points of its operands (A's rows past its own are read
    as zeros)."""

    name: str  # the weight it forms: "lin_in", "lin_z.k" or "blocks.k.fc_i"
    a: str  # A's array in the DataOut: "ws_x", "ws_z", "ws_act", or "z" read in place
    a_plane: int  # first plane of ws_act (0 for the others)
    M: int  # rows of dW: A's columns
    g_plane: int  # first plane of ws_cot
    P: int  # points summed over: NS * B_pad below the view mean, B_pad above it


def weight_tasks(kin: int, H: int, C: int, n_blocks: int, n_lin_z: int, NS: int, pre: int,
                 B: int) -> list:
    """The products of ``resnetfc_bwd_weights`` in launch order: lin_in,
    lin_z_k, then fc_0 and fc_1 of every block.  Block k's planes (r_k, gb_k,
    ...) start at ``plane_of(k)``: NS per block below the view mean (view v at
    +v), one above it; NP = plane_of(n_blocks) planes of one kind in all."""
    if NS == 1:
        pre = n_blocks
    B_pad = -(-B // 32) * 32

    def plane_of(k):
        return NS * k if k < pre else NS * pre + (k - pre)

    NP = plane_of(n_blocks)
    P_views = NS * B_pad
    tasks = [WTask("lin_in", "ws_x", 0, kin, 2 * NP, P_views)]
    for k in range(n_lin_z):
        tasks.append(WTask(f"lin_z.{k}", "z" if NS == 1 else "ws_z", 0, C,
                           2 * NP if k == 0 else plane_of(k - 1), P_views))
    for k in range(n_blocks):
        views, pk = (NS if k < pre else 1), plane_of(k)
        tasks.append(WTask(f"blocks.{k}.fc_0", "ws_act", 2 * pk, H, NP + pk, views * B_pad))
        tasks.append(WTask(f"blocks.{k}.fc_1", "ws_act", 2 * pk + views, H, pk, views * B_pad))
    return tasks


class KernelLimits(NamedTuple):
    """What ``resnetfc_bwd_weights_kernel`` fixes (read from its library by
    :func:`kernel_limits`): its output tile and the most splits, tensor maps
    and tasks of one launch (the maps and tasks travel in its parameters)."""

    tile_m: int  # rows of dW a CTA forms
    tile_n: int  # columns of dW a CTA forms
    max_splits: int
    max_maps: int
    max_tasks: int


# What the library reports (kernel_limits), mirrored for the route rule
# (models/resnetfc.py), which must not build the library; chip_smoke.py and a
# cuda-marked test hold the two equal.
WEIGHT_LIMITS = KernelLimits(tile_m=128, tile_n=256, max_splits=24, max_maps=24, max_tasks=16)


@functools.lru_cache(maxsize=None)
def _limits_and_bytes():
    out = (ctypes.c_int * 5)()
    n = _lib().resnetfc_bwd_weights_limits(out)
    return KernelLimits(*out), n


def kernel_limits() -> KernelLimits:
    return _limits_and_bytes()[0]


def weight_tiles(task: WTask, H: int, limits: KernelLimits) -> int:
    """Output tiles of one product."""
    return -(-task.M // limits.tile_m) * (H // limits.tile_n)


def task_operands(task: WTask, z: Optional[torch.Tensor], data: DataOut):
    """(A, G) of one product as views of the DataOut's planes (and of z)."""
    B_pad = data.ws_x.shape[0] // data.NS
    n = task.P // B_pad
    if task.a == "ws_act":
        a = data.ws_act[task.a_plane : task.a_plane + n].reshape(task.P, -1)
    else:
        a = {"ws_x": data.ws_x, "ws_z": data.ws_z, "z": z}[task.a]
    return a, data.ws_cot[task.g_plane : task.g_plane + n].reshape(task.P, -1)


def split_points(tasks: Sequence[WTask], max_splits: int) -> int:
    """Points per split of every product's point axis: the shortest
    product's points, rounded up to a multiple of 64, times as many as it
    takes for the longest product to fit ``max_splits`` splits.  So a
    product splits by whole views (NS pieces below the view mean, one above
    it, one at NS = 1; at NS > max_splits, ceil(NS / max_splits) views a
    piece): every CTA walks as many points, and a product of one view writes
    its result with no f32 partials.  The kernel is bound by the card's
    memory system, not by its SMs, so fewer splits beat whole waves
    (PERF.md, Findings: the split sweep of chip_smoke.py)."""
    pts = -(-min(t.P for t in tasks) // 64) * 64
    splits = -(-max(t.P for t in tasks) // pts)
    return pts * -(-splits // max_splits)


class WPlan(NamedTuple):
    """The part of a ``resnetfc_bwd_weights`` launch that depends only on
    shapes (:func:`weight_plan`)."""

    key: tuple  # the arguments it was made from
    arrays: tuple  # the operand arrays its maps read, by DataOut name ("z": z in place)
    maps: tuple  # per tensor map: (array index, first row, rows, columns)
    table: tuple  # per task: A map, G map, M, P, splits, first element of its output
    pts: int  # points per split
    tiles: int  # output tiles
    units: int  # f32 partial tiles: (tile, split) of the tasks with splits > 1


@functools.lru_cache(maxsize=64)
def weight_plan(kin: int, H: int, C: int, n_blocks: int, n_lin_z: int, NS: int, pre: int, B: int,
                limits: KernelLimits, pts: Optional[int] = None) -> WPlan:
    """Tensor maps (one per distinct operand plane), task table and splits
    (``pts`` points per split, :func:`split_points` unless given) of the
    weight products at one shape.  Raises ValueError when they do not fit
    the kernel's parameters (``limits``): past 5 blocks at sn64 widths."""
    tasks = weight_tasks(kin, H, C, n_blocks, n_lin_z, NS, pre, B)
    B_pad = -(-B // 32) * 32
    arrays = ("ws_act", "ws_cot", "ws_x") + (("z" if NS == 1 else "ws_z",) if n_lin_z else ())
    width = {"ws_act": H, "ws_cot": H, "ws_x": kin, "ws_z": C, "z": C}
    maps = {}

    def map_of(array, row0, rows):
        return maps.setdefault((arrays.index(array), row0, rows, width[array]), len(maps))

    if pts is None:
        pts = split_points(tasks, limits.max_splits)
    out0 = {"lin_in": 0}
    out0.update({f"lin_z.{k}": kin * H + k * C * H for k in range(n_lin_z)})
    blk0 = kin * H + n_lin_z * C * H
    out0.update({f"blocks.{k}.fc_{i}": blk0 + (2 * k + i) * H * H
                 for k in range(n_blocks) for i in (0, 1)})
    table, tiles, units = [], 0, 0
    for t in tasks:
        if t.a == "ws_act":
            a = map_of("ws_act", t.a_plane * B_pad, t.P)
        else:  # z in place has B rows, the others NS * B_pad
            a = map_of(t.a, 0, B if t.a == "z" else t.P)
        sp = -(-t.P // pts)
        table += [a, map_of("ws_cot", t.g_plane * B_pad, t.P), t.M, t.P, sp, out0[t.name]]
        n = weight_tiles(t, H, limits)
        tiles += n
        units += n * sp if sp > 1 else 0
    if len(maps) > limits.max_maps or len(tasks) > limits.max_tasks:
        raise ValueError(
            f"resnetfc_bwd_weights takes at most {limits.max_maps} tensor maps and "
            f"{limits.max_tasks} products in its 4 KB of kernel parameters; a {n_blocks}-block "
            f"tower at NS = {NS} needs {len(maps)} maps and {len(tasks)} products")
    if -(-max(t.P for t in tasks) // pts) > limits.max_splits:
        raise ValueError(f"{pts} points per split give more than {limits.max_splits} splits")
    key = (kin, H, C, n_blocks, n_lin_z, NS, pre, B, pts)
    return WPlan(key, arrays, tuple(maps), tuple(table), pts, tiles, units)


def _launch_params(plan: WPlan, ptrs: tuple) -> ctypes.Array:
    """The kernel's parameters for ``plan`` on operands at ``ptrs`` (one
    address per ``plan.arrays``): its tensor maps encoded once per such set
    of addresses and kept (the last MAX_KEPT_PARAMS sets)."""
    key = (plan.key, ptrs)
    params = _PARAMS.get(key)
    if params is not None:
        _PARAMS.move_to_end(key)
        return params
    n = len(plan.maps)
    bases = (ctypes.c_void_p * n)(*(ptrs[a] + 2 * row0 * cols for a, row0, _, cols in plan.maps))
    dims = (ctypes.c_int * (3 * n))(*(v for _, _, rows, cols in plan.maps
                                      for v in (rows, cols, cols)))
    params = ctypes.create_string_buffer(_limits_and_bytes()[1])
    err = _lib().resnetfc_bwd_weights_plan(
        params, bases, dims, n, (ctypes.c_int * len(plan.table))(*plan.table),
        len(plan.table) // 6, plan.key[1], plan.pts)
    if err != 0:
        raise RuntimeError(f"resnetfc_bwd_weights plan failed: "
                           f"{_lib().resnetfc_bwd_error_string(err).decode()} ({err})")
    _PARAMS[key] = params
    if len(_PARAMS) > MAX_KEPT_PARAMS:
        _PARAMS.popitem(last=False)
    return params


def bwd_weights_reference(z: Optional[torch.Tensor], data: DataOut, tower: rf.Tower,
                          n_blocks: int) -> Grads:
    """Plain version of ``resnetfc_bwd_weights`` on the same DataOut: per
    task of :func:`weight_tasks`, the f32 product of its planes over its P
    points, and the rows of per-tile sums summed in tile order.  Weight
    gradients stay f32."""
    kin, H, C, n_lin_z, d_out = _dims(tower, n_blocks)
    tasks = weight_tasks(kin, H, C, n_blocks, n_lin_z, data.NS, data.pre, data.B)
    out = {}
    for t in tasks:
        a, g = task_operands(t, z, data)
        out[t.name] = a.float().t() @ g[: a.shape[0]].float()
    rows_out = data.rows[0].clone()
    for i in range(1, data.rows.shape[0]):
        rows_out += data.rows[i]
    w_z = torch.stack([out[f"lin_z.{k}"] for k in range(n_lin_z)]) if n_lin_z else \
        torch.zeros((0, C, H), device=rows_out.device)
    w_blk = torch.stack([torch.stack([out[f"blocks.{k}.fc_{i}"] for i in (0, 1)])
                         for k in range(n_blocks)])
    return _weight_grads(data, out["lin_in"], w_z, w_blk, rows_out, n_blocks, n_lin_z, d_out)


def workspace_reference(g: torch.Tensor, z: Optional[torch.Tensor], x: torch.Tensor,
                        tower: rf.Tower, n_blocks: int, NS: int = 1, sb: int = 1,
                        combine_layer: Optional[int] = None,
                        compute_dtype=torch.bfloat16, need_dx: bool = False) -> DataOut:
    """The DataOut that ``resnetfc_bwd_data`` leaves, in plain form: r_k, s_k
    and t from :func:`forward_operands`, the cotangents gb_k, dh_k and g_in
    of :func:`resnetfc_bwd_reference`, the code and (NS > 1) the latent, each
    rounded to ``compute_dtype`` in ``(planes, B_pad, width)`` tile order, and
    the f32 per-32-row-tile column sums (biases, then the d_out rows of
    dW_out^T).  Rows past B are zero; dx is formed only with ``need_dx``.
    The per-32-row sums are the contract whatever tile the kernel walks: its
    64-point tiles write two rows of sums each."""
    kin, H, C, n_lin_z, d_out = _dims(tower, n_blocks)
    pre = rf.blocks_per_view(n_blocks, NS, combine_layer)
    B = g.shape[1]
    B_pad = -(-B // 32) * 32
    n_tiles = B_pad // 32
    dt = compute_dtype

    def pad(t, width=None):  # (B, D) -> (B_pad, width) f32, zero rows and columns
        return torch.nn.functional.pad(t.float(), (0, (width or t.shape[1]) - t.shape[1],
                                                   0, B_pad - t.shape[0]))

    def tile_sums(t):  # (B, D) f32 -> (n_tiles, D)
        return pad(t).reshape(n_tiles, 32, -1).sum(1)

    ops = forward_operands(z, x, tower, n_blocks, dt, NS, sb, combine_layer)
    cot = {}
    gr = resnetfc_bwd_reference(g, z, x, tower, n_blocks, need_dx, dt, operands=ops, NS=NS, sb=sb,
                                combine_layer=combine_layer, record=cot)
    tasks = weight_tasks(kin, H, C, n_blocks, n_lin_z, NS, pre, B)
    NP = tasks[0].g_plane // 2
    planes = [None] * (2 * NP + NS)
    rows = torch.zeros((n_tiles, 2 + n_lin_z + 2 * n_blocks + d_out, H), device=x.device)
    for t in tasks[1 + n_lin_z :: 2]:  # fc_0 of every block: gb_k at g_plane - NP, dh_k at g_plane
        k = int(t.name.split(".")[1])
        for v in range(t.P // B_pad):
            planes[t.g_plane - NP + v], planes[t.g_plane + v] = cot["gb", k, v], cot["dh", k, v]
            s_gb = tile_sums(cot["gb", k, v])
            rows[:, 1 + n_lin_z + 2 * k + 1] += s_gb
            if k + 1 < n_lin_z:
                rows[:, 2 + k] += s_gb
            rows[:, 1 + n_lin_z + 2 * k] += tile_sums(cot["dh", k, v])
    for v in range(NS):
        planes[2 * NP + v] = cot["in", v]
        s_in = tile_sums(cot["in", v])
        rows[:, 0] += s_in
        if n_lin_z > 0:
            rows[:, 1] += s_in
    gT = g.t().float()
    r_out = 1 + n_lin_z + 2 * n_blocks
    rows[:, r_out, :d_out] = tile_sums(gT)
    t32 = pad(ops[-1]).reshape(n_tiles, 32, H)
    rows[:, r_out + 1 :] = torch.einsum("trc,tro->toc", t32,
                                        pad(gT.to(dt)).reshape(n_tiles, 32, d_out))
    dz = None
    if z is not None and n_lin_z > 0:
        dz = torch.cat([pad(d) for d in split_views(gr.dz, NS, sb)])
    return DataOut(
        dz=dz, dx=gr.dx,
        ws_act=torch.stack([pad(o) for o in ops]).to(dt),
        ws_cot=torch.stack([pad(c.to(dt)) for c in planes]).to(dt),
        ws_x=torch.cat([pad(xv.to(dt), kin) for xv in split_views(x, NS, sb)]).to(dt),
        ws_z=(torch.cat([pad(zv.to(dt)) for zv in split_views(z, NS, sb)]).to(dt)
              if NS > 1 and n_lin_z > 0 else None),
        rows=rows, B=B, NS=NS, sb=sb, pre=pre,
    )


class DataLimits(NamedTuple):
    """What ``resnetfc_bwd_data_kernel`` fixes (read from its library by
    :func:`data_limits`)."""

    tile: int  # points a CTA walks at a time (one wgmma M)
    threads: int  # a CTA: two warpgroups (thread 0 also feeds the weight ring)
    slot_floats: int  # f32 words of a CTA's multi-view slot (its 64 x 512 stream and dview)
    stages: int  # weight-ring stages
    max_out: int  # the most outputs of lin_out
    max_steps: int  # the most steps of one tile's stored program (one view's segments)
    smem: int  # dynamic shared memory a CTA


# What the library reports (data_limits), mirrored as WEIGHT_LIMITS is.
DATA_LIMITS = DataLimits(tile=64, threads=256, slot_floats=128 * 256, stages=3, max_out=4,
                         max_steps=256, smem=2 * 65536 + 3 * 32768 + 1024)


@functools.lru_cache(maxsize=None)
def data_limits() -> DataLimits:
    out = (ctypes.c_int * 6)()
    smem = _lib().resnetfc_bwd_data_limits(out)
    return DataLimits(*out, smem)


def data_steps(n_blocks: int, n_lin_z: int, NS: int, pre: int) -> int:
    """Steps of one ``resnetfc_bwd_data`` tile's stored program
    (``data_program`` in ``csrc/resnetfc_bwd.cu``): one view's recompute of
    lin_in, its injections and its blocks (and, NS > 1, the fold into the
    mean), which the tile walks once for each view; the shared blocks,
    lin_out and the shared blocks' walk back (each block's cotangent, fc_1,
    fc_0), once; one view's walk back through its blocks, injections and
    lin_in, walked once for each view (pre = n_blocks when NS == 1).  34 at
    sn64 and one view, 36 at any view count."""
    mv = int(NS > 1)
    shared = n_blocks - pre
    return (1 + n_lin_z + 2 * pre + mv) + 2 * shared + 1 + 3 * shared + (mv + 3 * pre + n_lin_z + 1)


def check_data_program(n_blocks: int, n_lin_z: int, NS: int, pre: int,
                       limits: DataLimits) -> None:
    """Raise ValueError on a view count or a tower whose program
    ``resnetfc_bwd_data`` does not take: more than MAX_VIEWS views (a step's
    view is 8 bits), or a stored program (:func:`data_steps`, the same at
    every view count) past ``limits.max_steps``."""
    if NS > rf.MAX_VIEWS:
        raise ValueError(f"resnetfc_bwd_data takes at most {rf.MAX_VIEWS} views (NS = {NS})")
    steps = data_steps(n_blocks, n_lin_z, NS, pre)
    if steps > limits.max_steps:
        raise ValueError(f"resnetfc_bwd_data stores at most {limits.max_steps} steps a tile; "
                         f"{n_blocks} blocks need {steps}")


def check_data_widths(kin: int, H: int, C: int, n_lin_z: int, n_blocks: int, d_out: int,
                      limits: DataLimits) -> None:
    """Raise ValueError on widths ``resnetfc_bwd_data`` does not take: H and,
    with a latent, C other than 512; kin past 128 or not a multiple of 16; no
    block; more outputs than ``limits.max_out``; a CTA past the card's shared
    memory."""
    if H != rf.HIDDEN or (n_lin_z > 0 and C != rf.HIDDEN):
        raise ValueError(f"the backward kernel needs d_hidden {rf.HIDDEN}, and d_latent "
                         f"{rf.HIDDEN} with a latent (H={H}, C={C})")
    if kin > 128 or kin % 16 or n_blocks < 1:
        raise ValueError(f"backward kernel widths: kin <= 128, a multiple of 16, and n_blocks >= 1 "
                         f"(kin={kin}, n_blocks={n_blocks})")
    if not 1 <= d_out <= limits.max_out:
        raise ValueError(f"the backward kernel takes 1 to {limits.max_out} outputs (d_out={d_out})")
    if limits.smem > rf.MAX_SMEM_BYTES:
        raise ValueError(f"the data kernel needs {limits.smem} B of shared memory per CTA "
                         f"(> {rf.MAX_SMEM_BYTES})")


def data_grid(B: int, NS: int, n_sms: int, limits: DataLimits) -> tuple:
    """(B_pad, tiles, CTAs) of a ``resnetfc_bwd_data`` launch: the workspace's
    rows (B rounded up to 32, the weights kernel's and the per-tile sums'
    unit), the tile-point tiles over them (the last one half full when B_pad
    is an odd multiple of 32), and the grid: a CTA a tile for one view,
    persistent CTAs, one an SM at most, for NS > 1 (each holds a slot)."""
    B_pad = -(-B // 32) * 32
    tiles = -(-B_pad // limits.tile)
    return B_pad, tiles, (tiles if NS == 1 else min(tiles, n_sms))


def data_slots(dev, limits: DataLimits) -> torch.Tensor:
    """The data kernel's multi-view slots, one per SM: each CTA keeps its
    share of the view sum and of dview there (``limits.slot_floats`` f32,
    128 KB at the 64-point tile; not the forward kernels' 64 KB slots)."""
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return torch.empty((n_sms, limits.slot_floats), device=dev)


def bwd_data(g: torch.Tensor, z: Optional[torch.Tensor], x: torch.Tensor, tower: rf.Tower,
             n_blocks: int, need_dx: bool, NS: int = 1, sb: int = 1,
             combine_layer: Optional[int] = None) -> DataOut:
    """Launch ``resnetfc_bwd_data`` for the planar cotangent ``g (d_out, B)``
    (f32), the bf16 latent ``z (NS * B, C)`` (None without injection) and the
    code ``x (NS * B, d_in)`` (f32), rows object-major when NS > 1; all on
    the card (its plain version is :func:`workspace_reference`).  Raises on
    widths the kernel does not take (:func:`check_data_widths`) and on
    weights TMA cannot read in place."""
    rf._tower_args(tower, x, n_blocks, True)  # validates weights, widths and x
    kin, H, C, n_lin_z, d_out = _dims(tower, n_blocks)
    pre = rf.blocks_per_view(n_blocks, NS, combine_layer)
    if NS > 1:
        B, B_obj = rf.mv_shape(x.shape[0], NS, sb, combine_layer, n_blocks)
    else:
        B = B_obj = x.shape[0]
    dev = x.device
    lim = data_limits()
    check_data_widths(kin, H, C, n_lin_z, n_blocks, d_out, lim)
    check_data_program(n_blocks, n_lin_z, NS, pre, lim)
    rf._check(g, "g", torch.float32, (d_out, B))
    if n_lin_z > 0:
        rf._check(z, "z", torch.bfloat16, (NS * B, C))
    for name in ("w_in", "w_z", "w_blk"):  # TMA reads the weights in place
        rf.check_tma(getattr(tower, name), name)
    lib = _lib()
    B_pad, _, _ = data_grid(B, NS, 1, lim)
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
    slots = data_slots(dev, lim) if NS > 1 else None
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
    """Every weight gradient (bf16) and the bias gradients (f32) from what
    :func:`bwd_data` left: ``resnetfc_bwd_weights`` on CUDA tensors,
    :func:`bwd_weights_reference` (weights cast to bf16) on CPU tensors.
    Raises on an array whose planes TMA cannot read in place (not
    contiguous, not 16-byte aligned, rows not a multiple of 16 bytes), and
    on a tower too deep for the kernel (:func:`weight_plan`)."""
    kin, H, C, n_lin_z, d_out = _dims(tower, n_blocks)
    dev, B, NS, bf = data.ws_x.device, data.B, data.NS, torch.bfloat16
    # every product reads whole planes of these arrays (z in place at NS = 1)
    arrays = {"ws_act": data.ws_act, "ws_cot": data.ws_cot, "ws_x": data.ws_x}
    if n_lin_z > 0:
        arrays["z" if NS == 1 else "ws_z"] = z if NS == 1 else data.ws_z
    for name, t in arrays.items():
        rf.check_tma(t, name)
    if not data.rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if dev.type == "cpu":
        ref = bwd_weights_reference(z, data, tower, n_blocks)
        return ref._replace(w_in=ref.w_in.to(bf), w_z=ref.w_z.to(bf), w_blk=ref.w_blk.to(bf),
                            w_out=ref.w_out.to(bf))
    B_pad = data.ws_x.shape[0] // NS
    pre = n_blocks if NS == 1 else data.pre
    NP = NS * pre + n_blocks - pre
    shapes = {"ws_act": (2 * NP + 1, B_pad, H), "ws_cot": (2 * NP + NS, B_pad, H),
              "ws_x": (NS * B_pad, kin), "ws_z": (NS * B_pad, C), "z": (B, C)}
    for name, t in arrays.items():
        rf._check(t, name, bf, shapes[name])
    plan = None if B == 0 else weight_plan(kin, H, C, n_blocks, n_lin_z, NS, data.pre, B,
                                            kernel_limits())
    return _launch_weights(z, data, plan, kin, H, C, n_blocks, n_lin_z, d_out)


def _launch_weights(z: Optional[torch.Tensor], data: DataOut, plan: Optional[WPlan], kin: int,
                    H: int, C: int, n_blocks: int, n_lin_z: int, d_out: int) -> Grads:
    """``resnetfc_bwd_weights`` on checked operands, by ``plan`` (None: no
    points, every gradient zero)."""
    dev, bf = data.ws_x.device, torch.bfloat16
    lib = _lib()
    R = lib.resnetfc_bwd_rows(n_blocks, n_lin_z, d_out)
    # one buffer for every weight gradient, in the plan's order
    n_in, n_z = kin * H, n_lin_z * C * H
    out = torch.empty((n_in + n_z + 2 * n_blocks * H * H,), device=dev, dtype=bf)
    w_in = out[:n_in].view(kin, H)
    w_z = out[n_in : n_in + n_z].view(n_lin_z, C, H)
    w_blk = out[n_in + n_z :].view(n_blocks, 2, H, H)
    rows_out = torch.empty((R, H), device=dev)
    if plan is not None:
        ptrs = tuple((z if a == "z" else getattr(data, a)).data_ptr() for a in plan.arrays)
        params = _launch_params(plan, ptrs)
        lim = kernel_limits()
        partial = (torch.empty((plan.units, lim.tile_m * lim.tile_n), device=dev)
                   if plan.units else None)
        counters = torch.zeros((plan.tiles,), device=dev, dtype=torch.int32)
        err = lib.resnetfc_bwd_weights(
            params, out.data_ptr(), data.rows.data_ptr(), rows_out.data_ptr(),
            data.rows.shape[0], R, None if partial is None else partial.data_ptr(),
            counters.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _launched("resnetfc_bwd_weights", err)
    else:
        out.zero_()
        rows_out.zero_()
    return _weight_grads(data, w_in, w_z, w_blk, rows_out, n_blocks, n_lin_z, d_out)


def _weight_grads(data: DataOut, w_in, w_z, w_blk, rows_out, n_blocks: int, n_lin_z: int,
                  d_out: int) -> Grads:
    """Grads from the weight products and the summed rows of per-tile sums."""
    NS, B, H = data.NS, data.B, w_in.shape[1]
    B_pad = data.ws_x.shape[0] // NS
    r_out = 1 + n_lin_z + 2 * n_blocks
    dz = None
    if data.dz is not None:
        # tile order, view-major -> z's object-major rows
        C = data.dz.shape[1]
        dz = data.dz[:B] if NS == 1 else join_views(
            list(data.dz.reshape(NS, B_pad, C)[:, :B]), data.sb)
    return Grads(
        dz=dz, dx=data.dx, w_in=w_in, b_in=rows_out[0], w_z=w_z,
        b_z=rows_out[1 : 1 + n_lin_z], b_blk=rows_out[1 + n_lin_z : r_out].reshape(n_blocks, 2, H),
        w_blk=w_blk, w_out=rows_out[r_out + 1 : r_out + 1 + d_out].t().to(w_in.dtype).contiguous(),
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
