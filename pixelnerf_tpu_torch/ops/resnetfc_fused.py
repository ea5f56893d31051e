"""Fused ResnetFC forward: hand-written CUDA kernels for Hopper.

Counterpart of ``pixelnerf_tpu/ops/resnetfc_pallas.py``:

* :func:`resnetfc_dense` launches ``resnetfc_fwd_dense``, the port of
  ``_kernel_2d`` (dense latent ``z``), on 64-point wgmma tiles with the
  weights by TMA; their tensor maps are encoded once per set of weight
  addresses (:func:`dense_plan`);
* :func:`resnetfc_gather` launches ``resnetfc_fwd_gather``, the port of
  ``_kernel_2d_gather`` (the bilinear feature lookup fused in as a 4-tap read
  of a bf16 ``(T, C)`` table), on the same tile and plan as the dense kernel,
  the lookup built by the threads into the latent's operand tile;
* :func:`resnetfc_dense_mv` launches ``resnetfc_fwd_dense_mv``, the port of
  ``_kernel_2d_mv``: NS > 1 source views, each running lin_in and the blocks
  below ``combine_layer`` on its own, then their mean through the rest, on
  the same tile and plan, its CTAs persistent with a view-sum slot each;
* :func:`resnetfc_gather_mv` launches ``resnetfc_fwd_gather_mv``, the port of
  ``_kernel_2d_mv_gather``: the same with view v's lookup into table v of an
  ``(NS, T, C)`` stack, on the same tile and plan, built as the gather's.

The dense kernels take a latent up to ``max_c`` = 4096 columns wide (the
global encoder's code before the pixel latent, 640; ResNet50's unified map,
832 / 1856 / 3904 at 3 / 4 / 5 layers), each injection of a latent past 512
columns in pieces of :data:`TILE_K` = 512 (:func:`latent_pieces`), the last
one ragged; the gathers build the same pieces from their table, to
``max_gather_c`` = 4096.  The tower's width is a compile-time constant
of the tile: one forward library is built for each width in
:data:`FWD_HIDDEN` (every multiple of 64 up to 512 but 448, and 1024;
``-DRFC_HID``), one backward library for each in :data:`BWD_HIDDEN` (the
same up to 512), and each launch takes the library of its packed width,
``w_in.shape[1]`` (:mod:`.resnetfc_vjp` for the backward's).  A tower of
any other width up to 1024 is packed at the next library's width
(:func:`library_width`), its weights zero past its own columns, which
computes the same function (:func:`pack_tower`).  At 1024 a 64-point tile
is a cluster of two CTAs, each owning 512 of the columns
(``csrc/tile64.cuh``, ``CLUSTER``); such a tower trains on the plain field
(no backward library past 512).  :data:`TILE_LIMITS` mirrors each
library's limits for the route rule, which must not build it.

Each takes its coordinate input ``x`` either encoded (a tensor) or as a
:class:`RawCode`, the deferred positional code: the kernel's CODE variant
then evaluates the code of the raw coordinates while it loads each tile, the
port of ``_x_feat`` (``fused_code``), and the launch counts under the entry
point's name with ``_code`` appended.  The deferred code is eval-only, as in
the JAX package: it has no backward.

All four live in ``csrc/resnetfc_fwd.cu``, which also notes what bounds them.
Their 64-point tile is ``csrc/tile64.cuh``, which the backward's data kernel
(``csrc/resnetfc_bwd.cu``, :mod:`.resnetfc_vjp`) shares.  Each source is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface on first use (a changed source, header or flag gets a new library
name, so it rebuilds) and loaded with ``ctypes``; :func:`build_all` compiles
every source at every width at once, one ``nvcc`` each.

Multi-view rows are object-major, as the model's query leaves them: point b
of object s in view v is row ``(s * NS + v) * B_obj + b``, and its output is
column ``s * B_obj + b``.  The fused gather takes one object (SB = 1).

Each wrapper runs its kernel's plain PyTorch version only when its tensors lie
on the CPU, in float32 throughout -- the counterpart of the Pallas kernels'
interpret mode (``_ct``).  On a CUDA tensor it launches the kernel or raises;
there is no fallback.  :func:`resnetfc_reference` and
:func:`gather_reference` with ``compute_dtype=torch.bfloat16`` round at the
kernel's points (inputs, every relu output and z to bf16, products in f32; the
view mean an f32 sum in view order times 1 / NS) and are what the on-card
checks compare the kernels with; a :class:`RawCode` is evaluated in f32 there
and rounded only after the sin, as the kernel does.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional, Union

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"fwd": CSRC / "resnetfc_fwd.cu", "bwd": CSRC / "resnetfc_bwd.cu"}
HEADERS = (CSRC / "hopper_mma.cuh", CSRC / "tile64.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# what one CTA may ask for on Hopper (227 KB of the SM's 256 KB)
MAX_SMEM_BYTES = 232448
# the hidden widths the backward kernels are built for, a library each:
# every multiple of 64 up to 512 but 448 (every config in conf/ uses 512;
# ResnetFC's default is 128; 64 is the width the JAX package's own kernel
# tests run under grad; 384 is a warpgroup's 192 columns in three pieces of
# 64; 192 and 320 are a warpgroup's 96 and 160 in one piece and two of 80)
BWD_HIDDEN = (64, 128, 192, 256, 320, 384, 512)
# the widths the forward kernels are built for: the backward's and 1024 (a
# 64-point tile on a cluster of two CTAs).  Any other width up to 1024 runs
# on the next one's library, zero-padded (library_width): 448 on 512's,
# which ran faster than a library of its own (pieces of 32 columns), and
# 513-1023 on 1024's
FWD_HIDDEN = BWD_HIDDEN + (1024,)
# the operand tile's K capacity at every width: the widest code, and the
# widest piece of a latent (``TILE_K`` in ``csrc/tile64.cuh``)
TILE_K = 512
# the most views the multi-view kernels take: a step's view is 8 bits
MAX_VIEWS = 255

# kernel launches per entry point; chip_smoke.py zeroes these around a run to
# show that the run went through the kernels
ENTRY_POINTS = ("resnetfc_fwd_dense", "resnetfc_fwd_gather", "resnetfc_fwd_dense_mv",
                "resnetfc_fwd_gather_mv")
LAUNCHES = {name + suffix: 0 for suffix in ("", "_code") for name in ENTRY_POINTS}
# the loaded forward libraries by hidden width
_LIBS: dict = {}
# the dense kernel's encoded weight maps per set of weight addresses (dense_plan)
_PLANS: "collections.OrderedDict" = collections.OrderedDict()
MAX_KEPT_PLANS = 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class LatentGather(NamedTuple):
    """A deferred pixel-aligned lookup ``z[i] = sum_j w[i,j] * table[idx[i,j]]``
    (same contract as the JAX package's ``LatentGather``)."""

    table: torch.Tensor  # (T, C), or (NS, T, C) per-view tables
    idx: torch.Tensor  # (B, taps) int32 flat row indices, columns 0..3 used
    w: torch.Tensor  # (B, taps) f32 weights (0 for padding taps)


class RawCode(NamedTuple):
    """A deferred positional code (same contract as the JAX package's
    ``RawCode``): the raw per-view coordinate features and the flat code
    arrays of :meth:`..models.code.PositionalEncoding.flat_arrays`, encoding
    to ``xg = x @ w; where(m > 0, sin(xg * f + p), xg)``."""

    x: torch.Tensor  # (B, d_raw) raw coordinate features (f32: never rounded before the sin)
    w: torch.Tensor  # (d_raw, d_code) channel-select matrix
    f: torch.Tensor  # (d_code,) per-column frequency (1 for passthrough)
    p: torch.Tensor  # (d_code,) per-column phase
    m: torch.Tensor  # (d_code,) 1.0 where the sin applies, 0.0 passthrough
    # the compute dtype under AMP: the bounded encoded output is cast to it
    cd: Optional[torch.dtype] = None


def materialize_code(rc: RawCode) -> torch.Tensor:
    """Resolve a RawCode to the dense encoded (B, d_code) code.  The select
    product (an f32 sum over the raw columns in order, as the kernel takes
    it) and the sin always run in f32; only the result is cast, to ``cd``
    when given, else to the raw coordinates' dtype."""
    x, w = rc.x.float(), rc.w.float()
    xg = x[..., 0:1] * w[0]
    for j in range(1, w.shape[0]):
        xg = xg + x[..., j : j + 1] * w[j]
    enc = torch.sin(xg * rc.f.float() + rc.p.float())
    out = torch.where(rc.m > 0, enc, xg)
    return out.to(rc.cd if rc.cd is not None else rc.x.dtype)


def materialize_gather(g: LatentGather) -> torch.Tensor:
    """Resolve a LatentGather to dense (B, C) features in the table's dtype.
    A per-view ``(NS, T, C)`` table takes view-major idx/w."""
    table, idx = g.table, g.idx.long()
    if table.ndim == 3:
        NS, T, C = table.shape
        B = idx.shape[0] // NS
        offs = (torch.arange(NS, device=idx.device) * T)[:, None, None]
        idx = (idx.reshape(NS, B, -1) + offs).reshape(NS * B, -1)
        table = table.reshape(NS * T, C)
    rows = table[idx.reshape(-1)].reshape(idx.shape + (table.shape[-1],))  # (B, taps, C)
    return torch.sum(rows * g.w[..., None].to(rows.dtype), dim=-2)


def materialize_parts(z, x):
    """Resolve deferred field inputs (a LatentGather latent, a RawCode code)
    to dense tensors and unify their dtypes the AMP way, as the JAX
    ``materialize_parts``: one bf16 side makes both bf16 (the code is still
    evaluated in f32 and only its bounded output is cast)."""
    if isinstance(x, RawCode):
        x = materialize_code(x)
    if isinstance(z, LatentGather):
        z = materialize_gather(z)
    if z is not None and z.dtype != x.dtype:
        dt = torch.bfloat16 if torch.bfloat16 in (z.dtype, x.dtype) else x.dtype
        z, x = z.to(dt), x.to(dt)
    return z, x


def coords(x) -> torch.Tensor:
    """The coordinate tensor of a field input: the encoded code itself, or a
    RawCode's raw coordinates (its rows and device are the input's)."""
    return x.x if isinstance(x, RawCode) else x


class Tower(NamedTuple):
    """ResnetFC weights packed for the kernels: (in, out) row-major matrices,
    bf16 on the card and f32 on the CPU; biases f32.  H is the packed width,
    a library's (:func:`library_width` of the module's ``d_hidden``): every
    entry past ``d_hidden`` columns (and rows) is zero."""

    w_in: torch.Tensor  # (kin, H), rows >= d_in zero
    b_in: torch.Tensor  # (H,)
    w_z: torch.Tensor  # (n_lin_z, C, H) or (0, C, H)
    b_z: torch.Tensor  # (n_lin_z, H)
    w_blk: torch.Tensor  # (n_blocks, 2, H, H)
    b_blk: torch.Tensor  # (n_blocks, 2, H)
    w_out: torch.Tensor  # (H, d_out)
    b_out: torch.Tensor  # (d_out,)
    d_in: int
    d_hidden: int  # the module's width (H, or less when zero-padded)


def supports(beta: float, use_spade: bool, combine_type: str) -> bool:
    """Config envelope the kernels implement (as ``resnetfc_pallas.supports``)."""
    return beta == 0.0 and not use_spade and combine_type == "average"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def library_width(H: int) -> int:
    """The width of the forward library a tower of width H runs on: the
    narrowest in :data:`FWD_HIDDEN` that is at least H (H itself at a
    multiple of 64 up to 512, 1024 for 513-1024).  Raises ValueError past
    1024, the widest library, and below 1."""
    for L in FWD_HIDDEN:
        if 1 <= H <= L:
            return L
    raise ValueError(f"the tile kernels take d_hidden 1 to {FWD_HIDDEN[-1]}, on the libraries "
                     f"of {FWD_HIDDEN} (H={H})")


def pack_tower(params: dict, d_in: int, d_latent: int, n_blocks: int, n_lin_z: int,
               device) -> Tower:
    """Pack torch-layout ResnetFC parameters (``lin_in.weight`` (O, I) ...)
    for the kernels.  ``params`` maps state-dict names to tensors.

    A tower of width H is packed at ``L = library_width(H)``, every entry
    past H zero: the columns of w_in, b_in, w_z and b_z, the
    rows and columns of w_blk and b_blk's entries, the rows of w_out.  That
    is the same function: the padded columns of the stream start at relu(+0)
    = +0 and only ever add products with zero weights, and zero rows of
    w_out and of every W read them; in the backward their cotangent is zero,
    so dz, dx and the first H rows and columns of every dW are the unpadded
    ones (:class:`.resnetfc_vjp.ResnetFCFunction` hands back those)."""
    device = torch.device(device)
    wdt = torch.bfloat16 if device.type == "cuda" else torch.float32

    def packed(name, *shape):  # f32, (O, I) -> (I, O), zero-padded to ``shape``
        t = params[name].detach().to(device=device, dtype=torch.float32)
        t = t.t() if t.ndim == 2 else t
        out = torch.zeros(shape, device=device)
        out[tuple(slice(0, n) for n in t.shape)] = t
        return out

    H, d_out = params["lin_out.weight"].shape[1], params["lin_out.weight"].shape[0]
    L = library_width(H)
    kin = max(_round_up(d_in, 16), 16)
    w_in = torch.zeros(kin, L, device=device, dtype=torch.float32)
    b_in = torch.zeros(L, device=device, dtype=torch.float32)
    if d_in > 0:
        w_in[:d_in] = packed("lin_in.weight", d_in, L)
        b_in = packed("lin_in.bias", L)
    C = max(d_latent, 0)
    if n_lin_z > 0:
        w_z = torch.stack([packed(f"lin_z.{k}.weight", C, L) for k in range(n_lin_z)])
        b_z = torch.stack([packed(f"lin_z.{k}.bias", L) for k in range(n_lin_z)])
    else:
        w_z = torch.zeros(0, C, L, device=device)
        b_z = torch.zeros(0, L, device=device)
    w_blk = torch.stack([
        torch.stack([packed(f"blocks.{k}.fc_{i}.weight", L, L) for i in (0, 1)])
        for k in range(n_blocks)
    ])
    b_blk = torch.stack([
        torch.stack([packed(f"blocks.{k}.fc_{i}.bias", L) for i in (0, 1)])
        for k in range(n_blocks)
    ])
    return Tower(
        w_in=w_in.to(wdt).contiguous(), b_in=b_in.contiguous(),
        w_z=w_z.to(wdt).contiguous(), b_z=b_z.contiguous(),
        w_blk=w_blk.to(wdt).contiguous(), b_blk=b_blk.contiguous(),
        w_out=packed("lin_out.weight", L, d_out).to(wdt).contiguous(),
        b_out=packed("lin_out.bias", d_out), d_in=d_in, d_hidden=H,
    )


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------


def gather_reference(idx, w, table, compute_dtype=torch.float32) -> torch.Tensor:
    """Plain 4-tap lookup ``sum_{j<4} w[:, j] * table[idx[:, j]]`` in f32,
    rounded to ``compute_dtype``.  Out-of-range rows contribute nothing.  An
    ``(NS, T, C)`` table takes view-major idx/w: view v's rows read table v.
    Each column's sum is its own, so the kernels' pieces of 512 columns (at
    any C) give these bits as they are."""
    if table.ndim == 3:
        NS = table.shape[0]
        return torch.cat([gather_reference(i, ww, t, compute_dtype)
                          for i, ww, t in zip(idx.chunk(NS), w.chunk(NS), table)])
    T = table.shape[0]
    tab = table.float()
    z = torch.zeros(idx.shape[0], table.shape[1], device=table.device)
    for j in range(4):
        ij = idx[:, j].long()
        valid = (ij >= 0) & (ij < T)
        wj = torch.where(valid, w[:, j].float(), torch.zeros_like(w[:, j].float()))
        z = z + wj[:, None] * tab[ij.clamp(0, T - 1)]
    return z.to(compute_dtype).float()


def blocks_per_view(n_blocks: int, NS: int, combine_layer: Optional[int]) -> int:
    """The blocks each view runs on its own, those below the view mean:
    ``combine_layer`` when NS > 1 (which needs it in [0, n_blocks)), all of
    them for one view."""
    if NS == 1:
        return n_blocks
    if combine_layer is None or not 0 <= combine_layer < n_blocks:
        raise ValueError(f"NS={NS} needs 0 <= combine_layer < n_blocks "
                         f"(combine_layer={combine_layer}, n_blocks={n_blocks})")
    return combine_layer


def view_mean(h: torch.Tensor, NS: int, sb: int) -> torch.Tensor:
    """The multi-view combine of object-major rows ``(sb * NS * B_obj, H)``
    -> ``(sb * B_obj, H)``: an f32 sum in view order times 1 / NS, as the TPU
    kernel takes it (``sum(xs) * (1.0 / NS)``)."""
    hv = h.reshape(sb, NS, -1, h.shape[-1])
    acc = hv[:, 0]
    for v in range(1, NS):
        acc = acc + hv[:, v]
    return (acc * (1.0 / NS)).reshape(-1, h.shape[-1])


def inject(h: torch.Tensor, z: torch.Tensor, w_z: torch.Tensor, b_z: torch.Tensor) -> torch.Tensor:
    """One injection ``h + (z w_z + b_z)`` of a C-wide latent in the kernels'
    pieces of :data:`TILE_K` columns (:func:`latent_pieces`), each product
    added to the stream on its own, the bias with the first: the sum order
    of the kernels' pieces (one piece up to C = 512, 4 at 1856)."""
    for j in range(0, z.shape[1], TILE_K):
        t = z[:, j : j + TILE_K] @ w_z[j : j + TILE_K]
        h = h + (t + b_z if j == 0 else t)
    return h


def resnetfc_reference(z, x, tower: Tower, n_blocks: int, planar_out: bool = True,
                       compute_dtype=torch.float32, NS: int = 1, sb: int = 1,
                       combine_layer: Optional[int] = None) -> torch.Tensor:
    """Plain tower: ``compute_dtype`` operands, f32 products and biases.

    :param z: (NS * B, C) latent or None when there is no latent injection
    :param x: (NS * B, d_in) coordinate code, or a RawCode of NS * B rows
        (evaluated in f32); rows object-major when NS > 1
    :param NS, sb, combine_layer: views, objects, and the block at which the
        views' mean replaces them (needed when NS > 1)
    :return: (d_out, B) when ``planar_out`` else (B, d_out), f32
    """

    def rnd(t):
        return t.to(compute_dtype).float()

    pre = blocks_per_view(n_blocks, NS, combine_layer)
    n_lin_z = tower.w_z.shape[0]
    if isinstance(x, RawCode):
        x = materialize_code(x._replace(cd=torch.float32))
    h = rnd(x) @ rnd(tower.w_in[: tower.d_in]) + tower.b_in
    zc = rnd(z) if n_lin_z > 0 else None
    for k in range(n_blocks):
        if NS > 1 and k == pre:
            h = view_mean(h, NS, sb)
        if k < n_lin_z:
            h = inject(h, zc, rnd(tower.w_z[k]), tower.b_z[k])
        t = rnd(torch.relu(h)) @ rnd(tower.w_blk[k, 0]) + tower.b_blk[k, 0]
        h = h + (rnd(torch.relu(t)) @ rnd(tower.w_blk[k, 1]) + tower.b_blk[k, 1])
    res = rnd(torch.relu(h)) @ rnd(tower.w_out)
    if planar_out:
        return res.t() + tower.b_out[:, None]
    return res + tower.b_out


# ----------------------------------------------------------------------------
# build and launch
# ----------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


class Build(NamedTuple):
    library: Path  # named by the hash of the source, its header and the nvcc flags
    compiled: bool  # False when a library of this source was already built
    log: str  # nvcc's output (ptxas register and spill lines), kept beside the library


def _flags(H: int) -> tuple:
    """nvcc's flags at hidden width ``H``: each source takes the width as
    ``-DRFC_HID``."""
    return NVCC_FLAGS + (f"-DRFC_HID={H}",)


def _library_path(which: str, H: int) -> Path:
    src = SOURCES[which]
    blob = src.read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    tag = hashlib.sha256(blob + " ".join(_flags(H)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{tag}.so"


def build_all(which=tuple(SOURCES), widths=FWD_HIDDEN) -> dict:
    """Compile each source in ``which`` at every width in ``widths`` that
    it is built for (the backward only at :data:`BWD_HIDDEN`) and that has
    no library of this source, header and flags yet: one ``nvcc`` per
    library, all started together.  Returns ``{(name, H): Build}``; raises
    if any ``nvcc`` fails."""
    builds, running = {}, {}
    for name in which:
        for H in widths:
            if name == "bwd" and H not in BWD_HIDDEN:
                continue
            lib = _library_path(name, H)
            log = lib.with_suffix(".log")
            if lib.exists():
                builds[name, H] = Build(lib, False, log.read_text() if log.exists() else "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *_flags(H), "-I", str(CSRC), "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            running[name, H] = (lib, log, tmp, proc)
    failed = []
    for (name, H), (lib, log, tmp, proc) in running.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name].name} at d_hidden {H}: nvcc failed "
                          f"({proc.returncode}):\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)
        builds[name, H] = Build(lib, True, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return builds


def build(which: str = "fwd", H: int = 512) -> Build:
    """Compile one source (``fwd`` or ``bwd``) at width ``H`` unless its
    library exists; raises ValueError at a width the source is not built
    for."""
    if H not in (BWD_HIDDEN if which == "bwd" else FWD_HIDDEN):
        raise ValueError(f"no {which} library is built at d_hidden {H}")
    return build_all((which,), (H,))[which, H]


def _lib(H: int) -> ctypes.CDLL:
    """The forward library built for hidden width ``H``, built and loaded
    at first use."""
    if H not in _LIBS:
        lib = ctypes.CDLL(str(build("fwd", H).library))
        P, I = ctypes.c_void_p, ctypes.c_int
        tower_args = [P] * 9 + [P] + [I] * 9  # x, weights, out, dims
        code_args = [P] * 4 + [I] + [P]  # code w, f, p, m, d_raw; stream
        lib.resnetfc_fwd_dense.argtypes = [P, P] + tower_args + code_args  # plan, z
        lib.resnetfc_fwd_dense.restype = I
        lib.resnetfc_fwd_dense_plan.argtypes = [P, P, P, P, I, I, I, I]
        lib.resnetfc_fwd_dense_plan.restype = I
        lib.resnetfc_fwd_dense_limits.argtypes = [P, P]
        lib.resnetfc_fwd_dense_limits.restype = ctypes.c_size_t
        lib.resnetfc_fwd_gather.argtypes = [P, P, P, I, P, I] + tower_args + code_args  # plan
        lib.resnetfc_fwd_gather.restype = I
        mv_args = tower_args + [I, I, I, P, I] + code_args  # NS, B_obj, pre, vsum, n_ctas
        lib.resnetfc_fwd_dense_mv.argtypes = [P, P] + mv_args  # plan, z
        lib.resnetfc_fwd_dense_mv.restype = I
        lib.resnetfc_fwd_gather_mv.argtypes = [P, P, P, I, P, I] + mv_args  # plan
        lib.resnetfc_fwd_gather_mv.restype = I
        lib.resnetfc_fwd_error_string.argtypes = [I]
        lib.resnetfc_fwd_error_string.restype = ctypes.c_char_p
        _LIBS[H] = lib
    return _LIBS[H]


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _code_args(x, tower: Tower):
    """Validate the coordinate input against the packed weights; return the
    tensor the kernel reads as ``x``, the ctypes code operands (null for an
    encoded code) and the launch-name suffix of the variant."""
    if not isinstance(x, RawCode):
        _check(x, "x", torch.float32, (x.shape[0], tower.d_in))
        return x, [None] * 4 + [0], ""
    d_raw = x.x.shape[-1]
    _check(x.x, "raw code x", torch.float32, (x.x.shape[0], d_raw))
    _check(x.w, "code w", torch.float32, (d_raw, tower.d_in))
    for name in ("f", "p", "m"):
        _check(getattr(x, name), f"code {name}", torch.float32, (tower.d_in,))
    if d_raw < 1:
        raise ValueError("a RawCode needs at least one raw column")
    if any(t.device != x.x.device for t in x[1:5]):
        raise ValueError(f"code arrays and raw coordinates on different devices")
    return x.x, [x.w.data_ptr(), x.f.data_ptr(), x.p.data_ptr(), x.m.data_ptr(), d_raw], "_code"


def _tower_args(tower: Tower, x, n_blocks: int, planar_out: bool, B: Optional[int] = None):
    """Validate the packed weights and the coordinate input (encoded, or a
    RawCode) against each other; return the ctypes argument tail shared by
    the entry points (up to the multi-view arguments), the code operands and
    the stream, the output tensor for ``B`` points (default: one a row of
    ``x``) and the launch-name suffix."""
    x, code, suffix = _code_args(x, tower)
    kin, H = tower.w_in.shape
    n_lin_z, C = tower.w_z.shape[0], tower.w_z.shape[1]
    d_out = tower.w_out.shape[1]
    B = x.shape[0] if B is None else B
    dev = x.device
    if H not in FWD_HIDDEN or C % 16 or kin % 16:
        raise ValueError(
            f"kernel widths: H must be one of {FWD_HIDDEN} and C, kin multiples of 16 "
            f"(H={H}, C={C}, kin={kin})"
        )
    _check(tower.w_in, "w_in", torch.bfloat16, (kin, H))
    _check(tower.b_in, "b_in", torch.float32, (H,))
    _check(tower.w_z, "w_z", torch.bfloat16, (n_lin_z, C, H))
    _check(tower.b_z, "b_z", torch.float32, (n_lin_z, H))
    _check(tower.w_blk, "w_blk", torch.bfloat16, (n_blocks, 2, H, H))
    _check(tower.b_blk, "b_blk", torch.float32, (n_blocks, 2, H))
    _check(tower.w_out, "w_out", torch.bfloat16, (H, d_out))
    _check(tower.b_out, "b_out", torch.float32, (d_out,))
    for t in tower[:8]:
        if t.device != dev:
            raise ValueError(f"weights on {t.device}, points on {dev}")
    out = torch.empty((d_out, B) if planar_out else (B, d_out), device=dev, dtype=torch.float32)
    args = [
        x.data_ptr(), tower.w_in.data_ptr(), tower.b_in.data_ptr(), tower.w_z.data_ptr(),
        tower.b_z.data_ptr(), tower.w_blk.data_ptr(), tower.b_blk.data_ptr(),
        tower.w_out.data_ptr(), tower.b_out.data_ptr(), out.data_ptr(),
        B, tower.d_in, kin, H, C, n_blocks, n_lin_z, d_out, int(planar_out),
    ]
    return args, code + [_stream(dev)], out, C, n_lin_z, suffix


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


class DenseLimits(NamedTuple):
    """What the tile kernels (``resnetfc_fwd_dense_kernel``,
    ``resnetfc_fwd_gather_kernel``, ``resnetfc_fwd_dense_mv_kernel``,
    ``resnetfc_fwd_gather_mv_kernel``) fix (read from their library by
    :func:`dense_limits`)."""

    tile: int  # points a tile unit (a CTA, or a cluster of ``cluster``) takes at a time
    threads: int  # a CTA: two warpgroups (thread 0 also feeds the weight ring)
    stages: int  # weight-ring stages
    max_out: int  # the most outputs of lin_out
    max_steps: int  # the most steps of a tile's stored program: one view's segment and the tail
    max_k: int  # the widest code (kin), and a latent's widest piece: one 64 x 512 operand tile
    slot_floats: int  # f32 words of a multi-view CTA's view-sum slot (its 64 x H / cluster stream)
    smem: int  # dynamic shared memory a CTA
    plan_bytes: int  # bytes of a plan (the weights' tensor maps)
    # the widest latent (C) of the dense kernels: an injection past max_k
    # columns runs as pieces of max_k (latent_pieces)
    max_c: int = 8 * TILE_K
    hidden: int = 512  # the tower's width H the library is built for
    # the widest table (C) of the gather kernels, whose lookup builds the
    # same pieces
    max_gather_c: int = 8 * TILE_K
    # the CTAs of a 64-point tile: 2 (a cluster, each CTA owning H / 2
    # columns) at H = 1024, else 1
    cluster: int = 1


def cluster_ctas(H: int) -> int:
    """The CTAs of one 64-point tile at library width H (``CLUSTER`` in
    ``csrc/tile64.cuh``): a cluster of two past 512 columns, else one."""
    return 2 if H > 512 else 1


def piece_cols(H: int) -> int:
    """Columns of one product piece at width H (``TILE_PIECE`` in
    ``csrc/tile64.cuh``): 64 at 1024 (four of a warpgroup's 256 columns of
    its CTA's 512), else 128 where they divide a warpgroup's H / 2 columns,
    else 64 (three pieces of H = 384's 192), else the whole half up to 128
    (32 at 64, 96 at 192), else half of it (80 at 320)."""
    if cluster_ctas(H) > 1:
        return 64
    half = H // 2
    return 128 if half % 128 == 0 else 64 if half % 64 == 0 else half if half <= 128 else half // 2


def ring_stage_bytes(H: int) -> int:
    """Bytes of one weight-ring stage at width H (``STAGE_BYTES`` in
    ``csrc/tile64.cuh``): 64 K rows of one piece of each warpgroup
    (:func:`piece_cols`), bf16."""
    return 2 * piece_cols(H) * 64 * 2


def _mirror(H: int) -> DenseLimits:
    """The limits of the library built at width H, from the tile's constants
    (``csrc/tile64.cuh``): each warpgroup owns half of a CTA's H (H / 2 at
    1024, a cluster of two CTAs) columns in pieces of at most 128, so a
    thread's share of the stream (the view-sum slot) is a CTA's H / 4 f32;
    the stages that a 96 KB weight ring holds (3 of 32 KB, 6 of 16 KB at H =
    128 and 384, 12 of 8 KB at 64, 4 of 24 KB at 192, 4 of 20 KB at 320), or
    at 1024 a 32 KB ring (2 of 16 KB); two 64 KB operand tiles, the block
    products' 128 KB at 1024."""
    cl = cluster_ctas(H)
    stage = ring_stage_bytes(H)
    stages = (32768 if cl > 1 else 3 * 32768) // stage
    act = 64 * max(H, TILE_K) * 2
    return DenseLimits(tile=64, threads=256, stages=stages, max_out=4, max_steps=128,
                       max_k=TILE_K, slot_floats=H // cl // 4 * 256,
                       smem=act + 65536 + stages * stage + 1024, plan_bytes=448, max_c=8 * TILE_K,
                       hidden=H, max_gather_c=8 * TILE_K, cluster=cl)


# What each width's library reports (dense_limits), mirrored so that the
# route rule (models/resnetfc.py) can test a tower's widths without building
# or loading a library; chip_smoke.py and a cuda-marked test hold the two
# equal.
TILE_LIMITS = {H: _mirror(H) for H in FWD_HIDDEN}


def tile_limits(H: int) -> DenseLimits:
    """The mirrored limits of the library a tower of width H runs on
    (:func:`library_width`); raises ValueError past 1024."""
    return TILE_LIMITS[library_width(H)]


@functools.lru_cache(maxsize=None)
def dense_limits(H: int = 512) -> DenseLimits:
    """What the library of width H reports."""
    out, smem = (ctypes.c_int * 11)(), ctypes.c_size_t()
    n = _lib(H).resnetfc_fwd_dense_limits(out, ctypes.byref(smem))
    return DenseLimits(*out[:7], smem.value, n, out[7], out[8], out[9], out[10])


def latent_pieces(C: int) -> int:
    """The steps an injection of a C-wide latent takes in the tile kernels,
    each way in the data kernel: pieces of at most TILE_K columns
    (``latent_pieces`` in ``csrc/tile64.cuh``); 1 up to C = 512 at every
    tower width, 4 at ResNet50's 1856, 8 at 3904."""
    return max(1, -(-C // TILE_K))


def dense_steps(n_blocks: int, n_lin_z: int, NS: int = 1, pre: Optional[int] = None,
                C: int = TILE_K) -> int:
    """Steps of one tile's stored program (``fwd_program`` in
    ``csrc/resnetfc_fwd.cu``, the data kernel's recompute): one view's
    segment -- lin_in, then per block below the mean (``pre``; every block
    for one view) its injection (the first n_lin_z blocks; one step a
    :func:`latent_pieces` of the C-wide latent), fc_0 and fc_1, and at NS > 1
    the fold into the view mean -- which the tile walks once for each view;
    then fc_0 and fc_1 of each shared block.  14 at sn64 and one view, 15 at
    any view count; 17 at one view with the global encoder's C = 640, 23
    with ResNet50's 1856 (24 from NS = 2 up), 35 with its 3904."""
    pre = n_blocks if NS == 1 or pre is None else pre
    return 1 + n_lin_z * latent_pieces(C) + 2 * pre + int(NS > 1) + 2 * (n_blocks - pre)


def dense_grid(B: int, limits: DenseLimits) -> int:
    """The tiles of a ``resnetfc_fwd_dense`` launch: one CTA each (at 1024
    persistent pairs walk them), the last one ragged (its rows past B read
    zeros and write nothing)."""
    return -(-B // limits.tile)


def check_dense_widths(kin: int, H: int, C: int, n_lin_z: int, n_blocks: int, d_out: int,
                       limits: DenseLimits) -> None:
    """Raise ValueError on widths ``resnetfc_fwd_dense`` does not take: H
    (the packed width) other than the library's (``limits.hidden``: every
    multiple of 64 up to 512 but 448, and 1024, one library each); kin not a multiple of 16
    or past ``limits.max_k``; with a latent, C not a multiple of 16 or past
    ``limits.max_c``; more
    injections than blocks; more outputs than ``limits.max_out``; a program
    past ``limits.max_steps``; a CTA past the card's shared memory."""
    if H != limits.hidden:
        raise ValueError(f"the dense kernel of this library needs d_hidden {limits.hidden}, "
                         f"one library each of {FWD_HIDDEN} (H={H})")
    for name, v, top in (("kin", kin, limits.max_k),) + (
            (("C", C, limits.max_c),) if n_lin_z > 0 else ()):
        if v % 16 or not 16 <= v <= top:
            raise ValueError(f"the dense kernel needs {name} a multiple of 16 in "
                             f"[16, {top}] ({name}={v})")
    if not 0 <= n_lin_z <= n_blocks or n_blocks < 1:
        raise ValueError(f"the dense kernel needs 0 <= n_lin_z <= n_blocks and a block "
                         f"(n_lin_z={n_lin_z}, n_blocks={n_blocks})")
    if not 1 <= d_out <= limits.max_out:
        raise ValueError(f"the dense kernel takes 1 to {limits.max_out} outputs (d_out={d_out})")
    steps = dense_steps(n_blocks, n_lin_z, C=C)
    if steps > limits.max_steps:
        raise ValueError(f"the dense kernel runs at most {limits.max_steps} steps a tile; "
                         f"{n_blocks} blocks need {steps}")
    if limits.smem > MAX_SMEM_BYTES:
        raise ValueError(f"the dense kernel needs {limits.smem} B of shared memory per CTA "
                         f"(> {MAX_SMEM_BYTES})")


def dense_mv_grid(B: int, n_sms: int, limits: DenseLimits) -> int:
    """The CTAs of a ``resnetfc_fwd_dense_mv`` launch: persistent, one an SM
    at most (each holds a view-sum slot), walking the tile-point tiles of the
    B output points; at 1024 in clusters of two, a tile each (the library
    also keeps the clusters to those the card holds at once)."""
    cl = limits.cluster
    return cl * min(-(-B // limits.tile), n_sms // cl)


def check_tile_tower(tower: Tower, n_blocks: int, limits: DenseLimits) -> None:
    """Raise ValueError on packed weights the tile kernels do not take:
    widths (:func:`check_dense_widths`), or weights that TMA cannot
    read in place (:func:`check_tma`)."""
    kin, H = tower.w_in.shape
    check_dense_widths(kin, H, tower.w_z.shape[1], tower.w_z.shape[0], n_blocks,
                       tower.w_out.shape[1], limits)
    for name in ("w_in", "w_z", "w_blk"):
        check_tma(getattr(tower, name), name)


def check_gather(idx: torch.Tensor, w: torch.Tensor, table: torch.Tensor, rows: int,
                 tower: Tower, n_blocks: int, limits: DenseLimits) -> None:
    """Raise ValueError on what ``resnetfc_fwd_gather`` does not take, on any
    device: weights the tile does not take (:func:`check_tile_tower`); fewer
    than 4 taps; idx / w other than ``(rows, taps)``; a table wider than
    the gathers take (:func:`_check_gather_width`), other than ``(T, C)`` or
    whose rows are not 16-byte aligned (:func:`check_tma`: the lookup reads
    16-byte chunks of a row)."""
    check_tile_tower(tower, n_blocks, limits)
    _check_taps(idx, w, rows)
    C = tower.w_z.shape[1]
    _check_gather_width(C, limits)
    if table.ndim != 2 or table.shape[1] != C or table.shape[0] < 1:
        raise ValueError(f"the gather needs a (T, C={C}) table, got {tuple(table.shape)}")
    check_tma(table, "table")


def _check_gather_width(C: int, limits: DenseLimits) -> None:
    """The gathers build the latent into the operand tile a piece of at most
    ``max_k`` columns at a time: C <= ``max_gather_c``, a multiple of 8 (a
    table row is read in 16-byte chunks)."""
    if C % 8 or C > limits.max_gather_c:
        raise ValueError(f"the gather kernels take a latent of at most {limits.max_gather_c} "
                         f"columns, a multiple of 8 (C={C})")


def _check_taps(idx: torch.Tensor, w: torch.Tensor, rows: int) -> None:
    """The gathers' taps: ``(rows, taps)`` idx and w with at least 4 taps."""
    if idx.ndim != 2 or idx.shape[1] < 4:
        raise ValueError(f"the gather needs (rows, taps) idx with at least 4 taps, got "
                         f"{tuple(idx.shape)}")
    for name, t in (("idx", idx), ("w", w)):
        if tuple(t.shape) != (rows, idx.shape[1]):
            raise ValueError(f"{name} must have shape {(rows, idx.shape[1])}, got "
                             f"{tuple(t.shape)}")


def check_gather_mv(idx: torch.Tensor, w: torch.Tensor, tables: torch.Tensor, rows: int,
                    combine_layer: int, tower: Tower, n_blocks: int, limits: DenseLimits) -> None:
    """Raise ValueError on what ``resnetfc_fwd_gather_mv`` does not take, on
    any device: tables other than ``(NS, T, C)`` or whose rows are not
    16-byte aligned (:func:`check_tma`); rows that are not one object's NS
    views, more than MAX_VIEWS views or weights the tile does not take
    (:func:`check_mv_tower` at SB = 1); fewer than 4 taps or idx / w other
    than ``(rows, taps)``, view-major."""
    C = tower.w_z.shape[1]
    if tables.ndim != 3 or tables.shape[2] != C or tables.shape[1] < 1:
        raise ValueError(f"the multi-view gather needs (NS, T, C={C}) tables, got "
                         f"{tuple(tables.shape)}")
    check_mv_tower(rows, tables.shape[0], 1, combine_layer, tower, n_blocks, limits)
    _check_gather_width(C, limits)
    _check_taps(idx, w, rows)
    check_tma(tables, "tables")


def check_mv_tower(rows: int, NS: int, sb: int, combine_layer: int, tower: Tower,
                   n_blocks: int, limits: DenseLimits) -> None:
    """Raise ValueError on a multi-view launch the tile kernels do not take,
    on any device: rows that are not SB x NS x B_obj (:func:`mv_shape`, NS >=
    2); more than MAX_VIEWS views; weights the tile does not take
    (:func:`check_tile_tower`); more injections than blocks below the mean;
    a stored program past ``limits.max_steps`` (one view's segment and the
    shared blocks: too many blocks; any view count fits)."""
    mv_shape(rows, NS, sb, combine_layer, n_blocks)
    if NS > MAX_VIEWS:
        raise ValueError(f"the multi-view kernels take at most {MAX_VIEWS} views (NS={NS})")
    check_tile_tower(tower, n_blocks, limits)
    n_lin_z = tower.w_z.shape[0]
    if n_lin_z > combine_layer:
        raise ValueError(f"the multi-view kernels inject the latent only below the view mean "
                         f"(n_lin_z={n_lin_z}, combine_layer={combine_layer})")
    steps = dense_steps(n_blocks, n_lin_z, NS, combine_layer, tower.w_z.shape[1])
    if steps > limits.max_steps:
        raise ValueError(f"the multi-view kernels store at most {limits.max_steps} steps a tile; "
                         f"{n_blocks} blocks with the mean at block {combine_layer} need {steps}")


def check_dense_mv(z: Optional[torch.Tensor], rows: int, NS: int, sb: int, combine_layer: int,
                   tower: Tower, n_blocks: int, limits: DenseLimits) -> None:
    """Raise ValueError on what ``resnetfc_fwd_dense_mv`` does not take, on
    any device: the layout, views or weights (:func:`check_mv_tower`); with
    a latent, z other than bf16 ``(rows, C)`` or that TMA cannot read in
    place (:func:`check_tma`)."""
    check_mv_tower(rows, NS, sb, combine_layer, tower, n_blocks, limits)
    n_lin_z, C = tower.w_z.shape[0], tower.w_z.shape[1]
    if n_lin_z > 0:
        if z is None or z.dtype != torch.bfloat16:
            raise ValueError(f"the multi-view kernel needs a bf16 latent z, got "
                             f"{None if z is None else z.dtype}")
        if tuple(z.shape) != (rows, C):
            raise ValueError(f"z must have shape {(rows, C)}, got {tuple(z.shape)}")
        check_tma(z, "z")


def check_tma(t: torch.Tensor, what: str) -> None:
    """TMA reads a matrix in place: contiguous, with a 16-byte aligned base
    and rows a multiple of 16 bytes."""
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary with rows a multiple of 16 "
                         f"bytes (address {t.data_ptr():#x}, row {t.shape[-1]} x "
                         f"{t.element_size()} B)")


def dense_plan(tower: Tower, n_blocks: int) -> ctypes.Array:
    """The dense kernel's plan for these packed weights: their tensor maps,
    encoded once per set of weight addresses and kept (the last
    MAX_KEPT_PLANS sets), so that a launch costs the host one parameter
    copy.  Raises if the encoding fails."""
    (kin, H), C, n_lin_z = tower.w_in.shape, tower.w_z.shape[1], tower.w_z.shape[0]
    args = (tower.w_in.data_ptr(), tower.w_z.data_ptr(), tower.w_blk.data_ptr(), kin, C,
            n_blocks, n_lin_z)
    key = args + (H,)
    plan = _PLANS.get(key)
    if plan is not None:
        _PLANS.move_to_end(key)
        return plan
    plan = ctypes.create_string_buffer(dense_limits(H).plan_bytes)
    err = _lib(H).resnetfc_fwd_dense_plan(plan, *args)
    if err != 0:
        raise RuntimeError(f"resnetfc_fwd_dense plan failed: "
                           f"{_lib(H).resnetfc_fwd_error_string(err).decode()} ({err})")
    _PLANS[key] = plan
    if len(_PLANS) > MAX_KEPT_PLANS:
        _PLANS.popitem(last=False)
    return plan


def dense_mv_slots(dev, limits: DenseLimits) -> torch.Tensor:
    """The multi-view kernels' view-sum slots, one per SM: each persistent
    CTA keeps its share of the view sum there (``limits.slot_floats`` f32,
    a 64 x H f32 stream: 128 KB at H = 512; a CTA's half at 1024, 128 KB)."""
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return torch.empty((n_sms, limits.slot_floats), device=dev)


def mv_shape(rows: int, NS: int, sb: int, combine_layer: int, n_blocks: int):
    """Validate a multi-view layout of ``rows`` input rows; return (B, B_obj),
    the output points and the points of one object."""
    if NS < 2 or sb < 1 or rows % (NS * sb):
        raise ValueError(f"{rows} rows are not SB={sb} objects x NS={NS} views")
    blocks_per_view(n_blocks, NS, combine_layer)
    return rows // NS, rows // (NS * sb)


def _launched(name: str, err: int, H: int) -> None:
    if err != 0:
        msg = _lib(H).resnetfc_fwd_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


Coords = Union[torch.Tensor, RawCode]


def resnetfc_dense(z: Optional[torch.Tensor], x: Coords, tower: Tower, n_blocks: int,
                   planar_out: bool = True) -> torch.Tensor:
    """ResnetFC forward over dense latents ``z (B, C)`` (bf16; None when the
    tower injects no latent) and code ``x (B, d_in)`` (f32) or a RawCode of
    ``B`` rows.  Raises on weights the kernel does not take
    (:func:`check_tile_tower`) and on a latent that TMA cannot read in place
    (:func:`check_tma`).

    :return: (d_out, B) f32 when ``planar_out`` else (B, d_out)
    """
    rows = coords(x).shape[0]
    if coords(x).device.type == "cpu":
        return resnetfc_reference(z, x, tower, n_blocks, planar_out)
    args, tail, out, C, n_lin_z, suffix = _tower_args(tower, x, n_blocks, planar_out)
    H = tower.w_in.shape[1]
    check_tile_tower(tower, n_blocks, dense_limits(H))
    if n_lin_z > 0:
        _check(z, "z", torch.bfloat16, (rows, C))
        check_tma(z, "z")
    if rows == 0:
        return out
    err = _lib(H).resnetfc_fwd_dense(dense_plan(tower, n_blocks),
                                     z.data_ptr() if n_lin_z > 0 else None, *args, *tail)
    _launched("resnetfc_fwd_dense" + suffix, err, H)
    return out


def resnetfc_gather(idx: torch.Tensor, w: torch.Tensor, table: torch.Tensor, x: Coords,
                    tower: Tower, n_blocks: int, planar_out: bool = True) -> torch.Tensor:
    """ResnetFC forward with the lookup ``z = sum_{j<4} w[:, j] * table[idx[:, j]]``
    fused in: ``idx (B, taps)`` int32, ``w (B, taps)`` f32, ``table (T, C)``
    bf16, ``x (B, d_in)`` f32 or a RawCode of ``B`` rows.  Raises on what
    the kernel does not take (:func:`check_gather`).

    :return: (d_out, B) f32 when ``planar_out`` else (B, d_out)
    """
    rows = coords(x).shape[0]
    if coords(x).device.type == "cpu":
        z = gather_reference(idx, w, table)
        return resnetfc_reference(z, x, tower, n_blocks, planar_out)
    args, tail, out, C, n_lin_z, suffix = _tower_args(tower, x, n_blocks, planar_out)
    _check(idx, "idx", torch.int32, idx.shape)
    _check(w, "w", torch.float32, w.shape)
    _check(table, "table", torch.bfloat16, table.shape)
    H = tower.w_in.shape[1]
    check_gather(idx, w, table, rows, tower, n_blocks, dense_limits(H))
    if rows == 0:
        return out
    err = _lib(H).resnetfc_fwd_gather(
        dense_plan(tower, n_blocks), idx.data_ptr(), w.data_ptr(), idx.shape[1], table.data_ptr(),
        table.shape[0], *args, *tail,
    )
    _launched("resnetfc_fwd_gather" + suffix, err, H)
    return out


def resnetfc_dense_mv(z: Optional[torch.Tensor], x: Coords, tower: Tower, n_blocks: int,
                      NS: int, combine_layer: int, sb: int = 1,
                      planar_out: bool = True) -> torch.Tensor:
    """Multi-view ResnetFC forward over dense latents ``z (SB*NS*B_obj, C)``
    (bf16; None when the tower injects no latent) and code ``x`` with the
    same object-major rows (f32, or a RawCode): every view through lin_in and
    the blocks below ``combine_layer``, their mean through the rest.  Raises
    on what the kernel does not take (:func:`check_dense_mv`).

    :return: (d_out, SB*B_obj) f32 when ``planar_out`` else (SB*B_obj, d_out)
    """
    rows = coords(x).shape[0]
    B, B_obj = mv_shape(rows, NS, sb, combine_layer, n_blocks)
    if coords(x).device.type == "cpu":
        return resnetfc_reference(z, x, tower, n_blocks, planar_out, NS=NS, sb=sb,
                                  combine_layer=combine_layer)
    args, tail, out, C, n_lin_z, suffix = _tower_args(tower, x, n_blocks, planar_out, B)
    H = tower.w_in.shape[1]
    limits = dense_limits(H)
    check_dense_mv(z, rows, NS, sb, combine_layer, tower, n_blocks, limits)
    if n_lin_z > 0:
        _check(z, "z", torch.bfloat16, (rows, C))
    if B == 0:
        return out
    slots = dense_mv_slots(out.device, limits)
    err = _lib(H).resnetfc_fwd_dense_mv(
        dense_plan(tower, n_blocks), z.data_ptr() if n_lin_z > 0 else None, *args, NS, B_obj,
        combine_layer, slots.data_ptr(), slots.shape[0], *tail,
    )
    _launched("resnetfc_fwd_dense_mv" + suffix, err, H)
    return out


def resnetfc_gather_mv(idx: torch.Tensor, w: torch.Tensor, tables: torch.Tensor, x: Coords,
                       tower: Tower, n_blocks: int, combine_layer: int,
                       planar_out: bool = True) -> torch.Tensor:
    """Multi-view ResnetFC forward of one object with view v's lookup
    ``z = sum_{j<4} w[:, j] * tables[v][idx[:, j]]`` fused in: ``tables
    (NS, T, C)`` bf16, ``idx (NS*B, taps)`` int32 and ``w (NS*B, taps)`` f32
    view-major, ``x (NS*B, d_in)`` f32 (or a RawCode) in the same rows.
    Raises on what the kernel does not take (:func:`check_gather_mv`).

    :return: (d_out, B) f32 when ``planar_out`` else (B, d_out)
    """
    if tables.ndim != 3:
        raise ValueError(
            f"the multi-view gather needs (NS, T, C) tables, got {tuple(tables.shape)}")
    NS = tables.shape[0]
    rows = coords(x).shape[0]
    B, _ = mv_shape(rows, NS, 1, combine_layer, n_blocks)
    if coords(x).device.type == "cpu":
        z = gather_reference(idx, w, tables)
        return resnetfc_reference(z, x, tower, n_blocks, planar_out, NS=NS,
                                  combine_layer=combine_layer)
    args, tail, out, C, n_lin_z, suffix = _tower_args(tower, x, n_blocks, planar_out, B)
    _check(idx, "idx", torch.int32, idx.shape)
    _check(w, "w", torch.float32, w.shape)
    _check(tables, "tables", torch.bfloat16, tables.shape)
    H = tower.w_in.shape[1]
    limits = dense_limits(H)
    check_gather_mv(idx, w, tables, rows, combine_layer, tower, n_blocks, limits)
    if B == 0:
        return out
    slots = dense_mv_slots(out.device, limits)
    err = _lib(H).resnetfc_fwd_gather_mv(
        dense_plan(tower, n_blocks), idx.data_ptr(), w.data_ptr(), idx.shape[1], tables.data_ptr(),
        tables.shape[1], *args, NS, B, combine_layer, slots.data_ptr(), slots.shape[0], *tail,
    )
    _launched("resnetfc_fwd_gather_mv" + suffix, err, H)
    return out
