"""ResNet-style fully-connected NeRF field decoder.

Per-block latent injection ``x + lin_z[i](z)`` before each residual block up
to ``combine_layer``, multi-view averaging by ``combine_interleaved`` at
``combine_layer``, optional SPADE modulation, softplus(beta) or ReLU, and the
reference init (kaiming fan-in for lin_in / lin_z / fc_0 / lin_out / shortcut,
zero fc_1 so blocks start as the identity).  Parameter names follow the
reference torch module: ``lin_in``, ``lin_z.{k}``, ``blocks.{k}.fc_0/fc_1``,
``lin_out``.

``impl`` picks the implementation, as ``impl`` does in the JAX ResnetFC:

* ``"torch"``: the plain PyTorch forward below, in the parameters' dtype;
* ``"cuda"``: the hand-written kernels of :mod:`..ops.resnetfc_fused` (on
  CPU tensors their plain f32 versions run instead); a config outside the
  kernels' envelope raises.  Dense inputs go through
  :class:`..ops.resnetfc_vjp.ResnetFCFunction`, so the same call serves eval
  and training (its backward is a kernel too); the deferred inputs -- a
  fused-gather latent, a deferred positional code
  (:class:`~..ops.resnetfc_fused.RawCode`) -- are eval-only, as in the JAX
  package, and raise under grad;
* ``"auto"``: the kernels for CUDA tensors inside the envelope, the plain
  forward otherwise.

The envelope is the config (:func:`~..ops.resnetfc_fused.supports`) and the
widths every kernel of the call takes (:meth:`ResnetFC.check_kernel_widths`):
the forward's, and under grad the backward's too.  It is read from the
kernels' limits as mirrored in Python (``TILE_LIMITS``, ``DATA_LIMITS``,
``WEIGHT_LIMITS``), so that the rule never builds or loads the library.  A
tower outside it takes the plain route under ``auto`` -- as the JAX package
falls back to XLA outside ``supports`` -- and raises under ``cuda`` on a CUDA
tensor.

A multi-view call (NS > 1) takes the multi-view kernels when the tower takes
the view mean (``combine_layer < n_blocks``), with ``sb = rows // (NS * B)``
objects, as the JAX ResnetFC does; without the view mean it stays plain, as
in JAX.  The multi-view fused gather takes one object and per-view
``(NS, T, C)`` tables.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resnetfc_fused as rf
from ..ops import resnetfc_vjp as rfv
from ..utils.geometry import combine_interleaved


def _activation(beta: float):
    if beta > 0:
        return lambda x: F.softplus(x * beta) / beta
    return F.relu


class ResnetBlockFC(nn.Module):
    """Two-layer FC residual block."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None, beta: float = 0.0):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.act = _activation(beta)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = None if size_in == size_out else nn.Linear(size_in, size_out, bias=False)

    def forward(self, x):
        net = self.fc_0(self.act(x))
        dx = self.fc_1(self.act(net))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx


class ResnetFC(nn.Module):
    def __init__(
        self,
        d_in: int,
        d_out: int = 4,
        n_blocks: int = 5,
        d_latent: int = 0,
        d_hidden: int = 128,
        beta: float = 0.0,
        combine_layer: int = 1000,
        combine_type: str = "average",
        use_spade: bool = False,
        impl: str = "torch",
    ):
        super().__init__()
        if impl not in ("torch", "cuda", "auto"):
            raise ValueError(f"impl must be torch | cuda | auto, got {impl!r}")
        self.d_in, self.d_out, self.n_blocks = d_in, d_out, n_blocks
        self.d_latent, self.d_hidden, self.beta = d_latent, d_hidden, beta
        self.combine_layer, self.combine_type = combine_layer, combine_type
        self.use_spade, self.impl = use_spade, impl
        self.act = _activation(beta)
        if d_in > 0:
            self.lin_in = nn.Linear(d_in, d_hidden)
        self.lin_out = nn.Linear(d_hidden, d_out)
        self.blocks = nn.ModuleList(
            [ResnetBlockFC(d_hidden, beta=beta) for _ in range(n_blocks)]
        )
        self.n_lin_z = min(combine_layer, n_blocks) if d_latent > 0 else 0
        if self.n_lin_z > 0:
            self.lin_z = nn.ModuleList(
                [nn.Linear(d_latent, d_hidden) for _ in range(self.n_lin_z)]
            )
            if use_spade:
                self.scale_z = nn.ModuleList(
                    [nn.Linear(d_latent, d_hidden) for _ in range(self.n_lin_z)]
                )
        self._tower = None
        self._tower_key = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Reference init from ``generator``: kaiming fan-in normal weights,
        zero biases, zero fc_1 weights."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias") or ".fc_1." in name:
                    p.zero_()
                else:
                    std = (2.0 / p.shape[1]) ** 0.5
                    p.copy_(torch.randn(p.shape, generator=generator) * std)

    # ------------------------------------------------------------------
    def check_kernel_widths(self, NS: int = 1, grad: bool = False) -> None:
        """Raise ValueError on widths a kernel of this call does not take:
        the forward's at NS views (H = 512; kin and C multiples of 16, kin
        <= 512, C <= 1024; the stored program's steps); under ``grad`` also
        the backward's (the data kernel's widths and program, the weights
        kernel's plan: C = 512 with a latent, kin <= 128, at most 5 blocks
        at sn64 widths).  Reads only the Python mirrors of the limits."""
        kin = max(-(-self.d_in // 16) * 16, 16)
        C = self.d_latent if self.n_lin_z > 0 else 0
        lim = rf.TILE_LIMITS
        rf.check_dense_widths(kin, self.d_hidden, C, self.n_lin_z, self.n_blocks, self.d_out, lim)
        pre = self.n_blocks
        if NS > 1:
            pre = rf.blocks_per_view(self.n_blocks, NS, self.combine_layer)
            if NS > rf.MAX_VIEWS or self.n_lin_z > pre:
                raise ValueError(f"the multi-view kernels take at most {rf.MAX_VIEWS} views and "
                                 f"inject the latent below the view mean (NS={NS}, "
                                 f"n_lin_z={self.n_lin_z}, combine_layer={self.combine_layer})")
            if rf.dense_steps(self.n_blocks, self.n_lin_z, NS, pre, C) > lim.max_steps:
                raise ValueError(f"the multi-view kernels store at most {lim.max_steps} steps")
        if grad:
            rfv.check_data_widths(kin, self.d_hidden, C, self.n_lin_z, self.n_blocks, self.d_out,
                                  rfv.DATA_LIMITS)
            rfv.check_data_program(self.n_blocks, self.n_lin_z, NS, pre, rfv.DATA_LIMITS)
            rfv.weight_plan(kin, self.d_hidden, C, self.n_blocks, self.n_lin_z, NS, pre, 64,
                            rfv.WEIGHT_LIMITS)

    def _kernel_route(self, combine_inner_dims, device: torch.device, grad: bool = False) -> bool:
        """Whether this call takes the kernels (on the CPU, their plain
        versions): under ``auto`` a CUDA tensor inside the envelope, under
        ``cuda`` always -- raising, on a CUDA tensor, for a tower outside
        it.  ``grad``: the call will be differentiated."""
        if self.impl == "torch":
            return False
        if not rf.supports(self.beta, self.use_spade, self.combine_type):
            if self.impl == "cuda":
                raise ValueError(
                    "impl='cuda' needs beta 0, no SPADE and average combine "
                    f"(beta={self.beta}, use_spade={self.use_spade}, "
                    f"combine_type={self.combine_type!r})"
                )
            return False
        if len(combine_inner_dims) != 2:
            return False
        NS = combine_inner_dims[0]
        if NS != 1 and not 0 <= self.combine_layer < self.n_blocks:
            return False  # no view mean inside the tower: plain, as in JAX
        if device.type != "cuda":
            return self.impl == "cuda"  # the kernels' plain versions take any width
        try:
            self.check_kernel_widths(NS, grad)
        except ValueError:
            if self.impl == "cuda":
                raise
            return False
        return True

    def tower(self, device: torch.device) -> rf.Tower:
        """The parameters packed for the kernels.  The module's own parameters
        are packed once and again when one changes (its data pointer or
        version); substitutes (``torch.func.functional_call``, e.g. the
        trainer's per-step bf16 copies) are packed on every call, since a new
        copy can reuse a freed one's address at version 0."""
        params = dict(self.named_parameters())

        def pack():
            return rf.pack_tower(params, self.d_in, self.d_latent, self.n_blocks,
                                 self.n_lin_z, device)

        if not all(isinstance(p, nn.Parameter) for p in params.values()):
            return pack()
        key = (device,) + tuple((p.data_ptr(), p._version) for p in params.values())
        if key != self._tower_key:
            self._tower, self._tower_key = pack(), key
        return self._tower

    def _kernel_forward(self, zx, combine_inner_dims, planar_out: bool):
        if type(zx) is tuple:
            z, x = zx
        else:
            z, x = zx[..., : self.d_latent], zx[..., self.d_latent :]
            z = z if self.d_latent > 0 else None
        gather, raw = isinstance(z, rf.LatentGather), isinstance(x, rf.RawCode)
        if (gather or raw) and torch.is_grad_enabled() and (
            any(p.requires_grad for p in self.parameters())
            or (gather and z.table.requires_grad)
            or (z is not None and not gather and z.requires_grad)
            or (raw and x.x.requires_grad)
        ):
            # as in the JAX package, the fused-gather and deferred-code
            # kernels have no backward; training keeps the inputs dense
            # (diff_mode)
            raise RuntimeError(
                "the fused-gather and deferred-code routes are eval-only: run them under "
                "torch.no_grad(), or build the model with diff_mode=True for training"
            )
        if raw:
            if x.w.shape[-1] != self.d_in:
                raise ValueError(
                    f"RawCode encodes {x.w.shape[-1]} columns, lin_in takes {self.d_in}")
            device = x.x.device
            x = rf.RawCode(x.x.reshape(-1, x.x.shape[-1]).float().contiguous(),
                           *(t.to(device=device, dtype=torch.float32).contiguous()
                             for t in (x.w, x.f, x.p, x.m)))
        else:
            x = x.reshape(-1, x.shape[-1]).float().contiguous()
            device = x.device
        tower = self.tower(device)
        NS, B = combine_inner_dims
        sb = rf.coords(x).shape[0] // (NS * B)  # outer object superbatch (train: SB objects)
        if gather:
            if z.table.ndim != (2 if NS == 1 else 3):
                raise ValueError(f"the fused gather at NS={NS} needs "
                                 f"{'a (T, C) table' if NS == 1 else '(NS, T, C) tables'}")
            if sb != 1:
                raise ValueError(f"the fused gather takes one object's tables (SB=1), got SB={sb}")
            table = z.table if device.type == "cpu" else z.table.to(torch.bfloat16)
            idx = z.idx.reshape(-1, z.idx.shape[-1]).to(torch.int32).contiguous()
            w = z.w.reshape(-1, z.w.shape[-1]).float().contiguous()
            if NS == 1:
                out = rf.resnetfc_gather(idx, w, table.contiguous(), x, tower, self.n_blocks,
                                         planar_out)
            else:
                out = rf.resnetfc_gather_mv(idx, w, table.contiguous(), x, tower, self.n_blocks,
                                            self.combine_layer, planar_out)
        else:
            if z is not None:
                z = z.reshape(-1, self.d_latent)
                z = (z.float() if device.type == "cpu" else z.to(torch.bfloat16)).contiguous()
            if raw:  # eval-only: the forward kernels, no autograd Function
                if NS == 1:
                    return rf.resnetfc_dense(z, x, tower, self.n_blocks, planar_out)[None]
                return rf.resnetfc_dense_mv(z, x, tower, self.n_blocks, NS, self.combine_layer, sb,
                                            planar_out)[None]
            params = dict(self.named_parameters())
            names = rfv.param_names(self.d_in, self.n_lin_z, self.n_blocks)
            cfg = (self.d_in, self.n_blocks, self.n_lin_z, planar_out, NS, sb,
                   self.combine_layer)
            out = rfv.ResnetFCFunction.apply(tower, cfg, z, x, *[params[n] for n in names])
        return out[None]  # (1, d_out, N) or (1, N, d_out)

    def forward(self, zx, combine_inner_dims: Sequence[int] = (1,), planar_out: bool = False):
        """:param zx: (..., d_latent + d_in), latent first; or a tuple ``(z, x)``
        with ``z`` a dense latent, a :class:`~..ops.resnetfc_fused.LatentGather`
        or None, and ``x`` the coordinate code or a
        :class:`~..ops.resnetfc_fused.RawCode`
        :param combine_inner_dims: (NS, B) for the multi-view combination
        :param planar_out: return channel-major (..., d_out, N)
        """
        parts = zx if type(zx) is tuple else None
        device = (rf.coords(parts[1]) if parts is not None else zx).device
        grad = torch.is_grad_enabled() and (
            any(p.requires_grad for p in self.parameters())
            or any(torch.is_tensor(t) and t.requires_grad
                   for t in ((parts[0], rf.coords(parts[1])) if parts is not None else (zx,))))
        if self._kernel_route(combine_inner_dims, device, grad):
            return self._kernel_forward(zx, tuple(combine_inner_dims), planar_out)

        dt = self.lin_out.weight.dtype
        if parts is not None:
            # deferred inputs resolved, one bf16 side making both bf16
            z, x = rf.materialize_parts(*parts)
        elif self.d_latent > 0:
            z, x = zx[..., : self.d_latent], zx[..., self.d_latent :]
        else:
            z, x = None, zx
        # inputs promote to the parameters' dtype, as flax Dense promotes them
        z = z.to(dt) if z is not None else None
        x = x.to(dt)

        if x.shape[-1] > 0:
            x = self.lin_in(x)
        else:
            x = torch.zeros(x.shape[:-1] + (self.d_hidden,), dtype=dt, device=x.device)
        for blkid in range(self.n_blocks):
            if blkid == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims, self.combine_type)
            if self.d_latent > 0 and blkid < self.combine_layer:
                tz = self.lin_z[blkid](z)
                if self.use_spade:
                    x = self.scale_z[blkid](z) * x + tz
                else:
                    x = x + tz
            x = self.blocks[blkid](x)
        out = self.lin_out(self.act(x))
        if planar_out:
            out = out.transpose(-1, -2)
        return out

    @classmethod
    def from_conf(cls, conf, d_in: int, d_latent: int = 0, **kwargs) -> "ResnetFC":
        return cls(
            d_in=d_in,
            n_blocks=conf.get_int("n_blocks", 5),
            d_hidden=conf.get_int("d_hidden", 128),
            beta=conf.get_float("beta", 0.0),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            use_spade=conf.get_bool("use_spade", False),
            d_latent=d_latent,
            **kwargs,
        )
