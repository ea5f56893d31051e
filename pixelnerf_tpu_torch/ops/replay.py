"""The kernel calls a run made, replayed against their plain versions.

While a :class:`KernelCalls` is installed in a process, the first call of
each kernel wrapper at each (kernel, hidden width, point count; for a
forward wrapper also the tower, so each head of a model is kept) is kept
with copies of its inputs and of its output: the four forward wrappers of
:mod:`.resnetfc_fused` (rows 1-4, their ``_code`` twins row 6) and the two
backward kernels of :mod:`.resnetfc_vjp` (``bwd_data`` row 5a,
``bwd_weights`` row 5b).  The wrappers still launch and count as before.
:meth:`KernelCalls.check` launches each kept call again and holds it
against its plain version on the same inputs with the Pallas tests' bar:
max |d| <= 0.015 max(1, max |ref|) and correlation > 0.999, the second
launch bit for bit the first.  This is how a run inside the ranks of a
multi-device launch shows what its kernels computed; the replay's own
launches are not counted.
"""

from __future__ import annotations

import inspect
from typing import List, Tuple

import torch

from . import resnetfc_fused as rf
from . import resnetfc_vjp as rv

FORWARD = ("resnetfc_gather", "resnetfc_gather_mv", "resnetfc_dense", "resnetfc_dense_mv")
BACKWARD = ("bwd_data", "bwd_weights")


def agree(out: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float, float]:
    """(max |d|, bar, corr) with the Pallas tests' bar."""
    out, ref = out.float(), ref.float()
    d = (out - ref).abs().max().item() if out.numel() else 0.0
    bar = 0.015 * max(1.0, ref.abs().max().item() if ref.numel() else 0.0)
    if out.numel() < 2:
        return d, bar, 1.0
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1].item()
    return d, bar, corr


def _copy(v):
    """A deep copy of a call's tensors (named tuples, tuples, dicts)."""
    if torch.is_tensor(v):
        return v.detach().clone()
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_copy(x) for x in v))
    if isinstance(v, (tuple, list)):
        return type(v)(_copy(x) for x in v)
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    return v


def _same(a, b) -> bool:
    """Every tensor of ``a`` bit for bit ``b``'s."""
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a == b


class KernelCalls:
    """Keeps the first call of each kernel wrapper at each shape while
    installed (``with KernelCalls() as calls:``); :meth:`check` replays them."""

    def __init__(self):
        self.calls = {}
        self._orig = []

    def __enter__(self):
        for mod, names in ((rf, FORWARD), (rv, BACKWARD)):
            for name in names:
                fn = getattr(mod, name)
                self._orig.append((mod, name, fn))
                setattr(mod, name, self._recorder(name, fn, inspect.signature(fn)))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)
        self._orig = []

    def _key(self, name: str, a: dict) -> tuple:
        if name == "bwd_weights":
            return ("resnetfc_bwd_weights", a["tower"].w_in.shape[1], a["data"].B, a["data"].NS)
        if name == "bwd_data":
            return ("resnetfc_bwd_data", a["tower"].w_in.shape[1], a["g"].shape[1], a["NS"])
        code = isinstance(a["x"], rf.RawCode)
        variant = "resnetfc_fwd_" + name[len("resnetfc_"):] + ("_code" if code else "")
        return (variant, a["tower"].w_in.shape[1], rf.coords(a["x"]).shape[0],
                a["tower"].w_in.data_ptr())

    def _recorder(self, name, fn, sig):
        def call(*args, **kwargs):
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            key = self._key(name, a.arguments)
            keep = key not in self.calls
            inputs = _copy(dict(a.arguments)) if keep else None
            out = fn(*args, **kwargs)
            if keep:
                self.calls[key] = (fn, inputs, _copy(out))
            return out

        return call

    def launches(self) -> List[str]:
        """The kernels whose calls were kept."""
        return sorted({k[0] for k in self.calls})

    def check(self) -> List[dict]:
        """Each kept call launched again and held against its plain version
        -> ``[{kernel, H, points, max_abs_err, bar, corr, identical, ok}]``."""
        rows = []
        with torch.no_grad():
            for (kernel, H, n, _), (fn, a, out) in self.calls.items():
                if kernel == "resnetfc_bwd_data":
                    rows.append(self._check_data(kernel, H, n, fn, a, out))
                elif kernel == "resnetfc_bwd_weights":
                    rows.append(self._check_weights(kernel, H, n, fn, a, out))
                else:
                    rows.append(self._check_forward(kernel, H, n, fn, a, out))
        return rows

    @staticmethod
    def _row(kernel, H, n, d, bar, corr, same, finite=True) -> dict:
        return dict(kernel=kernel, H=H, points=n, max_abs_err=d, bar=bar, corr=corr,
                    identical=same, ok=bool(d <= bar and corr > 0.999 and same and finite))

    def _check_forward(self, kernel, H, n, fn, a, out) -> dict:
        bf = torch.bfloat16
        again = fn(**a)
        if "gather" in kernel:
            z = rf.gather_reference(a["idx"], a["w"], a["table"] if "table" in a else a["tables"],
                                    bf)
        else:
            z = a["z"]
        mv = {}
        if kernel.startswith("resnetfc_fwd_gather_mv"):
            mv = dict(NS=a["tables"].shape[0], combine_layer=a["combine_layer"])
        elif kernel.startswith("resnetfc_fwd_dense_mv"):
            mv = dict(NS=a["NS"], sb=a["sb"], combine_layer=a["combine_layer"])
        ref = rf.resnetfc_reference(z, a["x"], a["tower"], a["n_blocks"], a["planar_out"],
                                    compute_dtype=bf, **mv)
        d, bar, corr = agree(again, ref)
        return self._row(kernel, H, n, d, bar, corr, torch.equal(again, out),
                         bool(torch.isfinite(again).all()))

    def _check_data(self, kernel, H, n, fn, a, out) -> dict:
        """dz and dx against the plain backward walked through the kernel's
        own stashed operands."""
        again = fn(**a)
        B = again.B
        kw = dict(NS=a["NS"], sb=a["sb"], combine_layer=a["combine_layer"]) if a["NS"] > 1 else {}
        ref = rv.resnetfc_bwd_reference(a["g"], a["z"], a["x"], a["tower"], a["n_blocks"],
                                        a["need_dx"], torch.bfloat16,
                                        operands=again.ws_act[:, :B].float(), **kw)
        d, bar, corr = 0.0, 0.0, 1.0
        for name in ("dz", "dx"):
            got = getattr(again, name)
            if got is None or getattr(ref, name) is None:
                continue
            d1, bar1, c1 = agree(got, getattr(ref, name))
            if d1 / bar1 > (d / bar if bar else -1.0):
                d, bar = d1, bar1
            corr = min(corr, c1)
        same = torch.equal(again.ws_act[:, :B], out.ws_act[:, :B]) and all(
            _same(getattr(again, f), getattr(out, f))
            for f in ("dz", "dx") if getattr(out, f) is not None)
        return self._row(kernel, H, n, d, bar, corr, same)

    def _check_weights(self, kernel, H, n, fn, a, out) -> dict:
        """Every gradient against ``bwd_weights_reference`` on the same
        DataOut."""
        again = fn(**a)
        ref = rv.bwd_weights_reference(a["z"], a["data"], a["tower"], a["n_blocks"])
        d, bar, corr = 0.0, 0.0, 1.0
        for name in rv.Grads._fields:
            got = getattr(again, name)
            if got is None or getattr(ref, name) is None or name in ("dz", "dx"):
                continue
            d1, bar1, c1 = agree(got, getattr(ref, name))
            if d1 / bar1 > (d / bar if bar else -1.0):
                d, bar = d1, bar1
            corr = min(corr, c1)
        return self._row(kernel, H, n, d, bar, corr, _same(tuple(again), tuple(out)))
