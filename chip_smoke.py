"""On-card smoke run of the PyTorch/CUDA port (``pixelnerf_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero, printing no result, without one.  Phases,
one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile every kernel from ``pixelnerf_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once; ptxas registers and spills per kernel;
3. kernel checks: each forward kernel against its plain PyTorch version at
   the main paths' shapes (one ray chunk x 64 and x 96 samples; the
   single-view kernels on a 1024 x 512 table, the multi-view gather at NS 2
   on two encoded source views, the multi-view dense kernel at NS 3 and at
   the train layout SB 4 x NS 3 x 128 rays x 96), to
   ``max|d| <= 0.015 * max(1, max|ref|)`` and ``corr > 0.999``, with its time
   beside the plain version's, a cuBLAS bf16 chain's and the card's bound;
   then the deferred positional code (row 6 of PERF.md) in each forward
   kernel -- its CODE variant fed the raw (xyz, viewdir) coordinates, at the
   fine pass's 393,216 points, NS 2 for the multi-view gather and NS 3 for
   the multi-view dense kernel -- against its plain version at the same bar,
   and against the same kernel fed the pre-encoded code;
4. main path: the full-width sn64 model (seeded weights, random encoder)
   renders 64x64 ring frames from one source view on the kernel route; the
   gather kernel must have launched, and frame 0 must agree with the plain
   route to >= 40 dB PSNR;
5. dense route: ``PIXELNERF_FUSED_GATHER_MAX_ROWS=0`` renders frame 0 through
   the dense kernel, which must have launched;
6. multi-view render: the same ring from source views (0, 1) and then
   (0, 1, 2); the first must launch the multi-view gather kernel (NS x T =
   2048 rows, within the fused-gather cap), the second the multi-view dense
   kernel (3072 rows, over it); frame 0 of each against the plain route to
   >= 40 dB;
7. deferred-code renders: with ``PIXELNERF_DEFER_CODE=1``, ring frame 0
   from views (0), (0, 1) and (0, 1, 2) and once on the dense route; each
   must launch the code variant of the kernel its route takes and not the
   encoded-input one, and agree with the plain route to >= 40 dB;
8. backward kernel checks at the train step's shapes (4 x 128 rays x 64 and
   x 96 samples, at -V 1 and at -V 3): the kernels' stashed forward operands
   against the plain recompute, every output (dz, dx, each dW and db) against
   the plain backward walked through the same operands at the bar above, and
   against the fully independent plain backward at ``corr > 0.999``; two
   calls must be bit-identical; times beside the plain version's, the
   autograd backward of the cuBLAS chain and the bound;
9. train-step parity at -V 1 and at -V 3: one sn64 step on the kernel route
   (AMP) and one on the plain f32 route from the same weights, batch and
   draws: losses within 1%, ``grad_norm`` within 2%, cosine >= 0.99 between
   each head's and the encoder's gradients;
10. train path: ``python -m pixelnerf_tpu_torch.train`` in-process on the
   synthetic data, 12 one-step epochs at -V 1 and 6 at -V 3; the forward
   kernel of the view count and both backward kernels launch twice per step,
   no other forward kernel launches, the losses stay finite and
   ``pixel_nerf_latest`` is written;
11. eval path: ``python -m pixelnerf_tpu_torch.eval.eval`` in-process with
    ``PIXELNERF_DEFER_CODE=1`` on a checkpoint of the render phases' model,
    ``-F synthetic --split test -P "0" --max_objs 2``: the single-view gather
    kernel's code variant launches, PSNR/SSIM are finite, ``finish.txt``
    holds 2 lines and the PNGs exist; a second run resumes and renders
    nothing; one object from ``-P "0 1 2"`` goes through the multi-view
    dense kernel's code variant.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM peaks (data sheet, dense): bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
FRAME = 64
N_FRAMES = 3
RAYS_PER_STEP = FRAME * FRAME  # one frame per render step: frame 0 is step 0
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.float() - b.float()) ** 2).item()
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


def agree(out: torch.Tensor, ref: torch.Tensor):
    """(max |d|, bar, corr) with the Pallas tests' bar (tests/test_pallas.py)."""
    d = (out - ref).abs().max().item()
    bar = 0.015 * max(1.0, ref.abs().max().item())
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1].item()
    return d, bar, corr


def library_tower(z, x, tw, n_blocks):
    """The tower as a chain of cuBLAS bf16 products (bf16 in and out): the
    yardstick for ``library_ms``; the port never calls it."""
    tw = type(tw)(*(t.bfloat16() for t in tw[:8]), tw.d_in)
    h = torch.addmm(tw.b_in, x.bfloat16(), tw.w_in[: tw.d_in])
    for k in range(n_blocks):
        if k < tw.w_z.shape[0]:
            h = h + torch.addmm(tw.b_z[k], z, tw.w_z[k])
        t = torch.addmm(tw.b_blk[k, 0], torch.relu(h), tw.w_blk[k, 0])
        h = h + torch.addmm(tw.b_blk[k, 1], torch.relu(t), tw.w_blk[k, 1])
    return torch.addmm(tw.b_out, torch.relu(h), tw.w_out).t()


def library_tower_mv(z, x, tw, n_blocks, NS, combine_layer):
    """The multi-view tower (rows 3-4 of PERF.md) as a cuBLAS bf16 chain:
    per-view rows (NS, B, .) up to ``combine_layer``, their mean, the shared
    tail: the yardstick for ``library_ms``; the port never calls it."""
    tw = type(tw)(*(t.bfloat16() for t in tw[:8]), tw.d_in)
    h = torch.matmul(x.bfloat16(), tw.w_in[: tw.d_in]) + tw.b_in
    for k in range(n_blocks):
        if k == combine_layer:
            h = h.mean(0)
        if k < combine_layer:
            h = h + (torch.matmul(z, tw.w_z[k]) + tw.b_z[k])
        t = torch.matmul(torch.relu(h), tw.w_blk[k, 0]) + tw.b_blk[k, 0]
        h = h + (torch.matmul(torch.relu(t), tw.w_blk[k, 1]) + tw.b_blk[k, 1])
    return (torch.matmul(torch.relu(h), tw.w_out) + tw.b_out).t()


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.dot(a, b) / (a.norm() * b.norm() + 1e-30)).item()


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# template arguments of the kernels, for naming ptxas' entry functions
TEMPLATE_ARGS = {"resnetfc_fwd_kernel": ("GATHER", "MV", "CODE"),
                 "resnetfc_bwd_data_kernel": ("MV",)}


def ptxas_summary(log: str) -> dict:
    """{kernel<args>: "N registers, S B spill stores, L B spill loads"} from
    nvcc's ``-Xptxas -v`` output."""
    out, name, spill = {}, None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            # the anonymous namespace's mangled name holds the file name too
            k = re.search(r"\d(resnetfc_[a-z_]+_kernel)(I(?:Lb[01]E)+E)?", m.group(1))
            base = k.group(1) if k else m.group(1)
            bools = re.findall(r"Lb([01])E", k.group(2) or "") if k else []
            args = ",".join(f"{a}={b}" for a, b in zip(TEMPLATE_ARGS.get(base, ()), bools))
            name = f"{base}<{args}>" if args else base
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            st = re.search(r"(\d+) bytes spill stores", spill)
            ld = re.search(r"(\d+) bytes spill loads", spill)
            out[name] = (f"{regs} registers, {st.group(1) if st else '?'} B spill stores, "
                         f"{ld.group(1) if ld else '?'} B spill loads")
            name, spill = None, ""
    return out


def mv_latent(tables, idx, w, sb: int):
    """Dense bf16 latents of object-major rows (sb, NS, B_obj): row (s, v, b)
    is the 4-tap lookup ``idx``/``w`` (same rows) into ``tables[v]``."""
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    NS = tables.shape[0]
    i4, w4 = idx.reshape(sb, NS, -1, idx.shape[-1]), w.reshape(sb, NS, -1, w.shape[-1])
    z = torch.stack([
        rf.gather_reference(i4[:, v].reshape(-1, idx.shape[-1]), w4[:, v].reshape(-1, w.shape[-1]),
                            tables[v], torch.bfloat16).reshape(sb, -1, tables.shape[-1])
        for v in range(NS)], dim=1)
    return z.reshape(-1, tables.shape[-1]).to(torch.bfloat16)


def by_view(a: torch.Tensor, NS: int, sb: int) -> torch.Tensor:
    """Object-major rows (sb * NS * B_obj, D) -> (NS, sb * B_obj, D), the
    cuBLAS chain's layout."""
    return a.reshape(sb, NS, -1, a.shape[-1]).transpose(0, 1).reshape(NS, -1, a.shape[-1])


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        sys.exit(2)
    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.device import resolve_device
    from pixelnerf_tpu_torch.models.code import PositionalEncoding
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_taps

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.device_count()} visible")

    # ---- build ----
    t0 = time.perf_counter()
    builds = rf.build_all()
    log("build: " + json.dumps({
        "kernels": list(rf.LAUNCHES) + ["resnetfc_bwd_data", "resnetfc_bwd_weights"],
        "sources": [str(rf.SOURCES[n].relative_to(rf.CSRC.parent.parent)) for n in builds],
        "libraries": [b.library.name for b in builds.values()],
        "compiled": {n: b.compiled for n, b in builds.items()},
        "seconds": round(time.perf_counter() - t0, 3),
        "ptxas": {n: ptxas_summary(b.log) for n, b in builds.items()},
    }))

    # ---- the main path's model: full sn64 width, seeded, every block live ----
    conf = entry.load_conf(pretrained=False)
    net = entry.build_model(conf, dev, mlp_impl="auto", seed=SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:  # fc_1 starts at zero, which would leave fc_0 unused
                blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
    mlp = net.mlp_fine
    tw = mlp.tower(dev)
    nb, H, C = mlp.n_blocks, mlp.d_hidden, mlp.d_latent
    n_lin_z, d_in, d_out = mlp.n_lin_z, mlp.d_in, mlp.d_out
    src = entry.source_view(FRAME, SEED)
    src3 = entry.source_view(FRAME, SEED, views=(0, 1, 2))  # the same object, three views
    with torch.no_grad():
        scene = net.encode(torch.as_tensor(src["images"], device=dev),
                           torch.as_tensor(src["poses"], device=dev), float(src["focal"]))
        scene3 = net.encode(torch.as_tensor(src3["images"], device=dev),
                            torch.as_tensor(src3["poses"], device=dev), float(src3["focal"]))
    table = scene.latents.reshape(-1, C).to(torch.bfloat16).contiguous()
    T = table.shape[0]
    tables3 = scene3.latents.reshape(3, T, C).to(torch.bfloat16).contiguous()
    cl = mlp.combine_layer

    # ---- kernel checks at the main path's shapes ----
    gi = torch.Generator(device=dev).manual_seed(SEED + 2)
    code = PositionalEncoding.from_conf(conf["model.code"], d_in=3)
    records = {"resnetfc_fwd_gather": {}, "resnetfc_fwd_dense": {}}
    gather_ms = {}  # per pass shape, for the kernels' share of a frame
    flops_pt = 2 * H * (d_in + n_lin_z * C + 2 * nb * H + d_out)
    w_bytes = sum(t.numel() * t.element_size() for t in tw[:8])
    for K in (64, 96):
        B = RAYS_PER_STEP * K
        pts = torch.rand(B, 3, device=dev, generator=gi) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn(B, 3, device=dev, generator=gi), dim=-1)
        x = torch.cat([code(pts), vd], dim=-1).contiguous()
        uv = torch.rand(B, 2, device=dev, generator=gi) * 2 - 1
        side = int(math.isqrt(T))
        idx, w = bilinear_taps(uv, side, side, pad_taps_to=8)
        idx, w = idx.contiguous(), w.contiguous()
        with torch.no_grad():
            z = rf.gather_reference(idx, w, table, torch.bfloat16).to(torch.bfloat16)
            cases = {
                "resnetfc_fwd_gather": (
                    lambda: rf.resnetfc_gather(idx, w, table, x, tw, nb),
                    lambda: rf.resnetfc_reference(
                        rf.gather_reference(idx, w, table, torch.bfloat16), x, tw, nb,
                        compute_dtype=torch.bfloat16),
                    lambda: library_tower(
                        (table[idx[:, :4].long()] * w[:, :4, None].bfloat16()).sum(1), x, tw, nb),
                    B * (idx.shape[1] * 4 + w.shape[1] * 4 + d_in * 4 + d_out * 4) + T * C * 2,
                    8 * C,  # the 4-tap weighted sum
                    "pixelnerf_tpu/ops/resnetfc_pallas.py:248",
                ),
                "resnetfc_fwd_dense": (
                    lambda: rf.resnetfc_dense(z, x, tw, nb),
                    lambda: rf.resnetfc_reference(z, x, tw, nb, compute_dtype=torch.bfloat16),
                    lambda: library_tower(z, x, tw, nb),
                    B * (C * 2 + d_in * 4 + d_out * 4),
                    0,
                    "pixelnerf_tpu/ops/resnetfc_pallas.py:175",
                ),
            }
            for name, (kern, plain, library, in_bytes, extra_flops, replaces) in cases.items():
                out = kern()
                torch.cuda.synchronize()
                ref = plain()
                d, bar, corr = agree(out, ref)
                ok = d <= bar and corr > 0.999 and bool(torch.isfinite(out).all())
                ms = cuda_ms(kern, 5)
                plain_ms = cuda_ms(plain, 3)
                library_ms = cuda_ms(library, 5)
                b_ms, b_by = bound(B * (flops_pt + extra_flops), in_bytes + w_bytes)
                log(f"kernel check: {name} B={B} (chunk {RAYS_PER_STEP} rays x {K}) "
                    f"max|d| {d:.6g} <= bar {bar:.6g}: {d <= bar}, corr {corr:.7f}; "
                    f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                    f"bound_ms {b_ms:.4f} ({b_by})")
                if not ok:
                    raise SystemExit(f"kernel check failed: {name} at B={B}")
                if name == "resnetfc_fwd_gather":
                    gather_ms[K] = ms
                rec = records[name]
                rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), d)
                if K == 96:  # times at the fine pass's shape
                    rec.update(name=name, route="cuda",
                               source="pixelnerf_tpu_torch/csrc/resnetfc_fwd.cu",
                               replaces=replaces, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=library_ms)
            del out, ref

    # ---- multi-view forward kernel checks at the multi-view paths' shapes ----
    # the NS = 2 render's gather on the encoded tables of views 0 and 1; the
    # NS = 3 render's dense route; the -V 3 train step's layout (SB 4 objects
    # x NS 3 views x 128 rays x 96 samples)
    flops_mv = {NS: 2 * H * (NS * (d_in + cl * (C + 2 * H)) + 2 * (nb - cl) * H + d_out)
                for NS in (2, 3)}
    records.update({"resnetfc_fwd_gather_mv": {}, "resnetfc_fwd_dense_mv": {}})
    mv_ms = {}  # (kernel, samples) -> ms, for the kernels' share of a frame
    mv_cases = [("resnetfc_fwd_gather_mv", 2, 1, RAYS_PER_STEP, K) for K in (64, 96)]
    mv_cases += [("resnetfc_fwd_dense_mv", 3, 1, RAYS_PER_STEP, K) for K in (64, 96)]
    mv_cases += [("resnetfc_fwd_dense_mv", 3, 4, 128, 96)]
    for name, NS, sb, n_rays, K in mv_cases:
        B = sb * n_rays * K  # output points
        rows = NS * B
        pts = torch.rand(rows, 3, device=dev, generator=gi) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn(rows, 3, device=dev, generator=gi), dim=-1)
        x = torch.cat([code(pts), vd], dim=-1).contiguous()
        side = int(math.isqrt(T))
        idx, w = bilinear_taps(torch.rand(rows, 2, device=dev, generator=gi) * 2 - 1, side, side,
                               pad_taps_to=8)
        idx, w = idx.contiguous(), w.contiguous()
        tabs = tables3[:NS].contiguous()
        with torch.no_grad():
            z = mv_latent(tabs, idx, w, sb)
            xv = by_view(x, NS, sb)
            if name == "resnetfc_fwd_gather_mv":
                views = torch.arange(NS, device=dev)[:, None, None]
                kern = lambda: rf.resnetfc_gather_mv(idx, w, tabs, x, tw, nb, cl)  # noqa: E731
                library = lambda: library_tower_mv(  # noqa: E731
                    (tabs[views, idx[:, :4].reshape(NS, B, 4).long()]
                     * w[:, :4].reshape(NS, B, 4, 1).bfloat16()).sum(2), xv, tw, nb, NS, cl)
                in_bytes = rows * (idx.shape[1] * 4 + w.shape[1] * 4 + d_in * 4) + NS * T * C * 2
                extra = NS * 8 * C  # the 4-tap weighted sums
                replaces = "pixelnerf_tpu/ops/resnetfc_pallas.py:463"
            else:
                zv = by_view(z, NS, sb)
                kern = lambda: rf.resnetfc_dense_mv(z, x, tw, nb, NS, cl, sb)  # noqa: E731
                library = lambda: library_tower_mv(zv, xv, tw, nb, NS, cl)  # noqa: E731
                in_bytes = rows * (C * 2 + d_in * 4)
                extra = 0
                replaces = "pixelnerf_tpu/ops/resnetfc_pallas.py:399"
            plain = lambda: rf.resnetfc_reference(  # noqa: E731
                z, x, tw, nb, compute_dtype=torch.bfloat16, NS=NS, sb=sb, combine_layer=cl)
            out = kern()
            torch.cuda.synchronize()
            ref = plain()
            d, bar, corr = agree(out, ref)
            ok = (d <= bar and corr > 0.999 and bool(torch.isfinite(out).all())
                  and out.shape == (d_out, B))
            ms = cuda_ms(kern, 5)
            plain_ms = cuda_ms(plain, 2)
            library_ms = cuda_ms(library, 3)
            b_ms, b_by = bound(B * (flops_mv[NS] + extra), in_bytes + B * d_out * 4 + w_bytes)
            log(f"kernel check: {name} NS={NS} SB={sb} x {n_rays} rays x {K} = {B} points "
                f"({rows} rows) max|d| {d:.6g} <= bar {bar:.6g}: {d <= bar}, corr {corr:.7f}; "
                f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                f"bound_ms {b_ms:.4f} ({b_by}); {B * flops_mv[NS] / ms / 1e9:.1f} TFLOP/s")
            if not ok:
                raise SystemExit(f"kernel check failed: {name} NS={NS} SB={sb} at B={B}")
            rec = records[name]
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), d)
            if sb == 1:
                mv_ms[(name, K)] = ms
                if K == 96:  # times at the render's fine pass
                    rec.update(name=name, route="cuda",
                               source="pixelnerf_tpu_torch/csrc/resnetfc_fwd.cu",
                               replaces=replaces, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=library_ms)
            del out, ref, z, x, idx, w, xv, pts, vd

    # ---- row 6: the deferred positional code in each forward kernel ----
    # every CODE variant at the fine pass (4096 rays x 96 = 393,216 output
    # points) on the raw (xyz, viewdir) coordinates, against its plain
    # version (the code in f32, then the bf16 tower) and against the same
    # kernel fed the pre-encoded code, where only bf16 rounding flips of the
    # code may differ
    code_arrays = [torch.from_numpy(a).to(dev) for a in code.flat_arrays(tail=3)]
    d_raw = code_arrays[0].shape[0]
    code_records = {}
    B = RAYS_PER_STEP * 96
    for name, NS in (("resnetfc_fwd_gather_code", 1), ("resnetfc_fwd_dense_code", 1),
                     ("resnetfc_fwd_gather_mv_code", 2), ("resnetfc_fwd_dense_mv_code", 3)):
        rows = NS * B
        pts = torch.rand(rows, 3, device=dev, generator=gi) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn(rows, 3, device=dev, generator=gi), dim=-1)
        rc = rf.RawCode(torch.cat([pts, vd], dim=-1).contiguous(), *code_arrays)
        side = int(math.isqrt(T))
        idx, w = bilinear_taps(torch.rand(rows, 2, device=dev, generator=gi) * 2 - 1, side, side,
                               pad_taps_to=8)
        idx, w = idx.contiguous(), w.contiguous()
        with torch.no_grad():
            x_enc = rf.materialize_code(rc)  # the plain version's f32 code
            tabs = table if NS == 1 else tables3[:NS].contiguous()
            # the bf16 latents the dense kernels read (the gather kernels build
            # the same from the table)
            zl = (rf.gather_reference(idx, w, table, torch.bfloat16) if NS == 1
                  else mv_latent(tabs, idx, w, 1)).to(torch.bfloat16)
            if name == "resnetfc_fwd_gather_code":
                kern = lambda x: rf.resnetfc_gather(idx, w, table, x, tw, nb)  # noqa: E731
            elif name == "resnetfc_fwd_dense_code":
                kern = lambda x: rf.resnetfc_dense(zl, x, tw, nb)  # noqa: E731
            elif name == "resnetfc_fwd_gather_mv_code":
                kern = lambda x: rf.resnetfc_gather_mv(idx, w, tabs, x, tw, nb, cl)  # noqa: E731
            else:
                kern = lambda x: rf.resnetfc_dense_mv(zl, x, tw, nb, NS, cl)  # noqa: E731
            kw = dict(NS=NS, combine_layer=cl) if NS > 1 else {}
            plain = lambda: rf.resnetfc_reference(zl, rc, tw, nb,  # noqa: E731
                                                  compute_dtype=torch.bfloat16, **kw)
            # the yardstick: the code in torch, then rows 1-4's cuBLAS chains
            # (with the lookup for the gather variants)
            if name == "resnetfc_fwd_gather_code":
                library = lambda: library_tower(  # noqa: E731
                    (table[idx[:, :4].long()] * w[:, :4, None].bfloat16()).sum(1),
                    rf.materialize_code(rc), tw, nb)
            elif name == "resnetfc_fwd_dense_code":
                library = lambda: library_tower(zl, rf.materialize_code(rc), tw, nb)  # noqa: E731
            elif name == "resnetfc_fwd_gather_mv_code":
                views = torch.arange(NS, device=dev)[:, None, None]
                library = lambda: library_tower_mv(  # noqa: E731
                    (tabs[views, idx[:, :4].reshape(NS, B, 4).long()]
                     * w[:, :4].reshape(NS, B, 4, 1).bfloat16()).sum(2),
                    by_view(rf.materialize_code(rc), NS, 1), tw, nb, NS, cl)
            else:
                zv = by_view(zl, NS, 1)
                library = lambda: library_tower_mv(  # noqa: E731
                    zv, by_view(rf.materialize_code(rc), NS, 1), tw, nb, NS, cl)
            before = dict(rf.LAUNCHES)
            out = kern(rc)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in rf.LAUNCHES.items() if v != before[k]}
            ref = plain()
            d, bar, corr = agree(out, ref)
            out_enc = kern(x_enc)
            d_enc = (out - out_enc).abs().max().item()
            ok = (d <= bar and corr > 0.999 and bool(torch.isfinite(out).all())
                  and out.shape == (d_out, B) and launched == {name: 1})
            ms = cuda_ms(lambda: kern(rc), 5)
            enc_ms = cuda_ms(lambda: kern(x_enc), 5)
            plain_ms = cuda_ms(plain, 2)
            library_ms = cuda_ms(library, 3)
            f_pt = flops_pt if NS == 1 else flops_mv[NS]
            gather = "gather" in name
            in_bytes = (rows * (d_raw * 4 + ((idx.shape[1] + w.shape[1]) * 4 if gather else C * 2))
                        + (NS * T * C * 2 if gather else 0))
            b_ms, b_by = bound(B * f_pt + rows * (2 * d_raw * d_in + (8 * C if gather else 0)),
                               in_bytes + B * d_out * 4 + w_bytes)
            log(f"kernel check: {name} (row 6, _x_feat in the "
                f"{name.removesuffix('_code')} kernel) NS={NS} B={B} ({rows} rows, raw d {d_raw} "
                f"-> code d {d_in}) max|d| {d:.6g} <= bar {bar:.6g}: {d <= bar}, corr {corr:.7f}; "
                f"vs the same kernel on the pre-encoded code max|d| {d_enc:.6g}; launches "
                f"{launched}; kernel_ms {ms:.4f} (encoded input {enc_ms:.4f}, ratio "
                f"{ms / enc_ms:.4f}) plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                f"bound_ms {b_ms:.4f} ({b_by})")
            if not ok:
                raise SystemExit(f"kernel check failed: {name}")
            code_records[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                      library_ms=library_ms, max_abs_err=d, encoded_ms=enc_ms,
                                      encoded_max_abs_err=d_enc, points=B, rows=rows)
            del out, ref, out_enc, x_enc, zl, rc, idx, w, pts, vd

    # ---- main path: full-width sn64 ring render on the kernel route ----
    rays = entry.ring_rays(src, N_FRAMES)
    log("main path: sn64 full width (ResNet34 4 layers, ResnetFC 512 x 5 blocks), "
        "seeded weights, encoder.pretrained=false (random backbone), fc_1 ~ N(0, 0.02^2); "
        f"{N_FRAMES} frames of {FRAME}x{FRAME}, {RAYS_PER_STEP} rays per step")
    torch.cuda.synchronize()
    rf.reset_launches()
    t0 = time.perf_counter()
    rgb, depth = entry.render_ring(net, conf, src, rays,
                                   torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    main_launches = dict(rf.LAUNCHES)
    frames = rgb.reshape(N_FRAMES, FRAME, FRAME, 3)
    ok = (bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(depth).all())
          and frames.shape == (N_FRAMES, FRAME, FRAME, 3))
    log(f"main path: launches {main_launches}; {rays.shape[0]} rays in {dt:.4f} s = "
        f"{rays.shape[0] / dt:.1f} rays/s (encode + render, first call) on {smi}; "
        f"finite {ok}; rgb range [{rgb.min().item():.4f}, {rgb.max().item():.4f}]")
    if not ok or main_launches["resnetfc_fwd_gather"] == 0:
        raise SystemExit("main path failed or did not launch the gather kernel")
    records["resnetfc_fwd_gather"]["launches"] = main_launches["resnetfc_fwd_gather"]
    t0 = time.perf_counter()
    entry.render_ring(net, conf, src, rays, torch.Generator(device=dev).manual_seed(SEED),
                      RAYS_PER_STEP)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    frame_kernel_ms = gather_ms[64] + gather_ms[96]  # coarse + fine pass of one frame
    log(f"main path, second call: {rays.shape[0]} rays in {steady:.4f} s = "
        f"{rays.shape[0] / steady:.1f} rays/s; gather kernel {frame_kernel_ms:.3f} ms per "
        f"frame = {frame_kernel_ms * N_FRAMES / 1e3 / steady:.3f} of the render time")

    plain_net = entry.build_model(conf, dev, mlp_impl="torch", seed=SEED)
    plain_net.load_state_dict(net.state_dict())
    rf.reset_launches()
    rgb_p, _ = entry.render_ring(plain_net, conf, src, rays[:RAYS_PER_STEP],
                                 torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP)
    torch.cuda.synchronize()
    p_plain = psnr(rgb[:RAYS_PER_STEP], rgb_p)
    log(f"main path: frame 0 kernel route vs plain route (f32 torch, same generator seed) "
        f"PSNR {p_plain:.3f} dB (need >= 40); plain-route launches {dict(rf.LAUNCHES)}")
    if not p_plain >= 40.0 or any(rf.LAUNCHES.values()):
        raise SystemExit("kernel route disagrees with the plain route")
    plain_frame0 = {(0,): rgb_p}  # the plain route's frame 0 per source views

    # ---- dense route: no fused gather ----
    os.environ["PIXELNERF_FUSED_GATHER_MAX_ROWS"] = "0"
    try:
        torch.cuda.synchronize()
        rf.reset_launches()
        rgb_d, _ = entry.render_ring(net, conf, src, rays[:RAYS_PER_STEP],
                                     torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP)
        torch.cuda.synchronize()
        dense_launches = dict(rf.LAUNCHES)
    finally:
        del os.environ["PIXELNERF_FUSED_GATHER_MAX_ROWS"]
    p_dense = psnr(rgb[:RAYS_PER_STEP], rgb_d)
    log(f"dense route: PIXELNERF_FUSED_GATHER_MAX_ROWS=0, frame 0: launches {dense_launches}; "
        f"vs gather route PSNR {p_dense:.3f} dB; finite {bool(torch.isfinite(rgb_d).all())}")
    if dense_launches["resnetfc_fwd_dense"] == 0 or not bool(torch.isfinite(rgb_d).all()):
        raise SystemExit("dense route did not launch the dense kernel")
    records["resnetfc_fwd_dense"]["launches"] = dense_launches["resnetfc_fwd_dense"]

    # ---- multi-view render: 2 and 3 source views of the same object ----
    for views, kname in (((0, 1), "resnetfc_fwd_gather_mv"), ((0, 1, 2), "resnetfc_fwd_dense_mv")):
        NS = len(views)
        fused = net._fused_gather_ok(scene3.latents[:NS], NS)
        torch.cuda.synchronize()
        rf.reset_launches()
        t0 = time.perf_counter()
        rgb_m, depth_m = entry.render_ring(net, conf, src3, rays,
                                           torch.Generator(device=dev).manual_seed(SEED),
                                           RAYS_PER_STEP, views=views)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        mv_launches = dict(rf.LAUNCHES)
        t0 = time.perf_counter()
        entry.render_ring(net, conf, src3, rays, torch.Generator(device=dev).manual_seed(SEED),
                          RAYS_PER_STEP, views=views)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        rf.reset_launches()
        rgb_p, _ = entry.render_ring(plain_net, conf, src3, rays[:RAYS_PER_STEP],
                                     torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP,
                                     views=views)
        torch.cuda.synchronize()
        plain_launches = dict(rf.LAUNCHES)
        plain_frame0[views] = rgb_p
        p_mv = psnr(rgb_m[:RAYS_PER_STEP], rgb_p)
        frame_ms = mv_ms[(kname, 64)] + mv_ms[(kname, 96)]
        finite = bool(torch.isfinite(rgb_m).all()) and bool(torch.isfinite(depth_m).all())
        log(f"multi-view render: source views {list(views)} (NS={NS}, NS x T = {NS * T} rows, "
            f"fused gather {fused}): launches {mv_launches}; {rays.shape[0]} rays in {dt:.4f} s "
            f"(encode + render, first call), second call {steady:.4f} s = "
            f"{rays.shape[0] / steady:.1f} rays/s; {kname} {frame_ms:.3f} ms per frame = "
            f"{frame_ms * N_FRAMES / 1e3 / steady:.3f} of the render time; frame 0 vs plain route "
            f"PSNR {p_mv:.3f} dB (need >= 40); plain-route launches {plain_launches}; "
            f"finite {finite}")
        others = [k for k in mv_launches if k != kname]
        if not (finite and p_mv >= 40.0 and mv_launches[kname] > 0
                and not any(mv_launches[k] for k in others) and not any(plain_launches.values())
                and fused == (kname == "resnetfc_fwd_gather_mv")):
            raise SystemExit(f"multi-view render from views {views} failed or missed {kname}")
        records[kname]["launches"] = mv_launches[kname]

    # ---- deferred-code renders: PIXELNERF_DEFER_CODE=1 on every forward route ----
    # frame 0 from views (0), (0, 1), (0, 1, 2) and on the dense route; the
    # code variant of the route's kernel must launch and the encoded-input one
    # not, and the frame agree with the plain route (without the deferred
    # code) to >= 40 dB.  Then frame 0 is timed with the code off and on, in
    # turns (off, on, on, off).
    def frame0(views, defer):
        os.environ["PIXELNERF_DEFER_CODE"] = "1" if defer else "0"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = entry.render_ring(net, conf, src3, rays[:RAYS_PER_STEP],
                                   torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP,
                                   views=views)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for views, cap, kname in (((0,), None, "resnetfc_fwd_gather"),
                              ((0,), "0", "resnetfc_fwd_dense"),
                              ((0, 1), None, "resnetfc_fwd_gather_mv"),
                              ((0, 1, 2), None, "resnetfc_fwd_dense_mv")):
        if cap is not None:
            os.environ["PIXELNERF_FUSED_GATHER_MAX_ROWS"] = cap
        try:
            rf.reset_launches()
            rgb_c, _ = frame0(views, True)
            defer_launches = dict(rf.LAUNCHES)
            times = {False: [], True: []}
            for defer in (False, True, True, False):
                times[defer].append(frame0(views, defer)[1])
        finally:
            os.environ.pop("PIXELNERF_DEFER_CODE", None)
            os.environ.pop("PIXELNERF_FUSED_GATHER_MAX_ROWS", None)
        cname = kname + "_code"
        p_c = psnr(rgb_c, plain_frame0[views])
        finite = bool(torch.isfinite(rgb_c).all())
        t_off, t_on = (sum(times[k]) / 2 for k in (False, True))
        log(f"deferred-code render: PIXELNERF_DEFER_CODE=1, source views {list(views)}"
            f"{', PIXELNERF_FUSED_GATHER_MAX_ROWS=' + cap if cap else ''}, frame 0: launches "
            f"{defer_launches}; vs plain route PSNR {p_c:.3f} dB (need >= 40); finite {finite}; "
            f"frame 0 in {t_on:.4f} s with the deferred code, {t_off:.4f} s without (means of two "
            f"calls each, in turns)")
        if not (finite and p_c >= 40.0 and defer_launches[cname] > 0
                and not any(v for k, v in defer_launches.items() if k != cname)):
            raise SystemExit(f"deferred-code render from views {views} failed or missed {cname}")
        code_records[cname]["launches"] = defer_launches[cname]

    # ---- backward kernel checks at the train step's shapes, -V 1 and -V 3 ----
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv

    records.update({"resnetfc_bwd_data": {}, "resnetfc_bwd_weights": {}})
    # the backward's two kernels and the step's dense forward, per (views, pass shape)
    bwd_ms, fwd_ms = {}, {}
    for NS, K in ((1, 64), (1, 96), (3, 64), (3, 96)):
        sb, B_obj = 4, 128 * K  # -B 4 objects x -R 128 rays x samples
        B = sb * B_obj
        rows = NS * B
        kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
        pts = torch.rand(rows, 3, device=dev, generator=gi) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn(rows, 3, device=dev, generator=gi), dim=-1)
        x = torch.cat([code(pts), vd], dim=-1).contiguous()
        idx, w = bilinear_taps(torch.rand(rows, 2, device=dev, generator=gi) * 2 - 1, 32, 32,
                               pad_taps_to=8)
        z = mv_latent(tables3[:NS] if NS > 1 else table[None], idx, w, sb)
        g = torch.randn(d_out, B, device=dev, generator=gi)
        data = rv.bwd_data(g, z, x, tw, nb, True, **kw)
        gr = rv.bwd_weights(z, data, tw, nb)
        torch.cuda.synchronize()
        ops_k = data.ws_act[:, :B].float()
        ops_p = rv.forward_operands(z, x, tw, nb, torch.bfloat16, **kw)
        d, bar, corr = agree(ops_k, ops_p)
        flips = ((ops_k > 0) != (ops_p > 0)).float().mean().item()
        ok = d <= bar and corr > 0.999 and flips <= 1e-3
        shape = f"-V {NS}: {sb} x 128 rays x {K} = {B} points"
        shape += f", {rows} rows" if NS > 1 else ""
        log(f"backward check {shape}: stashed forward operands vs plain recompute max|d| {d:.6g} "
            f"<= bar {bar:.6g}, corr {corr:.7f}, relu-mask flips {flips:.3g} (<= 1e-3)")
        same = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16, operands=ops_k,
                                         **kw)
        ind = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16, **kw)
        del ops_k, ops_p
        err = {"resnetfc_bwd_data": 0.0, "resnetfc_bwd_weights": 0.0}
        for name in rv.Grads._fields:
            out = getattr(gr, name).float()
            d1, bar1, c1 = agree(out, getattr(same, name))
            d2, bar2, c2 = agree(out, getattr(ind, name))
            fine = d1 <= bar1 and c1 > 0.999 and c2 > 0.999 and bool(torch.isfinite(out).all())
            ok = ok and fine
            # dz and dx come from the data kernel; the weights kernel reduces
            # every weight and bias gradient
            owner = "resnetfc_bwd_data" if name in ("dz", "dx") else "resnetfc_bwd_weights"
            err[owner] = max(err[owner], d1)
            log(f"  {name} {tuple(out.shape)}: vs plain on the same operands max|d| {d1:.6g} <= "
                f"bar {bar1:.6g}, corr {c1:.7f}; vs independent plain max|d| {d2:.6g} "
                f"(bar {bar2:.6g}), corr {c2:.7f}{'' if fine else '  FAILED'}")
        del same, ind
        gr2 = rv.bwd_weights(z, rv.bwd_data(g, z, x, tw, nb, True, **kw), tw, nb)
        identical = all(torch.equal(getattr(gr, n), getattr(gr2, n)) for n in rv.Grads._fields)
        del gr2
        data_ms = cuda_ms(lambda: rv.bwd_data(g, z, x, tw, nb, False, **kw), 5)
        weights_ms = cuda_ms(lambda: rv.bwd_weights(z, data, tw, nb), 5)
        plain_ms = cuda_ms(lambda: rv.resnetfc_bwd_reference(g, z, x, tw, nb, False,
                                                              torch.bfloat16, **kw), 2)
        leaves = [t.detach().bfloat16().requires_grad_() for t in tw[:8]]
        with torch.enable_grad():
            if NS == 1:
                zl = z.detach().requires_grad_()
                lout = library_tower(zl, x, rf.Tower(*leaves, tw.d_in), nb)
            else:
                zl = by_view(z, NS, sb).detach().requires_grad_()
                lout = library_tower_mv(zl, by_view(x, NS, sb), rf.Tower(*leaves, tw.d_in), nb,
                                        NS, cl)
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(lout, [zl, *leaves], g, retain_graph=True), 5)
        del lout, leaves, zl
        f_pt = flops_pt if NS == 1 else flops_mv[NS]  # forward FLOP per output point
        ws = sum(t.numel() * t.element_size()  # the bf16 workspace, written once, read once
                 for t in (data.ws_act, data.ws_cot, data.ws_x, data.ws_z) if t is not None)
        io_bytes = rows * (C * 2 + d_in * 4) + B * d_out * 4 + w_bytes
        b_data = bound(B * 2 * f_pt, io_bytes + ws + rows * (C * 4 + d_in * 4))
        b_weights = bound(B * f_pt, ws + rows * C * 2 + 2 * w_bytes)
        b_fn, b_fn_by = bound(B * 3 * f_pt, io_bytes + rows * (C * 2 + d_in * 4) + 2 * w_bytes)
        bwd_ms[(NS, K)] = data_ms + weights_ms
        with torch.no_grad():
            fwd_ms[(NS, K)] = cuda_ms(
                (lambda: rf.resnetfc_dense(z, x, tw, nb)) if NS == 1
                else (lambda: rf.resnetfc_dense_mv(z, x, tw, nb, NS, cl, sb)), 5)
        log(f"backward check {shape}: bit-identical on a second call {identical}; kernel_ms data "
            f"{data_ms:.4f} + weights {weights_ms:.4f} = {bwd_ms[(NS, K)]:.4f}, plain_ms "
            f"{plain_ms:.4f}, library_ms {library_ms:.4f} (autograd backward of the cuBLAS chain), "
            f"bound_ms {b_fn:.4f} ({b_fn_by}; data {b_data[0]:.4f} {b_data[1]}, weights "
            f"{b_weights[0]:.4f} {b_weights[1]}); workspace {ws / 2**30:.3f} GiB; the forward "
            f"kernel at this shape {fwd_ms[(NS, K)]:.4f} ms")
        if not (ok and identical):
            raise SystemExit(f"backward kernel check failed at {shape}")
        for name, ms, (b_ms, b_by) in (("resnetfc_bwd_data", data_ms, b_data),
                                       ("resnetfc_bwd_weights", weights_ms, b_weights)):
            rec = records[name]
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err[name])
            if K == 96:  # times at the fine pass's shape; -V 3 beside -V 1
                t = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms)
                if NS == 1:
                    rec.update(name=name, route="cuda",
                               source="pixelnerf_tpu_torch/csrc/resnetfc_bwd.cu",
                               replaces="pixelnerf_tpu/ops/resnetfc_vjp.py:172", **t)
                else:
                    rec[f"ns{NS}"] = dict(t, points=B, rows=rows, max_abs_err=err[name])
        del data, gr, g, x, z, idx, w, pts, vd

    # ---- train-step parity: kernel route (AMP) vs plain f32 route, -V 1 and -V 3 ----
    import numpy as np

    from pixelnerf_tpu_torch.data import collate, get_split_dataset
    from pixelnerf_tpu_torch.models.losses import l2_loss
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import NeRFRenderer, RayDraws
    from pixelnerf_tpu_torch.train import Optimizer, make_step_fns, prepare_ray_batch

    ds = get_split_dataset("synthetic", "", want_split="train")
    rcfg = NeRFRenderer.from_conf(conf["renderer"], lindisp=ds.lindisp).cfg
    n_rays, n_imp = 4 * 128, rcfg.n_fine - rcfg.n_fine_depth
    # the forward kernel a step of each view count runs
    step_kernel = {1: "resnetfc_fwd_dense", 3: "resnetfc_fwd_dense_mv"}
    for nviews in (1, 3):
        batch_np = prepare_ray_batch(collate([ds[i] for i in range(len(ds))]), nviews, 128,
                                     ds.z_near, ds.z_far, True, np.random.default_rng(SEED))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        gd = torch.Generator(device=dev).manual_seed(SEED + 3)
        draws = RayDraws(
            coarse=torch.rand(n_rays, rcfg.n_coarse, device=dev, generator=gd),
            fine_u=torch.rand(n_rays, n_imp, device=dev, generator=gd),
            fine_jitter=torch.rand(n_rays, n_imp, device=dev, generator=gd),
            depth=torch.randn(n_rays, rcfg.n_fine_depth, device=dev, generator=gd),
        )
        log(f"train-step parity: sn64 full width, the weights of the render phases (seeded, "
            f"random encoder, live fc_1), -F synthetic {len(ds)} objects x {ds.n_views} views at "
            f"{ds.image_size}px, one prepare_ray_batch batch at B 4, V {nviews}, R 128, shared "
            f"draws")
        steps = {}
        for route, impl, amp in (("kernel", "auto", True), ("plain", "torch", False)):
            tnet = make_model(conf["model"], mlp_impl=impl, device=dev, diff_mode=True)
            tnet.load_state_dict(net.state_dict())
            opt = Optimizer(list(tnet.parameters()), lambda t: 1e-4)
            train_step, _ = make_step_fns(tnet, opt, lambda: rcfg, 1.0, 1.0, l2_loss, l2_loss,
                                          tnet.use_viewdirs, amp=amp,
                                          remat=not tnet.field_backward_in_kernel(nviews))
            rf.reset_launches()
            rv.reset_launches()
            ld = {k: float(v) for k, v in train_step(batch, gd, draws).items()}
            torch.cuda.synchronize()
            groups = {}
            for n, prm in tnet.named_parameters():
                groups.setdefault(n.split(".")[0], []).append(prm.grad.detach().float().flatten())
            steps[route] = (ld, {k: torch.cat(v) for k, v in groups.items()},
                            dict(rf.LAUNCHES, **rv.LAUNCHES))
            del tnet, opt
        (lk, gk, nk), (lp, gp, np_) = steps["kernel"], steps["plain"]
        cos = {k: cosine(gk[k], gp[k]) for k in gp}
        d_loss = abs(lk["t"] - lp["t"]) / abs(lp["t"])
        d_norm = abs(lk["grad_norm"] - lp["grad_norm"]) / lp["grad_norm"]
        fwd = step_kernel[nviews]
        ok = (d_loss <= 0.01 and d_norm <= 0.02 and min(cos.values()) >= 0.99
              and nk[fwd] == 2 and nk["resnetfc_bwd_data"] == 2
              and nk["resnetfc_bwd_weights"] == 2
              and not any(v for k, v in nk.items() if k.startswith("resnetfc_fwd") and k != fwd)
              and not any(np_.values()))
        log(f"train-step parity -V {nviews}: loss kernel {lk['t']:.6f} plain {lp['t']:.6f} (rel "
            f"{d_loss:.3g} <= 0.01); grad_norm {lk['grad_norm']:.6f} vs {lp['grad_norm']:.6f} "
            f"(rel {d_norm:.3g} <= 0.02); gradient cosine "
            f"{json.dumps({k: round(v, 6) for k, v in cos.items()})} (>= 0.99); kernel-route "
            f"launches {nk}; plain-route launches {np_}")
        if not ok:
            raise SystemExit(f"train-step parity failed at -V {nviews}")

    # ---- train path: the train CLI in-process, -V 1 and -V 3 ----
    from pixelnerf_tpu_torch.train import main as train_main

    for nviews, epochs in ((1, 12), (3, 6)):
        fwd = step_kernel[nviews]
        os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # no backbone weights on this machine
        try:
            with tempfile.TemporaryDirectory() as ck:
                torch.cuda.synchronize()
                rf.reset_launches()
                rv.reset_launches()
                trainer = train_main(["-n", "chip_smoke", "-c", "conf/exp/sn64.conf", "-F",
                                      "synthetic", "-B", "4", "-V", str(nviews), "-R", "128",
                                      "--epochs", str(epochs), "--checkpoints_path", ck])
                torch.cuda.synchronize()
                train_launches = dict(rf.LAUNCHES, **rv.LAUNCHES)
                wrote = os.path.exists(os.path.join(ck, "chip_smoke", "pixel_nerf_latest"))
        finally:
            del os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"]
        n_steps, n_val = trainer.global_step, len(trainer.test_loader)
        finite = len(trainer.history) == n_steps and all(math.isfinite(v) for v in trainer.history)
        step_ms = 1e3 * sum(trainer.step_seconds[2:]) / max(1, len(trainer.step_seconds[2:]))
        k_bwd = bwd_ms[(nviews, 64)] + bwd_ms[(nviews, 96)]
        k_fwd = fwd_ms[(nviews, 64)] + fwd_ms[(nviews, 96)]
        log(f"train path: python -m pixelnerf_tpu_torch.train -c conf/exp/sn64.conf -F synthetic "
            f"-B 4 -V {nviews} -R 128 --epochs {epochs} (random encoder): {n_steps} steps, remat "
            f"{trainer.remat}, launches {train_launches} ({n_val} validation batch(es) add 2 "
            f"{fwd} launches each); losses {[round(v, 5) for v in trainer.history]} finite "
            f"{finite}; pixel_nerf_latest written {wrote}")
        log(f"train path -V {nviews}: {step_ms:.3f} ms per step over steps 3-{n_steps} = "
            f"{n_rays / step_ms * 1e3:.1f} rays/s; backward kernels {k_bwd:.3f} ms per step = "
            f"{k_bwd / step_ms:.3f} of it, forward kernels {k_fwd:.3f} ms = "
            f"{k_fwd / step_ms:.3f}; on {smi}")
        if not (n_steps == epochs and finite and wrote and not trainer.remat
                and train_launches[fwd] == 2 * n_steps + 2 * n_val
                and train_launches["resnetfc_bwd_data"] == 2 * n_steps
                and train_launches["resnetfc_bwd_weights"] == 2 * n_steps
                and not any(v for k, v in train_launches.items()
                            if k.startswith("resnetfc_fwd") and k != fwd)):
            raise SystemExit(f"train path at -V {nviews} failed or did not run through the kernels")
        for name in ("resnetfc_bwd_data", "resnetfc_bwd_weights"):
            if nviews == 1:
                records[name]["launches"] = train_launches[name]
            else:
                records[name][f"ns{nviews}"]["launches"] = train_launches[name]

    # ---- eval path: the eval CLI in-process, through the deferred code ----
    import types

    from pixelnerf_tpu_torch.eval.eval import main as eval_main
    from pixelnerf_tpu_torch.train import checkpoints

    os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # no backbone weights on this machine
    os.environ["PIXELNERF_DEFER_CODE"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck")
            checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=ck, name="chip_smoke"),
                                     net)
            runs = []
            for source, n_objs, out_dir in (("0", 2, "eval1"), ("0", 2, "eval1"),
                                            ("0 1 2", 1, "eval3")):
                out_dir = os.path.join(tmp, out_dir)
                argv = ["-n", "chip_smoke", "-c", "conf/exp/sn64.conf", "-F", "synthetic",
                        "--split", "test", "-P", source, "--max_objs", str(n_objs), "-O", out_dir,
                        "--checkpoints_path", ck]
                torch.cuda.synchronize()
                rf.reset_launches()
                t0 = time.perf_counter()
                res = eval_main(argv)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                with open(os.path.join(out_dir, "finish.txt")) as f:
                    journal = f.read().splitlines()
                pngs = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                              for d, _, fs in os.walk(out_dir) for f in fs if f.endswith(".png"))
                runs.append((source, res, dict(rf.LAUNCHES), journal, pngs, dt))
    finally:
        del os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"]
        del os.environ["PIXELNERF_DEFER_CODE"]
    expect = ("resnetfc_fwd_gather_code", None, "resnetfc_fwd_dense_mv_code")
    for i, ((source, res, launches, journal, pngs, dt), want) in enumerate(zip(runs, expect)):
        n_views = ds.n_views - len(source.split())  # target views: all but the sources
        log(f"eval path{' (resume)' if i == 1 else ''}: python -m pixelnerf_tpu_torch.eval.eval "
            f"-c conf/exp/sn64.conf -F synthetic --split test -P \"{source}\" with "
            f"PIXELNERF_DEFER_CODE=1 (random encoder, the render phases' weights): rendered "
            f"{[(n, round(p_, 4), round(s_, 4)) for n, p_, s_ in res['objects']]}, mean psnr "
            f"{res['psnr']:.4f} ssim {res['ssim']:.4f} over {res['cnt']}; launches {launches}; "
            f"finish.txt {journal}; {len(pngs)} PNGs; {dt:.3f} s")
        if want is None:  # the resume run renders nothing
            ok = not res["objects"] and not any(launches.values()) and len(journal) == 2
        else:
            ok = (len(res["objects"]) == len(journal) == res["cnt"]
                  and all(math.isfinite(p_) and math.isfinite(s_) for _, p_, s_ in res["objects"])
                  and len(pngs) == n_views * len(journal) and launches[want] > 0
                  and not any(v for k, v in launches.items() if k != want))
        if not ok:
            raise SystemExit(f"eval path with -P {source!r} failed or did not run through {want}")
        if want is not None:
            code_records[want]["eval_launches"] = launches[want]

    # row 6 as one record: the single-view gather variant's numbers (the
    # 1-view deferred render's kernel) at the top, every variant under
    # "variants"; launches are the deferred renders' (phase 7)
    records["resnetfc_fwd_code"] = dict(
        code_records["resnetfc_fwd_gather_code"], name="resnetfc_fwd_code",
        route="cuda", source="pixelnerf_tpu_torch/csrc/resnetfc_tower.cuh",
        replaces="pixelnerf_tpu/ops/resnetfc_pallas.py:156",
        launches=sum(r["launches"] for r in code_records.values()),
        max_abs_err=max(r["max_abs_err"] for r in code_records.values()),
        variants=code_records)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [dict({k: records[n][k] for k in keys},
                                       **{k: v for k, v in records[n].items() if k not in keys})
                                  for n in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
