"""On-card smoke run of the PyTorch/CUDA port (``pixelnerf_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero, printing no result, without one.  Phases,
one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile every kernel from ``pixelnerf_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once;
3. kernel checks: each forward kernel against its plain PyTorch version at
   the main path's shapes (one ray chunk x 64 and x 96 samples, a 1024 x 512
   table), to ``max|d| <= 0.015 * max(1, max|ref|)`` and ``corr > 0.999``,
   with its time beside the plain version's, a cuBLAS bf16 ``torch.matmul``
   chain's and the card's bound; then the bounds and cuBLAS-chain times of
   the TPU kernels not ported yet (rows 3, 4 and 6 of PERF.md);
4. main path: the full-width sn64 model (seeded weights, random encoder)
   renders 64x64 ring frames on the kernel route; the gather kernel must have
   launched, and frame 0 must agree with the plain route to >= 40 dB PSNR;
5. dense route: ``PIXELNERF_FUSED_GATHER_MAX_ROWS=0`` renders frame 0 through
   the dense kernel, which must have launched;
6. backward kernel checks at the train step's shapes (4 x 128 rays x 64 and
   x 96 samples): the kernels' stashed forward operands against the plain
   recompute, every output (dz, dx, each dW and db) against the plain
   backward walked through the same operands at the bar above, and against
   the fully independent plain backward at ``corr > 0.999``; two calls must
   be bit-identical; times beside the plain version's, the autograd backward
   of the cuBLAS chain and the bound;
7. train-step parity: one sn64 step on the kernel route (AMP) and one on the
   plain f32 route from the same weights, batch and draws: losses within 1%,
   ``grad_norm`` within 2%, cosine >= 0.99 between each head's and the
   encoder's gradients;
8. train path: ``python -m pixelnerf_tpu_torch.train`` in-process on the
   synthetic data for 12 one-step epochs; the forward and backward kernels
   launch twice per step, the gather kernel never, the losses stay finite and
   ``pixel_nerf_latest`` is written.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
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
    tail.  A yardstick for kernels not ported yet; the port never calls it."""
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
        "kernels": ["resnetfc_fwd_dense", "resnetfc_fwd_gather", "resnetfc_bwd_data",
                    "resnetfc_bwd_weights"],
        "sources": [str(rf.SOURCES[n].relative_to(rf.CSRC.parent.parent)) for n in builds],
        "libraries": [b.library.name for b in builds.values()],
        "compiled": {n: b.compiled for n, b in builds.items()},
        "seconds": round(time.perf_counter() - t0, 3),
        "ptxas": {n: [ln.strip() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln]
                  for n, b in builds.items()},
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
    with torch.no_grad():
        scene = net.encode(torch.as_tensor(src["images"], device=dev),
                           torch.as_tensor(src["poses"], device=dev), float(src["focal"]))
    table = scene.latents.reshape(-1, C).to(torch.bfloat16).contiguous()
    T = table.shape[0]

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

    # ---- bounds and cuBLAS-chain times of the TPU kernels not ported yet ----
    # rows 3-4 at conf/exp/dtu.conf's widths (the sn64 tower, combine_layer 3)
    # with NS = 3 views of 4096 rays x 96 samples; row 4's tables hold 512
    # rows a view (NS * T under the fused-gather cap of 2048); row 6 at the
    # sn64 fine pass, z and the raw coordinates of the last check above
    NS_MV, B_MV, T_MV, cl = 3, RAYS_PER_STEP * 96, 512, mlp.combine_layer
    flops_mv = 2 * H * (NS_MV * (d_in + cl * (C + 2 * H)) + 2 * (nb - cl) * H + d_out)
    with torch.no_grad():
        zm = torch.randn(NS_MV, B_MV, C, device=dev, generator=gi).to(torch.bfloat16)
        xm = torch.rand(NS_MV, B_MV, d_in, device=dev, generator=gi) * 2 - 1
        tables = torch.randn(NS_MV, T_MV, C, device=dev, generator=gi).to(torch.bfloat16)
        idx_mv = torch.randint(0, T_MV, (NS_MV, B_MV, 4), device=dev, generator=gi)
        w_mv = torch.rand(NS_MV, B_MV, 4, device=dev, generator=gi)
        views = torch.arange(NS_MV, device=dev)[:, None, None]

        def gather_mv():
            zz = (tables[views, idx_mv] * w_mv[..., None].bfloat16()).sum(2)
            return library_tower_mv(zz, xm, tw, nb, NS_MV, cl)

        unported = [
            (3, "_kernel_2d_mv", "pixelnerf_tpu/ops/resnetfc_pallas.py:399",
             lambda: library_tower_mv(zm, xm, tw, nb, NS_MV, cl), B_MV * flops_mv,
             B_MV * NS_MV * (C * 2 + d_in * 4) + B_MV * d_out * 4 + w_bytes,
             f"NS={NS_MV} x {B_MV} points"),
            (4, "_kernel_2d_mv_gather", "pixelnerf_tpu/ops/resnetfc_pallas.py:463", gather_mv,
             B_MV * (flops_mv + NS_MV * 8 * C),
             B_MV * NS_MV * (4 * 8 + d_in * 4) + B_MV * d_out * 4 + NS_MV * T_MV * C * 2 + w_bytes,
             f"NS={NS_MV} x {B_MV} points, tables {NS_MV}x{T_MV}x{C}"),
            (6, "_x_feat fused code", "pixelnerf_tpu/ops/resnetfc_pallas.py:156",
             lambda: library_tower(z, torch.cat([code(pts), vd], dim=-1), tw, nb),
             B * (flops_pt + 2 * 6 * d_in), B * (C * 2 + 6 * 4 + d_out * 4) + w_bytes,
             f"sn64 dense, {B} points, raw (xyz, viewdir)"),
        ]
        for row, kname, where, library, flops, nbytes, shape in unported:
            lib_ms = cuda_ms(library, 3)
            b_ms, b_by = bound(flops, nbytes)
            log(f"not ported: row {row} {kname} ({where}) at {shape}: bound_ms {b_ms:.4f} "
                f"({b_by}) library_ms {lib_ms:.4f} (cuBLAS bf16 chain)")
        del zm, xm, tables, idx_mv, w_mv

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

    # ---- backward kernel checks at the train step's shapes ----
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv

    kin = tw.w_in.shape[0]
    records.update({"resnetfc_bwd_data": {}, "resnetfc_bwd_weights": {}})
    bwd_ms, fwd_ms = {}, {}  # the backward's two kernels and the dense forward, per pass shape
    ws_pt = ((2 * nb + 1) * 2 * H + kin) * 2  # workspace bytes a point, written once, read once
    for K in (64, 96):
        B = 4 * 128 * K  # -B 4 objects x -R 128 rays x samples
        pts = torch.rand(B, 3, device=dev, generator=gi) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn(B, 3, device=dev, generator=gi), dim=-1)
        x = torch.cat([code(pts), vd], dim=-1).contiguous()
        idx, w = bilinear_taps(torch.rand(B, 2, device=dev, generator=gi) * 2 - 1, 32, 32, pad_taps_to=8)
        z = rf.gather_reference(idx, w, table, torch.bfloat16).to(torch.bfloat16)
        g = torch.randn(d_out, B, device=dev, generator=gi)
        data = rv.bwd_data(g, z, x, tw, nb, True)
        gr = rv.bwd_weights(z, data, tw, nb)
        torch.cuda.synchronize()
        ops_k = data.ws_act[:, :B].float()
        ops_p = rv.forward_operands(z, x, tw, nb, torch.bfloat16)
        d, bar, corr = agree(ops_k, ops_p)
        flips = ((ops_k > 0) != (ops_p > 0)).float().mean().item()
        ok = d <= bar and corr > 0.999 and flips <= 1e-3
        log(f"backward check B={B} (4 x 128 rays x {K}): stashed forward operands vs plain "
            f"recompute max|d| {d:.6g} <= bar {bar:.6g}, corr {corr:.7f}, relu-mask flips "
            f"{flips:.3g} (<= 1e-3)")
        same = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16, operands=ops_k)
        ind = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16)
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
        gr2 = rv.bwd_weights(z, rv.bwd_data(g, z, x, tw, nb, True), tw, nb)
        identical = all(torch.equal(getattr(gr, n), getattr(gr2, n)) for n in rv.Grads._fields)
        del gr2
        data_ms = cuda_ms(lambda: rv.bwd_data(g, z, x, tw, nb, False), 5)
        weights_ms = cuda_ms(lambda: rv.bwd_weights(z, data, tw, nb), 5)
        plain_ms = cuda_ms(lambda: rv.resnetfc_bwd_reference(g, z, x, tw, nb, False,
                                                              torch.bfloat16), 3)
        leaves = [t.detach().bfloat16().requires_grad_() for t in tw[:8]]
        zl = z.detach().requires_grad_()
        with torch.enable_grad():
            lout = library_tower(zl, x, rf.Tower(*leaves, tw.d_in), nb)
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(lout, [zl, *leaves], g, retain_graph=True), 5)
        del lout, leaves, zl
        io_bytes = B * (d_out * 4 + C * 2 + d_in * 4) + w_bytes
        b_data = bound(B * 2 * flops_pt, io_bytes + B * (ws_pt + C * 4 + d_in * 4))
        b_weights = bound(B * flops_pt, B * ws_pt + B * C * 2 + 2 * w_bytes)
        b_fn, b_fn_by = bound(B * 3 * flops_pt, io_bytes + B * (C * 2 + d_in * 4) + 2 * w_bytes)
        bwd_ms[K] = data_ms + weights_ms
        with torch.no_grad():
            fwd_ms[K] = cuda_ms(lambda: rf.resnetfc_dense(z, x, tw, nb), 5)
        log(f"backward check B={B}: bit-identical on a second call {identical}; kernel_ms data "
            f"{data_ms:.4f} + weights {weights_ms:.4f} = {bwd_ms[K]:.4f}, plain_ms {plain_ms:.4f}, "
            f"library_ms {library_ms:.4f} (autograd backward of the cuBLAS chain), bound_ms "
            f"{b_fn:.4f} ({b_fn_by}; data {b_data[0]:.4f} {b_data[1]}, weights "
            f"{b_weights[0]:.4f} {b_weights[1]}); the forward kernel at this shape "
            f"{fwd_ms[K]:.4f} ms")
        if not (ok and identical):
            raise SystemExit(f"backward kernel check failed at B={B}")
        for name, ms, (b_ms, b_by) in (("resnetfc_bwd_data", data_ms, b_data),
                                       ("resnetfc_bwd_weights", weights_ms, b_weights)):
            rec = records[name]
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err[name])
            if K == 96:  # times at the fine pass's shape
                rec.update(name=name, route="cuda", source="pixelnerf_tpu_torch/csrc/resnetfc_bwd.cu",
                           replaces="pixelnerf_tpu/ops/resnetfc_vjp.py:172", ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
        del data, gr, g, x, z

    # ---- train-step parity: kernel route (AMP) vs plain f32 route ----
    import numpy as np

    from pixelnerf_tpu_torch.data import collate, get_split_dataset
    from pixelnerf_tpu_torch.models.losses import l2_loss
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import NeRFRenderer, RayDraws
    from pixelnerf_tpu_torch.train import Optimizer, make_step_fns, prepare_ray_batch

    ds = get_split_dataset("synthetic", "", want_split="train")
    batch_np = prepare_ray_batch(collate([ds[i] for i in range(len(ds))]), 1, 128, ds.z_near,
                                 ds.z_far, True, np.random.default_rng(SEED))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    rcfg = NeRFRenderer.from_conf(conf["renderer"], lindisp=ds.lindisp).cfg
    gd = torch.Generator(device=dev).manual_seed(SEED + 3)
    n_rays, n_imp = 4 * 128, rcfg.n_fine - rcfg.n_fine_depth
    draws = RayDraws(
        coarse=torch.rand(n_rays, rcfg.n_coarse, device=dev, generator=gd),
        fine_u=torch.rand(n_rays, n_imp, device=dev, generator=gd),
        fine_jitter=torch.rand(n_rays, n_imp, device=dev, generator=gd),
        depth=torch.randn(n_rays, rcfg.n_fine_depth, device=dev, generator=gd),
    )
    log(f"train-step parity: sn64 full width, the weights of the render phases (seeded, random "
        f"encoder, live fc_1), -F synthetic {len(ds)} objects x {ds.n_views} views at "
        f"{ds.image_size}px, one prepare_ray_batch batch at B 4, V 1, R 128, shared draws")
    steps = {}
    for route, impl, amp in (("kernel", "auto", True), ("plain", "torch", False)):
        tnet = make_model(conf["model"], mlp_impl=impl, device=dev, diff_mode=True)
        tnet.load_state_dict(net.state_dict())
        opt = Optimizer(list(tnet.parameters()), lambda t: 1e-4)
        train_step, _ = make_step_fns(tnet, opt, lambda: rcfg, 1.0, 1.0, l2_loss, l2_loss,
                                      tnet.use_viewdirs, amp=amp,
                                      remat=not tnet.field_backward_in_kernel())
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
    ok = (d_loss <= 0.01 and d_norm <= 0.02 and min(cos.values()) >= 0.99
          and nk["resnetfc_fwd_dense"] == 2 and nk["resnetfc_bwd_data"] == 2
          and nk["resnetfc_bwd_weights"] == 2 and nk["resnetfc_fwd_gather"] == 0
          and not any(np_.values()))
    log(f"train-step parity: loss kernel {lk['t']:.6f} plain {lp['t']:.6f} (rel {d_loss:.3g} <= "
        f"0.01); grad_norm {lk['grad_norm']:.6f} vs {lp['grad_norm']:.6f} (rel {d_norm:.3g} <= "
        f"0.02); gradient cosine {json.dumps({k: round(v, 6) for k, v in cos.items()})} (>= 0.99); "
        f"kernel-route launches {nk}; plain-route launches {np_}")
    if not ok:
        raise SystemExit("train-step parity failed")

    # ---- train path: the train CLI in-process ----
    from pixelnerf_tpu_torch.train import main as train_main

    epochs = 12
    os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # no backbone weights on this machine
    try:
        with tempfile.TemporaryDirectory() as ck:
            torch.cuda.synchronize()
            rf.reset_launches()
            rv.reset_launches()
            trainer = train_main(["-n", "chip_smoke", "-c", "conf/exp/sn64.conf", "-F", "synthetic",
                                  "-B", "4", "-V", "1", "-R", "128", "--epochs", str(epochs),
                                  "--checkpoints_path", ck])
            torch.cuda.synchronize()
            train_launches = dict(rf.LAUNCHES, **rv.LAUNCHES)
            wrote = os.path.exists(os.path.join(ck, "chip_smoke", "pixel_nerf_latest"))
    finally:
        del os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"]
    n_steps, n_val = trainer.global_step, len(trainer.test_loader)
    finite = len(trainer.history) == n_steps and all(math.isfinite(v) for v in trainer.history)
    step_ms = 1e3 * sum(trainer.step_seconds[2:]) / max(1, len(trainer.step_seconds[2:]))
    log(f"train path: python -m pixelnerf_tpu_torch.train -c conf/exp/sn64.conf -F synthetic -B 4 "
        f"-V 1 -R 128 --epochs {epochs} (random encoder): {n_steps} steps, launches "
        f"{train_launches} ({n_val} validation batch(es) add 2 dense launches each); losses "
        f"{[round(v, 5) for v in trainer.history]} finite {finite}; pixel_nerf_latest written "
        f"{wrote}")
    log(f"train path: {step_ms:.3f} ms per step over steps 3-{n_steps} = "
        f"{n_rays / step_ms * 1e3:.1f} rays/s; backward kernels {bwd_ms[64] + bwd_ms[96]:.3f} ms "
        f"per step = {(bwd_ms[64] + bwd_ms[96]) / step_ms:.3f} of it, forward kernels "
        f"{fwd_ms[64] + fwd_ms[96]:.3f} ms = {(fwd_ms[64] + fwd_ms[96]) / step_ms:.3f}; on {smi}")
    if not (n_steps == epochs and finite and wrote
            and train_launches["resnetfc_fwd_dense"] == 2 * n_steps + 2 * n_val
            and train_launches["resnetfc_bwd_data"] == 2 * n_steps
            and train_launches["resnetfc_bwd_weights"] == 2 * n_steps
            and train_launches["resnetfc_fwd_gather"] == 0):
        raise SystemExit("train path failed or did not run through the kernels")
    for name in ("resnetfc_bwd_data", "resnetfc_bwd_weights"):
        records[name]["launches"] = train_launches[name]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: records[n][k] for k in keys} for n in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
