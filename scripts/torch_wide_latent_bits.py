"""Whether the PyTorch port's forward kernels and its backward kernels give
the same bits in several checkouts, at sn64's widths (d_hidden 512, C = 512)
and at sn64's depth with d_hidden 384, 256, 128 and 64, and at d_hidden 512
with 6 blocks and with a 128-wide code (20 frequencies: kin 128).

    python3 scripts/torch_wide_latent_bits.py DIR_A DIR_B

Each checkout runs in a process of its own, started in that checkout: it
builds that checkout's kernels and runs ``resnetfc_dense`` and
``resnetfc_dense_mv`` (encoded code and the deferred code, ``RawCode``) on
the sn64 tower (5 blocks x 512, 3 injections, seeded weights) and seeded
inputs at 2000, 160 and 49,152 points from one view and at NS 2 x 4096, NS
3 x 2000, SB 2 x NS 3 x 333 and SB 4 x NS 3 x 1536 rows, and the fused
gathers ``resnetfc_gather`` / ``resnetfc_gather_mv`` (both codes) on seeded
(NS, 1024, 512) tables with taps outside them at the one-object shapes; runs
``resnetfc_bwd_data`` and ``resnetfc_bwd_weights`` (``bwd_data`` with dx,
then ``bwd_weights``) on the same tower at 2000 and 49,152 points from one
view and at SB 2 x NS 3 x 333 and SB 4 x NS 3 x 1536 rows with a seeded
cotangent; the same at d_hidden 384, 256, 128 and 64, and with 6 blocks and
with the 128-wide code, at 2000 points from one view and at SB 2 x NS 3 x
333 rows; and prints one JSON line of each
output's SHA-256 (the first 16 hex digits): the forwards' outputs, and of
the backward the stashed workspace, the per-32-row sums, dz, dx and every
gradient.  The script is
the same for every checkout; only the kernels differ.  It prints the
hashes of each checkout and exits 1 unless they are all equal.  Needs one
CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys


def child() -> dict:
    sys.path.insert(0, os.getcwd())
    import torch

    from pixelnerf_tpu_torch.models.code import PositionalEncoding
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    dev = torch.device("cuda")
    rf.build_all(("fwd", "bwd"), WIDTHS)
    out = {}
    for H, nb, freqs, tag in TOWERS:
        W, f, p, m = PositionalEncoding(num_freqs=freqs, d_in=3, freq_factor=1.5,
                                        include_input=True).flat_arrays(tail=3)
        code = tuple(torch.from_numpy(a).to(dev) for a in (W, f, p, m))
        g = torch.Generator().manual_seed(0)
        mod = ResnetFC(d_in=W.shape[1], d_out=4, n_blocks=nb, d_latent=512, d_hidden=H,
                       combine_layer=3, impl="cuda")
        with torch.no_grad():
            for name, prm in mod.named_parameters():
                std = 0.05 if name.endswith("bias") else prm.shape[1] ** -0.5
                prm.copy_(torch.randn(prm.shape, generator=g) * std)
        tw = mod.to(dev).tower(dev)
        out.update(hashes(tw, nb, code, dev, SHAPES if not tag else NARROW_SHAPES, tag))
    return out


def hashes(tw, nb, code, dev, shapes, tag: str) -> dict:
    """The hashes of every kernel's outputs on the ``nb``-block tower ``tw``
    at ``shapes`` (NS, SB, B), each key prefixed with ``tag``."""
    import torch

    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv

    out = {}
    for NS, sb, B in shapes:
        rows = NS * sb * B
        gi = torch.Generator().manual_seed(rows)
        raw = torch.cat([torch.rand(rows, 3, generator=gi) * 2.8 - 1.4,
                         torch.nn.functional.normalize(torch.randn(rows, 3, generator=gi),
                                                       dim=-1)], -1).to(dev)
        rc = rf.RawCode(raw, *code)
        enc = rf.materialize_code(rc._replace(cd=torch.float32)).contiguous()
        z = (torch.randn(rows, 512, generator=gi) * 0.5).to(dev).bfloat16().contiguous()
        tables = (torch.randn(NS, 1024, 512, generator=gi) * 0.5).to(dev).bfloat16()
        idx = torch.randint(-1, 1025, (rows, 8), generator=gi).int().to(dev)
        w = torch.rand(rows, 8, generator=gi).to(dev)
        w[:, 4:] = 0.0
        for label, x in (("encoded", enc), ("code", rc)):
            with torch.no_grad():
                y = (rf.resnetfc_dense(z, x, tw, nb, True) if NS == 1
                     else rf.resnetfc_dense_mv(z, x, tw, nb, NS, 3, sb, True))
                yg = None
                if sb == 1:  # the fused gathers take one object
                    yg = (rf.resnetfc_gather(idx, w, tables[0].contiguous(), x, tw, nb, True)
                          if NS == 1 else rf.resnetfc_gather_mv(idx, w, tables, x, tw, nb, 3,
                                                                True))
            torch.cuda.synchronize()
            key = f"{tag}NS {NS} SB {sb} x {B} {label}"
            out[key] = digest(y)
            if yg is not None:
                out[key + " gather"] = digest(yg)
        if (NS, sb, B) not in BWD_SHAPES:
            continue
        kw = dict(NS=NS, sb=sb, combine_layer=3) if NS > 1 else {}
        g = torch.randn(4, sb * B, generator=gi).to(dev)
        data = rv.bwd_data(g, z, enc, tw, nb, True, **kw)
        gr = rv.bwd_weights(z, data, tw, nb)
        torch.cuda.synchronize()
        for name in ("ws_act", "ws_cot", "ws_x", "ws_z", "rows"):
            if getattr(data, name) is not None:
                out[f"{tag}NS {NS} SB {sb} x {B} backward {name}"] = digest(getattr(data, name))
        for name in rv.Grads._fields:
            out[f"{tag}NS {NS} SB {sb} x {B} backward {name}"] = digest(getattr(gr, name))
    return out


# the tower widths hashed: sn64's, then the narrower ones at fewer shapes
WIDTHS = (512, 384, 256, 128, 64)
# the towers: (d_hidden, blocks, code frequencies, key prefix): sn64's, the
# narrower widths, 6 blocks and a 128-wide code (kin 128) at sn64's width
TOWERS = tuple((H, 5, 6, "" if H == 512 else f"d_hidden {H} ") for H in WIDTHS) + (
    (512, 6, 6, "6 blocks "), (512, 5, 20, "kin 128 "))
# (NS, SB, B): the shapes at d_hidden 512, and at the narrower widths
SHAPES = ((1, 1, 2000), (1, 1, 160), (1, 1, 49152), (2, 1, 4096), (3, 1, 2000), (3, 2, 333),
          (3, 4, 1536))
NARROW_SHAPES = ((1, 1, 2000), (3, 2, 333))
# the shapes at which the backward kernels' outputs are hashed too
BWD_SHAPES = ((1, 1, 2000), (1, 1, 49152), (3, 2, 333), (3, 4, 1536))


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> None:
    if sys.argv[1:] == ["--child"]:
        print(json.dumps(child()))
        return
    dirs = sys.argv[1:]
    if len(dirs) < 2:
        raise SystemExit(__doc__)
    script = os.path.abspath(__file__)
    hashes = {}
    for d in dirs:
        res = subprocess.run([sys.executable, script, "--child"], cwd=d, capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"{d}: {res.stderr[-4000:]}")
        hashes[d] = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{d}: {json.dumps(hashes[d], sort_keys=True)}", flush=True)
    first = hashes[dirs[0]]
    same = {d: h == first for d, h in hashes.items()}
    print(json.dumps({"same_bits": all(same.values()), "by_checkout": same,
                      "outputs": len(first)}))
    if not all(same.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
