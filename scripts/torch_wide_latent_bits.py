"""Whether the PyTorch port's dense forward kernels give the same bits in
several checkouts, at sn64's latent width (C = 512).

    python3 scripts/torch_wide_latent_bits.py DIR_A DIR_B

Each checkout runs in a process of its own, started in that checkout: it
builds that checkout's forward kernels and runs ``resnetfc_dense`` and
``resnetfc_dense_mv`` (encoded code and the deferred code, ``RawCode``) on
the sn64 tower (5 blocks x 512, 3 injections, seeded weights) and seeded
inputs at 2000, 160 and 49,152 points from one view and at NS 2 x 4096, NS
3 x 2000, SB 2 x NS 3 x 333 and SB 4 x NS 3 x 1536 rows, and prints one
JSON line of each output's SHA-256 (the first 16 hex digits).  The script is
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
    rf.build_all(("fwd",))
    g = torch.Generator().manual_seed(0)
    W, f, p, m = PositionalEncoding(num_freqs=6, d_in=3, freq_factor=1.5,
                                    include_input=True).flat_arrays(tail=3)
    mod = ResnetFC(d_in=W.shape[1], d_out=4, n_blocks=5, d_latent=512, d_hidden=512,
                   combine_layer=3, impl="cuda")
    with torch.no_grad():
        for name, prm in mod.named_parameters():
            std = 0.05 if name.endswith("bias") else prm.shape[1] ** -0.5
            prm.copy_(torch.randn(prm.shape, generator=g) * std)
    tw = mod.to(dev).tower(dev)
    code = tuple(torch.from_numpy(a).to(dev) for a in (W, f, p, m))
    out = {}
    for NS, sb, B in ((1, 1, 2000), (1, 1, 160), (1, 1, 49152), (2, 1, 4096), (3, 1, 2000),
                      (3, 2, 333), (3, 4, 1536)):
        rows = NS * sb * B
        gi = torch.Generator().manual_seed(rows)
        raw = torch.cat([torch.rand(rows, 3, generator=gi) * 2.8 - 1.4,
                         torch.nn.functional.normalize(torch.randn(rows, 3, generator=gi),
                                                       dim=-1)], -1).to(dev)
        rc = rf.RawCode(raw, *code)
        enc = rf.materialize_code(rc._replace(cd=torch.float32)).contiguous()
        z = (torch.randn(rows, 512, generator=gi) * 0.5).to(dev).bfloat16().contiguous()
        for label, x in (("encoded", enc), ("code", rc)):
            with torch.no_grad():
                y = (rf.resnetfc_dense(z, x, tw, 5, True) if NS == 1
                     else rf.resnetfc_dense_mv(z, x, tw, 5, NS, 3, sb, True))
            torch.cuda.synchronize()
            key = f"NS {NS} SB {sb} x {B} {label}"
            out[key] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


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
