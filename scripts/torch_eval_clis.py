"""Phase 15 of ``chip_smoke.py`` alone on the card: the remaining eval CLIs.

    python3 scripts/torch_eval_clis.py

Builds the kernels, the render phases' model (``conf/exp/sn64.conf`` at full
width, seeded, every block live) and the NMR-layout and DTU fixtures (phase
10), then runs ``chip_smoke.eval_cli_phase``: ``eval_approx``, ``eval_real``
off and auto, the DTU eval at ``--scale 1``, ``--write_depth`` and
``calc_metrics`` with LPIPS, each with its wall seconds, rays/s, peak memory
and launches, and each CLI's kernel calls replayed against their plain
versions.  The last line is the kernels' launch counts by CLI.  Needs one
CUDA card; about two minutes with the build.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.device import resolve_device
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    t0 = time.perf_counter()
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    rf.build_all()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    conf = entry.load_conf(pretrained=False)
    net = entry.build_model(conf, dev, mlp_impl="auto", seed=cs.SEED)
    g = torch.Generator().manual_seed(cs.SEED + 1)
    with torch.no_grad():  # the render phases' weights
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
    records = {k: {} for k in rf.ENTRY_POINTS}
    code_records = {k + "_code": {} for k in rf.ENTRY_POINTS}
    with tempfile.TemporaryDirectory(prefix="eval_clis_") as root:
        nmr_root, dtu_root = cs.data_phase(root, smi)
        cs.eval_cli_phase(net, dev, smi, records, code_records, nmr_root, dtu_root)
    cs.log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({k: r["eval_cli_launches"] for k, r in {**records, **code_records}.items()
                      if "eval_cli_launches" in r}))


if __name__ == "__main__":
    main()
