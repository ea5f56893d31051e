"""Phase 20 of ``chip_smoke.py`` alone on the card: several ranks.

    python3 scripts/torch_multichip.py

Builds the kernels (before any rank starts: the ranks load the libraries)
and the NMR-layout fixture of phase 10, then runs
``chip_smoke.multichip_phase``: ``entry.dryrun_multichip(4, "cuda")`` (four
ranks sharing card 0 over gloo), one launch of two ranks on card 0 running
the gloo probe and the train, eval and gen_video CLIs, each against the
same CLI on one rank, every rank's kernel calls replayed against their
plain versions, then the root smoke tools' twins.  The last line is the
kernels' launches by path, summed over the ranks.  Needs one CUDA card;
about two minutes with the build.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    from pixelnerf_tpu_torch.data import synthetic as psynth
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    rf.build_all()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    records = {k: {} for k in rf.ENTRY_POINTS + ("resnetfc_bwd_data", "resnetfc_bwd_weights")}
    code_records = {k + "_code": {} for k in rf.ENTRY_POINTS}
    with tempfile.TemporaryDirectory(prefix="multichip_") as root:
        nmr_root = os.path.join(root, "nmr")
        psynth.write_synthetic_dvr(nmr_root, n_objs=cs.NMR_OBJS, n_views=cs.NMR_VIEWS,
                                   image_size=cs.FRAME, seed=cs.SEED)
        cs.multichip_phase(smi, records, code_records, nmr_root)
    cs.log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({k: r["multichip_launches"] for k, r in {**records, **code_records}.items()
                      if "multichip_launches" in r}))


if __name__ == "__main__":
    main()
