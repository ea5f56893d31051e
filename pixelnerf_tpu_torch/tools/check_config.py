"""Validate that a HOCON experiment config parses and print its key fields:
the root ``check_config.py`` on the port's parser.

Usage: python -m pixelnerf_tpu_torch.tools.check_config [conf/exp/sn64.conf]
(a relative path that does not exist here is read from the repository root).
"""

from __future__ import annotations

import os
import sys

from ..config.args import PROJECT_ROOT
from ..config.hocon import parse_file


def resolve(path: str) -> str:
    """``path``, or the repository's file of that relative name."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return os.path.join(PROJECT_ROOT, path)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    conf_path = argv[0] if argv else "conf/exp/sn64.conf"
    print("Checking config:", conf_path)
    conf = parse_file(resolve(conf_path))

    print("\n[model]")
    model = conf["model"]
    for key in ("use_encoder", "use_xyz", "use_code", "use_viewdirs", "use_code_viewdirs",
                "use_global_encoder"):
        print(f"  {key} = {model.get(key)}")
    print(f"  encoder.backbone = {model.get_string('encoder.backbone', 'resnet34')}")
    print(f"  encoder.num_layers = {model.get_int('encoder.num_layers', 4)}")
    print("  encoder.use_multi_scale =", model.get_bool("encoder.use_multi_scale", False))
    print(f"  mlp_coarse.type = {model.get_string('mlp_coarse.type', 'resnet')}")
    print(f"  mlp_coarse.n_blocks = {model.get_int('mlp_coarse.n_blocks', 5)}")
    print(f"  mlp_coarse.d_hidden = {model.get_int('mlp_coarse.d_hidden', 128)}")
    print("  mlp_coarse.combine_layer =", model.get_int("mlp_coarse.combine_layer", 1000))

    print("\n[renderer]")
    r = conf["renderer"]
    for key in ("n_coarse", "n_fine", "n_fine_depth"):
        print(f"  {key} = {r.get_int(key, 0)}")
    print(f"  white_bkgd = {r.get('white_bkgd')}")
    print(f"  sched = {r.get_list('sched', None)}")

    print("\n[data]")
    print(f"  format = {conf.get_string('data.format', '(unset)')}")

    print("\n[train]")
    t = conf.get_config("train", None)
    if t is not None:
        for key in t.keys():
            print(f"  {key} = {t.get(key)}")
    print("\nConfig OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
