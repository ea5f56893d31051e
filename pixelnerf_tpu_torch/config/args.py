"""Shared CLI argument parsing: the JAX package's flag names and defaults
(the reference CLI surface), the ``expconf.conf`` lookup of conf and data
directory by experiment name, and ``--device``.

``--gpu_id`` with one id picks ``cuda:<id>``; several ids ask for one rank
each (``parallel.launch``), rank ``k`` on ``cuda:<ids[k]>``; an id given
twice puts two ranks on one card.  An id past the card count is dropped with
a warning, as the JAX CLI drops devices it does not have.  With ``--device
cpu`` the ids only count the ranks.  ``args.spawn_ranks`` is set when the
caller should start the ranks (several ids, and this process in no group
yet and not started by ``torchrun``).
"""

from __future__ import annotations

import argparse
import os

import torch

from . import hocon

PROJECT_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def parse_args(
    callback=None,
    training=False,
    default_conf="conf/default_mv.conf",
    default_expname="example",
    default_data_format="dvr",
    default_num_epochs=10000000,
    default_lr=1e-4,
    default_gamma=1.00,
    default_datadir="data",
    default_ray_batch_size=50000,
    argv=None,
):
    # (long flag, short flag | None, type, default, help): the reference
    # CLI's names and defaults
    flag_table = [
        ("conf", "c", str, None, "HOCON config path (resolved via expconf.conf when omitted)"),
        ("gpu_id", None, str, "0", "CUDA device id; more than one id is a multi-device run"),
        ("name", "n", str, default_expname,
         "experiment name (keys conf/datadir lookup in expconf.conf)"),
        ("dataset_format", "F", str, None,
         "loader family: multi_obj | dvr | dvr_gen | dvr_dtu | srn | synthetic"),
        ("exp_group_name", "G", str, None,
         "optional subdirectory grouping related runs under the output paths"),
        ("logs_path", None, str, "logs", "where logs go"),
        ("checkpoints_path", None, str, "checkpoints", "where checkpoint trees go"),
        ("visual_path", None, str, "visuals", "where visualizations go"),
        ("epochs", None, int, default_num_epochs,
         "training horizon in epochs (default: effectively unbounded)"),
        ("lr", None, float, default_lr, "optimizer learning rate"),
        ("gamma", None, float, default_gamma, "per-epoch exponential lr decay (1.0 = off)"),
        ("datadir", "D", str, None, "dataset root directory"),
        ("ray_batch_size", "R", int, default_ray_batch_size,
         "upper bound on rays per render/train dispatch"),
        ("device", None, str, None, "cuda (default) or cpu"),
    ]
    parser = argparse.ArgumentParser()
    parser.add_argument("--resume", "-r", action="store_true",
                        help="pick up training from the newest checkpoint")
    for long, short, typ, default, text in flag_table:
        names = [f"--{long}"] + ([f"-{short}"] if short else [])
        parser.add_argument(*names, type=typ, default=default, help=text)
    if callback is not None:
        parser = callback(parser)
    args = parser.parse_args(argv)

    if args.exp_group_name is not None:
        args.logs_path = os.path.join(args.logs_path, args.exp_group_name)
        args.checkpoints_path = os.path.join(args.checkpoints_path, args.exp_group_name)
        args.visual_path = os.path.join(args.visual_path, args.exp_group_name)

    os.makedirs(os.path.join(args.checkpoints_path, args.name), exist_ok=True)

    expconf_path = os.path.join(PROJECT_ROOT, "expconf.conf")
    expconf = hocon.parse_file(expconf_path) if os.path.exists(expconf_path) else hocon.ConfigTree()
    if args.conf is None:
        args.conf = expconf.get_string("config." + args.name, default_conf)
    if args.datadir is None:
        args.datadir = expconf.get_string("datadir." + args.name, default_datadir)

    conf_path = args.conf
    if not os.path.isabs(conf_path) and not os.path.exists(conf_path):
        candidate = os.path.join(PROJECT_ROOT, conf_path)
        if os.path.exists(candidate):
            conf_path = candidate
    conf = hocon.parse_file(conf_path)

    if args.dataset_format is None:
        args.dataset_format = conf.get_string("data.format", default_data_format)

    args.gpu_id = list(map(int, args.gpu_id.split()))
    on_cards = args.device is None or torch.device(args.device).type == "cuda"
    n_req = len(args.gpu_id)
    if on_cards and n_req > 1:
        kept = [i for i in args.gpu_id if i < torch.cuda.device_count()] or args.gpu_id[:1]
        if len(kept) < n_req:
            print(f"WARNING: --gpu_id requests {n_req} devices, only {len(kept)} available; "
                  f"using {len(kept)}")
            args.gpu_id = kept
    # imported here: the parallel package imports the models, which import this module
    from ..parallel import launch

    in_group = len(args.gpu_id) > 1 and launch.join_torchrun(args.gpu_id,
                                                              "cuda" if on_cards else "cpu")
    args.spawn_ranks = len(args.gpu_id) > 1 and not in_group
    if args.device is None:
        args.device = f"cuda:{args.gpu_id[launch.rank()]}"
    if args.spawn_ranks:
        return args, conf

    print("EXPERIMENT NAME:", args.name)
    if training:
        print("CONTINUE?", "yes" if args.resume else "no")
    print("* Config file:", args.conf)
    print("* Dataset format:", args.dataset_format)
    print("* Dataset location:", args.datadir)
    print("* Device:", args.device)
    return args, conf
