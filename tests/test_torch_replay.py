"""``ops/replay.py`` on the CPU, where each wrapper runs its plain version:
``KernelCalls`` keeps the first call of a wrapper at each shape and tower
(so each head of a model is kept), keeps copies of its inputs and output
(a later in-place change does not reach the replay), restores the wrappers
on exit, and ``check`` holds each kept call against its plain version at
the Pallas tests' bar."""

import numpy as np
import torch

from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops.replay import KernelCalls, agree

C, H, D_IN, NB = 64, 128, 39, 3


def _head(seed):
    torch.manual_seed(seed)
    return ResnetFC(d_in=D_IN, d_out=4, n_blocks=NB, d_latent=C, d_hidden=H, combine_layer=3,
                    impl="torch")


def _inputs(B, seed=0):
    g = np.random.default_rng(seed)
    z = torch.from_numpy(g.normal(size=(B, C)).astype(np.float32)).bfloat16()
    x = torch.from_numpy(g.normal(size=(B, D_IN)).astype(np.float32))
    return z, x


def test_keeps_each_head_and_shape_once():
    cpu = torch.device("cpu")
    towers = [_head(s).tower(cpu) for s in (0, 1)]
    wrapper = rf.resnetfc_dense
    with KernelCalls() as calls:
        assert rf.resnetfc_dense is not wrapper
        for B in (100, 100, 60):
            z, x = _inputs(B)
            for tw in towers:
                rf.resnetfc_dense(z, x, tw, NB, True)
    assert rf.resnetfc_dense is wrapper
    assert calls.launches() == ["resnetfc_fwd_dense"]
    rows = calls.check()
    assert sorted((r["kernel"], r["H"], r["points"]) for r in rows) == sorted(
        [("resnetfc_fwd_dense", H, 100)] * 2 + [("resnetfc_fwd_dense", H, 60)] * 2)
    assert all(r["ok"] and r["identical"] for r in rows), rows


def test_replays_the_inputs_as_they_were():
    tw = _head(0).tower(torch.device("cpu"))
    z, x = _inputs(80)
    with KernelCalls() as calls:
        out = rf.resnetfc_dense(z, x, tw, NB, False)
    z.mul_(3.0)
    x.zero_()
    out.zero_()
    (row,) = calls.check()
    assert row["ok"] and row["identical"] and row["max_abs_err"] <= row["bar"]


def test_agree():
    ref = torch.linspace(-2.0, 3.0, 50)
    d, bar, corr = agree(ref + 0.01, ref)
    assert abs(d - 0.01) < 1e-6 and bar == 0.015 * 3.0 and corr > 0.9999
    d, bar, corr = agree(-ref, ref)
    assert corr < -0.999
    assert agree(torch.zeros(0), torch.zeros(0)) == (0.0, 0.015, 1.0)
