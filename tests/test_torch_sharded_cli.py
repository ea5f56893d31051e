"""The train, eval and gen_video CLIs with several ``--gpu_id``s on the CPU
(``--device cpu --gpu_id '0 1'``: two ranks over gloo, started by the CLI
itself) against one id, on the synthetic set with a small conf.

The train CLI runs without AMP so that the bars are f32's: each printed
step's losses within rel 1e-5 and ``grad_norm`` within rel 2e-4 (the
sharded step's bars, ``test_torch_sharded``), the saved weights by
``test_torch_train_step``'s drift measure; rank 0 alone writes (one
checkpoint set, one TensorBoard event file).  The eval CLI's per-object
PSNR / SSIM within 1e-6 and its PNGs and journal byte for byte; the video
frames byte for byte."""

import glob
import os
import re

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.eval import eval as eval_cli
from pixelnerf_tpu_torch.eval import gen_video
from pixelnerf_tpu_torch.train import main as train_main

CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 4\n freq_factor = 1.5\n include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet\n n_blocks = 3\n d_hidden = 48\n combine_layer = 2 }
    mlp_fine { type = resnet\n n_blocks = 3\n d_hidden = 48\n combine_layer = 2 }
    encoder { backbone = resnet18\n pretrained = False\n num_layers = 2\n use_first_pool = False }
}
renderer { n_coarse = 8\n n_fine = 6\n n_fine_depth = 3\n white_bkgd = True }
train { print_interval = 1\n save_interval = 1\n vis_interval = 1000\n eval_interval = 1 }
"""
STEP = re.compile(r"^E(\d+) B(\d+) (.*) lr:")


@pytest.fixture(scope="module")
def conf(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "tiny.conf"
    path.write_text(CONF)
    return str(path)


def _steps(out: str):
    """[{loss: value}] of the train CLI's step lines."""
    rows = []
    for line in out.splitlines():
        m = STEP.match(line)
        if m:
            rows.append({k: float(v) for k, v in (kv.split(":") for kv in m.group(3).split())})
    return rows


def test_train_cli_on_two_ranks_matches_one(conf, tmp_path, capfd):
    root = tmp_path
    argvs = {f"r{len(ids.split())}": [
        "--device", "cpu", "--gpu_id", ids, "-F", "synthetic", "-c", conf,
        "-n", f"r{len(ids.split())}", "--epochs", "2", "-B", "2", "-R", "8", "--no_amp",
        "--checkpoints_path", str(root / "ck"), "--visual_path", str(root / "vis"),
        "--logs_path", str(root / "logs")] for ids in ("0", "0 1")}
    trainer = train_main(argvs["r1"])
    one = capfd.readouterr().out
    assert train_main(argvs["r2"]) is None  # the ranks ran in their own processes
    two = capfd.readouterr().out
    assert "Training mesh: data=2 x rays=1 over 2 cpu device(s)" in two
    s1, s2 = _steps(one), _steps(two)
    assert len(s1) == len(s2) == 4 and len(trainer.history) == 4
    for a, b in zip(s1, s2):
        assert sorted(a) == sorted(b)
        for k in a:
            bar = 2e-4 if k == "grad_norm" else 1e-5
            assert abs(a[k] - b[k]) <= bar * abs(a[k]) + 5e-6, (k, a, b)  # 5 printed decimals
    # rank 0 alone wrote: the same checkpoint files, one event file
    ck = {n: sorted(os.listdir(root / "ck" / n)) for n in ("r1", "r2")}
    assert ck["r1"] == ck["r2"] and "pixel_nerf_latest" in ck["r2"]
    assert len(glob.glob(str(root / "logs" / "r2" / "events.out.tfevents.*"))) == 1
    w1 = torch.load(root / "ck" / "r1" / "pixel_nerf_latest", weights_only=True)
    w2 = torch.load(root / "ck" / "r2" / "pixel_nerf_latest", weights_only=True)
    w1 = w1.get("model", w1)
    w2 = w2.get("model", w2)
    drifted = total = 0
    for k, v in w1.items():
        if "running" in k:
            torch.testing.assert_close(w2[k], v, rtol=1e-5, atol=1e-5, msg=k)
        elif v.is_floating_point():
            drifted += int(((w2[k] - v).abs() > 0.25 * 4 * 1e-4).sum())
            total += v.numel()
    assert drifted / total < 1e-3, (drifted, total)


def test_eval_cli_on_two_ranks_matches_one(conf, tmp_path):
    runs = {}
    for ids in ("0", "0 1"):
        out = tmp_path / f"ev{len(ids.split())}"
        runs[ids] = eval_cli.main(["--device", "cpu", "--gpu_id", ids, "-n", "t", "-c", conf,
                                   "-F", "synthetic", "--split", "test", "-P", "0",
                                   "--max_objs", "2", "-O", str(out), "-R", "500",
                                   "--scale", "0.25",
                                   "--checkpoints_path", str(tmp_path / "ck")])
    one, two = runs["0"], runs["0 1"]
    assert len(one["objects"]) == len(two["objects"]) == 2
    for (n1, p1, s1), (n2, p2, s2) in zip(one["objects"], two["objects"]):
        assert n1 == n2 and abs(p1 - p2) <= 1e-6 and abs(s1 - s2) <= 1e-6
    files = sorted(os.path.relpath(p, tmp_path / "ev1")
                   for p in glob.glob(str(tmp_path / "ev1" / "**" / "*.*"), recursive=True))
    assert files == sorted(os.path.relpath(p, tmp_path / "ev2") for p in glob.glob(
        str(tmp_path / "ev2" / "**" / "*.*"), recursive=True))
    assert any(f.endswith(".png") for f in files) and "finish.txt" in files
    for f in files:
        assert (tmp_path / "ev1" / f).read_bytes() == (tmp_path / "ev2" / f).read_bytes(), f


def test_gen_video_on_two_ranks_matches_one(conf, tmp_path):
    frames = {}
    for ids in ("0", "0 1"):
        res = gen_video.main(["--device", "cpu", "--gpu_id", ids, "-n", "t", "-c", conf,
                              "-F", "synthetic", "--split", "test", "-S", "0", "-P", "0",
                              "--num_views", "2", "--scale", "0.25",
                              "--visual_path", str(tmp_path / ids),
                              "--checkpoints_path", str(tmp_path / "ck")])
        frames[ids] = res["frames"]
        pngs = sorted(glob.glob(str(tmp_path / ids / "t" / "*_frames" / "*.png")))
        assert len(pngs) == 2
    assert frames["0"].shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(frames["0 1"], frames["0"])
