"""The root smoke tools' twins (``pixelnerf_tpu_torch/tools``) on the CPU:
``check_config`` prints what the root ``check_config.py`` prints for every
shipped experiment conf; ``memory_smoke`` reads the synthetic set as the
root ``test_memory.py`` does (the same sample line) and passes;
``training_smoke`` takes its steps on the port's Trainer with finite losses
and prints the root ``test_training.py``'s fields."""

import contextlib
import io
import re
import runpy
import sys
from pathlib import Path

import pytest

from pixelnerf_tpu_torch.tools import check_config, memory_smoke, training_smoke

ROOT = Path(__file__).resolve().parent.parent
CONFS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "conf" / "exp").glob("*.conf"))


def _root_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    monkeypatch.chdir(ROOT)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_path(str(ROOT / name), run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
    return buf.getvalue()


@pytest.mark.parametrize("conf", CONFS)
def test_check_config_prints_the_root_tools_lines(conf, monkeypatch, capsys):
    ref = _root_tool("check_config.py", [conf], monkeypatch)
    assert check_config.main([conf]) == 0
    assert capsys.readouterr().out == ref
    assert ref.rstrip().endswith("Config OK")


def test_memory_smoke_passes_with_the_root_tools_sample_line(monkeypatch, capsys):
    ref = _root_tool("test_memory.py", ["--iters", "4"], monkeypatch)
    assert memory_smoke.main(["--iters", "4"]) == 0
    out = capsys.readouterr().out

    def line(text, start):
        return next(ln for ln in text.splitlines() if ln.startswith(start))

    assert re.sub(r"\(.*s\)", "", line(out, "single sample")) == re.sub(
        r"\(.*s\)", "", line(ref, "single sample"))
    assert line(out, "dataset:").split(",")[0] == line(ref, "dataset:").split(",")[0]
    assert "MEMORY TEST PASSED" in out
    assert re.search(r"batch_size 2: 4 batches in [\d.]+s \(\d+ ms/batch\), rss growth [+-]\d+ MB",
                     out)


def test_training_smoke_steps_on_the_port_trainer(tmp_path, capsys):
    conf = tmp_path / "tiny.conf"
    conf.write_text("""
model {
    use_encoder = True\n use_xyz = True\n use_code = True\n use_viewdirs = True
    code { num_freqs = 4\n freq_factor = 1.5\n include_input = True }
    mlp_coarse { type = resnet\n n_blocks = 3\n d_hidden = 48\n combine_layer = 2 }
    mlp_fine { type = resnet\n n_blocks = 3\n d_hidden = 48\n combine_layer = 2 }
    encoder { backbone = resnet18\n pretrained = False\n num_layers = 2\n use_first_pool = False }
}
renderer { n_coarse = 8\n n_fine = 6\n n_fine_depth = 3\n white_bkgd = True }
""")
    assert training_smoke.main(["-c", str(conf), "--steps", "3", "-R", "16",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    steps = re.findall(r"\[step (\d)\] prep \d+ ms, fwd\+bwd\+update \d+ ms, loss ([\d.]+), "
                       r"rss \d+ MB", out)
    assert [s for s, _ in steps] == ["0", "1", "2"]
    assert re.search(r"\[setup\] model: [\d,]+ params, rss \d+ MB", out)
    assert re.search(r"RESULT: compile\+first step [\d.]+s; steady state [\d.]+s/step", out)
    assert "losses finite: True" in out and "SMOKE TEST PASSED" in out
