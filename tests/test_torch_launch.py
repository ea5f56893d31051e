"""``parallel/launch.py`` on the CPU: the backend rule, and the collectives
the port uses over 2 and 3 gloo ranks (``parallel.dryrun``'s
``collectives`` leg: all_reduce, broadcast and all_gather take the tensor
as it is and give the right values; ``all_reduce_mean`` is timed).  The
rank bodies are the package's; each rank runs one thread and imports no
JAX."""

import pytest

from pixelnerf_tpu_torch.parallel import dryrun, launch


@pytest.mark.parametrize("ids,device,want", [
    ([0, 1], "cuda", "nccl"),
    ([0, 1, 2, 3], "cuda", "nccl"),
    ([0, 0], "cuda", "gloo"),
    ([0, 1, 1], "cuda", "gloo"),
    ([0, 1], "cpu", "gloo"),
    ([0], "cpu", "gloo"),
])
def test_backend_for(ids, device, want):
    """NCCL only when every rank has a card of its own."""
    assert launch.backend_for(ids, device) == want


@pytest.mark.parametrize("n", [2, 3])
def test_collectives_on_cpu_ranks(n):
    res = launch.spawn(dryrun.run_legs, list(range(n)), "cpu", dict(
        device="cpu", legs=[dict(kind="collectives", name="c", floats=4096)]))["c"]
    assert res["backend"] == "gloo"
    for name in ("all_reduce", "broadcast", "all_gather"):
        assert res[name] is True, (name, res[name])
    assert res["gradient_mean_ms"] > 0 and res["batchnorm_sum_ms"] > 0
    assert len(res["rank_wall_s"]) == n


def test_collectives_outside_a_group_are_the_identity():
    import torch

    t = torch.arange(6.0).reshape(3, 2)
    assert not launch.in_group() and launch.world_size() == 1 and launch.is_main()
    assert launch.all_reduce_mean([t])[0] is t
    assert launch.all_gather_rows(t) is t
    assert launch.broadcast_(t) is t
    assert launch.gather_objects({"a": 1}) == [{"a": 1}]
    assert launch.broadcast_object([1, 2]) == [1, 2]


def test_every_module_imports_first():
    """Each module of the port imports in a process where no other module of
    the port is loaded yet (no import cycle through ``parallel``)."""
    import pkgutil
    import subprocess
    import sys

    import pixelnerf_tpu_torch

    names = sorted(m.name for m in pkgutil.walk_packages(pixelnerf_tpu_torch.__path__,
                                                         "pixelnerf_tpu_torch."))
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    for k in [k for k in sys.modules if k.startswith('pixelnerf_tpu_torch')]:\n"
            "        del sys.modules[k]\n"
            "    try:\n"
            "        importlib.import_module(name)\n"
            "    except Exception as e:\n"
            "        print(name, type(e).__name__, e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and not out.stdout.strip(), out.stdout + out.stderr
    assert len(names) > 40
