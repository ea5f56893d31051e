"""The port's device mesh (``parallel/mesh.py``) against the JAX package's,
on the CPU: the mesh shapes and their asserts on conftest's 8 devices, the
batch key table, each rank's slice of a training batch against the shard
JAX places on the device at that rank's mesh position, the train CLI's mesh
choice and ``-R`` rounding against the root ``train/train.py``'s lines, and
``--gpu_id`` with repeated and dropped ids.  No process group is started:
a mesh outside one describes any rank count and takes the rank it
describes."""

import contextlib
import io
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from pixelnerf_tpu.data import SyntheticDataset as JSyntheticDataset
from pixelnerf_tpu.data.loader import collate as jcollate
from pixelnerf_tpu.parallel import mesh as jmesh
from pixelnerf_tpu.train.trainer import prepare_ray_batch as jprepare_ray_batch
from pixelnerf_tpu_torch.config.args import parse_args
from pixelnerf_tpu_torch.data import SyntheticDataset, collate
from pixelnerf_tpu_torch.parallel import mesh
from pixelnerf_tpu_torch.train import prepare_ray_batch
from pixelnerf_tpu_torch.train.cli import mesh_choice

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n,dp", [(8, None), (8, 2), (8, 4), (8, 8), (4, 2), (6, 3), (2, 1)])
def test_train_mesh_shapes_match_jax(n, dp):
    ref = jmesh.make_train_mesh(n, data_parallel=dp)
    for rank in (0, n - 1):
        got = mesh.make_train_mesh(n, data_parallel=dp, rank=rank)
        assert got.axis_names == tuple(ref.axis_names) == ("data", "rays")
        assert got.devices_shape == ref.devices.shape
        assert got.shape == dict(ref.shape)
        assert got.size == n
        # the rank is the row-major position of its device on the JAX mesh
        pos = np.argwhere(ref.devices == jax.devices()[rank])[0]
        assert (got.coords["data"], got.coords["rays"]) == tuple(pos)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_ray_mesh_shapes_match_jax(n):
    ref = jmesh.make_ray_mesh(n)
    got = mesh.make_ray_mesh(n, rank=n - 1)
    assert got.axis_names == tuple(ref.axis_names) == ("rays",)
    assert got.devices_shape == ref.devices.shape
    assert got.coords == {"rays": n - 1}


@pytest.mark.parametrize("n,dp", [(8, 3), (6, 4)])
def test_train_mesh_asserts_as_jax(n, dp):
    with pytest.raises(AssertionError):
        jmesh.make_train_mesh(n, data_parallel=dp)
    with pytest.raises(AssertionError):
        mesh.make_train_mesh(n, data_parallel=dp)


def test_batch_key_kinds_equal_the_jax_table():
    assert mesh.BATCH_KEY_KINDS == jmesh.BATCH_KEY_KINDS


def _fullest(prepare, dataset_cls, collate_fn, n_objs=2):
    """The fullest batch prepare_ray_batch can emit: masks, and an injected
    principal point."""
    ds = dataset_cls(n_objs=2, n_views=4, image_size=24)
    data = collate_fn([ds[i] for i in range(n_objs)])
    assert "masks" in data
    data["c"] = np.full((n_objs, 2), 12.0, np.float32)
    return prepare(data, 1, 32, 0.8, 1.8, True, np.random.default_rng(0))


def test_every_batch_key_has_a_sharding():
    """The port's mirror of the JAX test of the same name: every key the
    port's prepare_ray_batch can emit has a kind, and shard_batch slices
    each of them."""
    batch = _fullest(prepare_ray_batch, SyntheticDataset, collate)
    assert set(batch) <= set(mesh.BATCH_KEY_KINDS), (
        f"prepare_ray_batch emits {sorted(set(batch) - set(mesh.BATCH_KEY_KINDS))} "
        "with no sharding kind in parallel.mesh.BATCH_KEY_KINDS"
    )
    m = mesh.make_train_mesh(8, data_parallel=2, rank=5)
    sh = mesh.shard_batch(m, batch)
    assert set(sh) == set(batch)
    with pytest.raises(KeyError, match="has no sharding kind"):
        mesh.shard_batch(m, dict(batch, extra=batch["rays"]))


@pytest.mark.parametrize("shape,n_objs", [((2, 4), 2), ((4, 2), 2), ((8, 1), 2), ((2, 4), 1)])
def test_shard_batch_matches_jax_shards(shape, n_objs):
    """Each rank's slice against the shard of the JAX batch_shardings placed
    on the device at that rank's mesh position; (4, 2), (8, 1) and one
    object on data 2 take the replicate fallback on the object axis."""
    batch = _fullest(jprepare_ray_batch, JSyntheticDataset, jcollate, n_objs)
    jm = jmesh.make_train_mesh(8, data_parallel=shape[0])
    shardings = jmesh.batch_shardings(jm, batch)
    placed = {k: jax.device_put(v, shardings[k]) for k, v in batch.items()}
    for k, sharding in shardings.items():
        assert isinstance(sharding, NamedSharding)
    for rank in range(8):
        m = mesh.make_train_mesh(8, data_parallel=shape[0], rank=rank)
        dev = jm.devices[m.coords["data"], m.coords["rays"]]
        mine = mesh.shard_batch(m, batch)
        for k, arr in placed.items():
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(mine[k], np.asarray(shard.data), err_msg=f"{k} @ {rank}")
    # the torch tensors of a device batch slice alike
    m = mesh.make_train_mesh(8, data_parallel=shape[0], rank=7)
    tb = mesh.shard_batch(m, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k, v in mesh.shard_batch(m, batch).items():
        np.testing.assert_array_equal(tb[k].numpy(), v)


TINY = """
model {
    mlp_coarse { n_blocks = 2\n d_hidden = 32 }
    mlp_fine { n_blocks = 2\n d_hidden = 32 }
    encoder { num_layers = 2\n pretrained = False }
}
renderer { n_coarse = 8\n n_fine = 4\n n_fine_depth = 2 }
"""


@pytest.fixture(scope="module")
def conf_file(tmp_path_factory):
    import shutil

    root = tmp_path_factory.mktemp("mesh_cli")
    shutil.copyfile(ROOT / "conf" / "default.conf", root / "default.conf")
    conf = root / "tiny.conf"
    conf.write_text('include required("default.conf")\n' + TINY)
    return root, str(conf)


def _root_lines(root, conf, ids, B, R, monkeypatch):
    """The mesh lines the root ``train/train.py`` prints for ``--gpu_id ids``
    on conftest's 8 CPU devices (no epoch runs)."""
    out = root / f"root_{len(ids.split())}_{B}_{R}"
    argv = ["train/train.py", "-n", "m", "-c", conf, "-F", "synthetic", "--epochs", "0",
            "-B", str(B), "-R", str(R), "--gpu_id", ids, "--checkpoints_path", str(out / "ck"),
            "--visual_path", str(out / "vis"), "--logs_path", str(out / "logs")]
    monkeypatch.setattr(sys, "argv", argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "train" / "train.py"), run_name="__main__")
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("NOTE: ray_batch_size", "Training mesh", "WARNING: --gpu_id"))]


@pytest.mark.parametrize("ids,B,R", [("0 1 2 3", 2, 7), ("0 1 2 3 4 5", 4, 10),
                                     ("0 1 2 3 4 5 6 7", 8, 5), ("0 1 2 3 4 5 6 7 8 9", 4, 9)])
def test_train_cli_mesh_choice_matches_the_root_cli(conf_file, monkeypatch, ids, B, R):
    """data = gcd(ranks, -B), rays = ranks / data, -R rounded up to a
    multiple of rays: the port's lines against the root CLI's; ten ids on
    eight devices drop two with the root CLI's warning (the port drops ids
    past the card count in ``parse_args``)."""
    root, conf = conf_file
    ref = _root_lines(root, conf, ids, B, R, monkeypatch)
    n_ids = len(ids.split())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        args, _ = parse_args(argv=["-c", conf, "--gpu_id", ids, "--checkpoints_path",
                                   str(root / "ck_port")])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("WARNING: --gpu_id")]
    assert args.gpu_id == [i for i in range(n_ids) if i < 8] and args.spawn_ranks
    n = len(args.gpu_id)
    _, R_port, mesh_lines = mesh_choice(n, B, R, "cpu")
    assert lines + mesh_lines == ref
    dp = int(ref[-1].split("data=")[1].split()[0])
    assert R_port % (n // dp) == 0 and R_port >= R


def test_gpu_id_repeated_and_dropped(conf_file, monkeypatch, capsys):
    """A repeated id is a rank sharing that card (no warning); an id past
    the card count is dropped with the JAX CLI's warning; one id is one rank
    that spawns nothing; with --device cpu ids only count ranks."""
    root, conf = conf_file
    base = ["-c", conf, "--checkpoints_path", str(root / "ck_ids")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args, _ = parse_args(argv=base + ["--gpu_id", "0 0"])
    assert args.gpu_id == [0, 0] and args.spawn_ranks and args.device == "cuda:0"
    assert "WARNING" not in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args, _ = parse_args(argv=base + ["--gpu_id", "0 1 2"])
    assert args.gpu_id == [0, 1] and args.spawn_ranks
    assert ("WARNING: --gpu_id requests 3 devices, only 2 available; using 2"
            in capsys.readouterr().out)
    args, _ = parse_args(argv=base + ["--gpu_id", "1"])
    assert args.gpu_id == [1] and not args.spawn_ranks and args.device == "cuda:1"
    args, _ = parse_args(argv=base + ["--gpu_id", "0 5 7", "--device", "cpu"])
    assert args.gpu_id == [0, 5, 7] and args.spawn_ranks and args.device == "cpu"
