"""The train slice's module-level pieces against the JAX package, on the CPU:
the ``gather_taps`` backward, BatchNorm in train mode, the losses, the lr
schedules and the optimizer against optax, ``prepare_ray_batch`` and the
``DataLoader``.  Inputs are made with numpy from a seed and handed to both
packages; each test states its tolerance."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.data import get_split_dataset as jget_split_dataset
from pixelnerf_tpu.data.loader import DataLoader as JDataLoader
from pixelnerf_tpu.data.loader import collate as jcollate
from pixelnerf_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from pixelnerf_tpu.models import losses as jlosses
from pixelnerf_tpu.models.encoder import SpatialEncoder as JSpatialEncoder
from pixelnerf_tpu.train.trainer import prepare_ray_batch as jprepare_ray_batch
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import DataLoader, collate, get_split_dataset
from pixelnerf_tpu_torch.data.synthetic import SyntheticDataset
from pixelnerf_tpu_torch.models import losses
from pixelnerf_tpu_torch.models.encoder import SpatialEncoder
from pixelnerf_tpu_torch.ops import grid_sample as gs
from pixelnerf_tpu_torch.train.trainer import Optimizer, make_schedule, prepare_ray_batch
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

# the ops package re-exports a function under the module's name
jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")


def _taps(B, N, T, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, T, size=(B, N, 8)).astype(np.int32)
    w = rng.uniform(0, 1, size=(B, N, 8)).astype(np.float32)
    w[..., 4:] = 0.0  # zero-weight padding taps, as index_taps makes them
    g = rng.normal(size=(B, N, 16)).astype(np.float32)
    table = rng.normal(size=(B, T, 16)).astype(np.float32)
    return table, idx, w, g


def _port_vjp(table, idx, w, g):
    flat = (table if torch.is_tensor(table) else torch.from_numpy(table)).requires_grad_()
    W = torch.from_numpy(w).requires_grad_()
    out = gs.gather_taps(flat, torch.from_numpy(idx), W)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return out, flat.grad, W.grad


def _jax_vjp(table, idx, w, g):
    out, vjp = jax.vjp(lambda f, ww: jgs.gather_taps(f, jnp.asarray(idx), ww),
                       jnp.asarray(table), jnp.asarray(w))
    d_flat, d_w = vjp(jnp.asarray(g).astype(out.dtype))
    return out, d_flat, d_w


def test_gather_taps_backward_matches_jax_bf16_table():
    """A bf16 table: the table gradient comes back in bf16 and the tap
    weights get a zero cotangent, as in JAX.  Tolerance 1e-2 of max|ref|: the
    JAX one-hot backward rounds g and w to bf16 before its f32 sum, the port
    sums their f32 products."""
    table, idx, w, g = _taps(2, 300, 40)
    tb = torch.from_numpy(table).bfloat16()
    out, d_flat, d_w = _port_vjp(tb.detach().clone(), idx, w, g)
    jout, jd_flat, jd_w = _jax_vjp(jnp.asarray(table).astype(jnp.bfloat16), idx, w, g)
    assert out.dtype == d_flat.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(jout, np.float32))
    ref = np.asarray(jd_flat, np.float32)
    err = np.abs(d_flat.float().numpy() - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err
    assert not d_w.any() and not np.asarray(jd_w).any()


def test_gather_taps_backward_accumulates_in_f32():
    """Many contributions to one table row: the f32 sum is cast to the
    table's dtype once, at the end.  80,000 increments of 2^-12 are exact in
    f32 (19.53125), where a bf16 running sum would stall at 2^-4; the f32
    table gets the exact sum, the bf16 table its one rounding (2^-8).  Then
    random taps against a float64 scatter-add to 1e-5 of max|ref|."""
    B, N, T = 1, 20000, 8
    idx = np.zeros((B, N, 4), np.int32)
    w = np.full((B, N, 4), 0.25, np.float32)
    g = np.full((B, N, 16), 2.0 ** -10, np.float32)
    table = np.zeros((B, T, 16), np.float32)
    for dtype, tol in ((torch.float32, 0.0), (torch.bfloat16, 2 ** -8)):
        _, d_flat, _ = _port_vjp(torch.from_numpy(table).to(dtype), idx, w, g)
        assert abs(d_flat[0, 0, 0].item() - 19.53125) <= tol * 19.53125, (dtype, d_flat[0, 0, 0])
    table, idx, w, g = _taps(2, 500, 30, seed=1)
    _, d_flat, _ = _port_vjp(torch.from_numpy(table), idx, w, g)
    ref = np.zeros(table.shape, np.float64)
    for b in range(2):
        for j in range(8):
            np.add.at(ref[b], idx[b, :, j], g[b] * w[b, :, j, None].astype(np.float64))
    assert np.abs(d_flat.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_batchnorm_train_mode_matches_flax():
    """One train-mode encoder pass: the features and the updated running
    statistics equal flax's (biased batch variance, momentum 0.9) to 1e-5 of
    max(1, max|ref|)."""
    kw = dict(backbone="resnet18", num_layers=2, use_first_pool=False)
    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    jenc = JSpatialEncoder(**kw)
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jout, mutated = jenc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    enc = SpatialEncoder(**kw)
    sd = from_jax_variables({"params": {"encoder": variables["params"]},
                             "batch_stats": {"encoder": variables["batch_stats"]}})
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    enc.train()
    out = enc(torch.from_numpy(x))
    new = from_jax_variables({"params": {}, "batch_stats": {"encoder": mutated["batch_stats"]}})

    def close(a, b, what):
        b = np.asarray(b)
        err = np.abs(a.detach().numpy() - b).max()
        assert err <= 1e-5 * max(1.0, np.abs(b).max()), (what, err)

    close(out, jout, "features")
    state = enc.state_dict()
    assert new and all(k[len("encoder."):] in state for k in new)
    for k, v in new.items():
        if "running" in k:
            close(state[k[len("encoder."):]], v.numpy(), k)
    bn = enc.model.bn1
    assert int(bn.num_batches_tracked) == 1
    # torch's own layer would have taken the unbiased variance
    assert not np.allclose(bn.running_var.numpy(), torch.nn.BatchNorm2d(64).running_var.numpy())


@pytest.mark.parametrize("kind", ["l1", "l2", "uncertainty", "background", "alpha", "opaque"])
def test_losses_match_jax(kind):
    rng = np.random.default_rng(1)
    pred, target = (rng.uniform(0, 1, size=(3, 50, 3)).astype(np.float32) for _ in range(2))
    extra = rng.uniform(0.2, 2.0, size=(3, 50)).astype(np.float32)
    alpha = rng.uniform(0, 1, size=(3, 50)).astype(np.float32)
    T = torch.from_numpy
    if kind in ("l1", "l2"):
        text = f"type = {kind}" if kind == "l1" else "use_l1 = False"
        got = losses.get_rgb_loss(hocon.parse_string(text))(T(pred), T(target))
        ref = jlosses.get_rgb_loss(jhocon.parse_string(text))(pred, target)
    elif kind == "uncertainty":
        text = "use_uncertainty = True\ntype = l1"
        got = losses.get_rgb_loss(hocon.parse_string(text), coarse=False)(T(pred), T(target), T(extra))
        ref = jlosses.get_rgb_loss(jhocon.parse_string(text), coarse=False)(pred, target, extra)
    elif kind == "background":
        got = losses.rgb_with_background(T(pred), T(target), T(extra))
        ref = jlosses.rgb_with_background(pred, target, extra)
    else:
        text = ("lambda_alpha = 0.5\nclamp_alpha = 3\ninit_epoch = 2\nforce_opaque = "
                + ("True" if kind == "opaque" else "False"))
        crit, jcrit = losses.get_alpha_loss(hocon.parse_string(text)), \
            jlosses.get_alpha_loss(jhocon.parse_string(text))
        assert float(crit(T(alpha))) == 0.0 == float(jcrit(alpha))  # before init_epoch
        crit.sched_step(2)
        jcrit.sched_step(2)
        got, ref = crit(T(alpha)), jcrit(alpha)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


N_STEPS = 40


@pytest.mark.parametrize("policy,kw,ref", [
    ("const", {}, lambda lr, spe: optax.constant_schedule(lr)),
    ("exp", {"gamma": 0.8}, lambda lr, spe: optax.exponential_decay(
        lr, transition_steps=spe, decay_rate=0.8, staircase=True)),
    ("step", {"decay_epochs": 3, "decay_factor": 0.5}, lambda lr, spe: optax.exponential_decay(
        lr, transition_steps=3 * spe, decay_rate=0.5, staircase=True)),
    ("cosine", {"warmup_steps": 5, "total_steps": 30},
     lambda lr, spe: optax.warmup_cosine_decay_schedule(0.0, lr, 5, 30, end_value=0.1 * lr)),
])
def test_lr_schedules_match_optax(policy, kw, ref):
    """Steps 0..N of each lr policy against the optax schedule the JAX trainer
    builds (rtol 1e-5); the first cosine update has lr 0."""
    lr, spe = 3e-4, 4
    got = make_schedule(policy, lr, spe, **kw)
    want = ref(lr, spe)
    np.testing.assert_allclose([got(t) for t in range(N_STEPS)],
                               [float(want(t)) for t in range(N_STEPS)], rtol=1e-5, atol=1e-12)
    if policy == "cosine":
        assert got(0) == 0.0


@pytest.mark.parametrize("clip,wd,accu", [(0.0, 0.0, 1), (0.5, 0.01, 1), (0.0, 0.0, 3)])
def test_optimizer_matches_optax_chain(clip, wd, accu):
    """The Optimizer against the JAX trainer's optax chain (clip by global
    norm, decayed weights, adam on a cosine-with-warmup schedule, MultiSteps)
    over 7 steps of random gradients: parameters to 1e-6.  The first cosine
    update moves nothing (lr 0)."""
    sched_kw = dict(warmup_steps=2, total_steps=10)
    lr = 1e-2
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(2, 5)).astype(np.float32)
    grads = [rng.normal(size=(2, 5)).astype(np.float32) * 3 for _ in range(7)]

    txs = [optax.clip_by_global_norm(clip)] if clip > 0 else []
    txs.append(optax.adam(optax.warmup_cosine_decay_schedule(0.0, lr, 2, 10, end_value=0.1 * lr),
                          b1=0.9, b2=0.999))
    if wd > 0:
        txs.insert(-1, optax.add_decayed_weights(wd))
    tx = optax.chain(*txs)
    if accu > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accu)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = Optimizer([param], make_schedule("cosine", lr, 1, **sched_kw), weight_decay=wd,
                    clip=clip, accu_grad=accu)
    for i, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        with torch.no_grad():
            opt.step([torch.from_numpy(g)])
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), atol=1e-6,
                                   err_msg=f"step {i}")
        if i == accu - 1:  # the first real update runs at lr 0
            np.testing.assert_array_equal(param.detach().numpy(), p0)


@pytest.mark.parametrize("path", ["bbox", "uniform", "fg_frac", "views"])
def test_prepare_ray_batch_bit_equal_to_jax(path):
    """The same collated batch and the same numpy generator state give the
    same arrays, bit for bit."""
    ds = JSyntheticDataset(n_objs=3, n_views=4, image_size=20)
    data = jcollate([ds[i] for i in range(3)])
    kw = dict(nviews=2 if path == "views" else 1, ray_batch_size=37, z_near=0.8, z_far=1.8,
              use_bbox=path == "bbox", fg_frac=0.6 if path == "fg_frac" else 0.0)
    ref = jprepare_ray_batch(data, rng=np.random.default_rng(11), **kw)
    got = prepare_ray_batch(data, rng=np.random.default_rng(11), **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_data_loader_and_collate_match_jax():
    """Shuffled epoch orders, the collated arrays and the frozen cache; the
    synthetic splits use seeds 0/1/2; the file formats raise."""
    ds, jds = SyntheticDataset(n_objs=5, n_views=3, image_size=12), \
        JSyntheticDataset(n_objs=5, n_views=3, image_size=12)
    loader = DataLoader(ds, batch_size=2, shuffle=True, seed=3, cache_mb=0.01)
    jloader = JDataLoader(jds, batch_size=2, shuffle=True, seed=3, cache_mb=0.01)
    assert len(loader) == len(jloader) == 3
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        for a, b in zip(loader, jloader):
            assert a["img_id"] == b["img_id"]
            for k in ("images", "poses", "masks", "bbox", "focal"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert loader._cache_bytes == jloader._cache_bytes and 0 < len(loader._cache) < 5
    assert collate([None, {"x": 1}]) is None
    cropped = collate([ds[0], dict(ds[1], images=ds[1]["images"][:2])])
    assert cropped["images"].shape[1] == 2 and cropped["poses"].shape[1] == 2
    for split, seed in (("train", 0), ("val", 1), ("test", 2)):
        one = get_split_dataset("synthetic", "", want_split=split, n_objs=1, image_size=12)
        assert one.seed == seed == jget_split_dataset("synthetic", "", want_split=split).seed
    assert [d.seed for d in get_split_dataset("synthetic", "")] == [0, 1, 2]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_split_dataset("srn", "/nonexistent")
