"""The port's ResnetFC and its field kernels' plain versions against the JAX
package: the Pallas towers run as ``tests/test_pallas.py`` runs them on the
CPU (``interpret=True``, f32 throughout), the XLA ResnetFC for the plain
forward.  Tolerance: 1e-4 of max(1, max|ref|).  The kernels themselves run
only on a CUDA card (marker ``cuda``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops import resnetfc_pallas as rp
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

TOL = 1e-4


def close(port, ref, tol=TOL):
    port, ref = port.detach().cpu().numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    bar = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bar, f"max|d| {err:.3g} > {bar:.3g}"


def _pair(d_in, d_latent, H, nb, combine_layer, beta=0.0, use_spade=False,
          combine_type="average", impl="torch", seed=0):
    """A JAX ResnetFC with every parameter drawn from numpy (fc_1 and biases
    included) and the port module holding the same weights."""
    kw = dict(d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H, beta=beta,
              combine_layer=combine_layer, combine_type=combine_type, use_spade=use_spade)
    jm = JResnetFC(**kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((4, d_latent + d_in)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) / np.sqrt(p.shape[0] if p.ndim == 2 else 10.0))
        .astype(np.float32), params)
    port = ResnetFC(d_in=d_in, impl=impl, **kw)
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    return jm, params, port


def _inputs(B, d_in, C, T, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(B, d_in)).astype(np.float32)
    z = rng.normal(size=(B, C)).astype(np.float32)
    table = rng.normal(size=(T, C)).astype(np.float32)
    idx = rng.integers(0, T, size=(B, 8)).astype(np.int32)
    w = rng.uniform(0, 1, size=(B, 8)).astype(np.float32)
    w[:, 4:] = 0.0
    return x, z, table, idx, w


@pytest.mark.parametrize(
    "route,planar,combine_layer,d_latent",
    [
        ("gather", True, 3, 32),
        ("gather", False, 2, 32),
        ("dense", True, 3, 32),
        ("dense", False, 1000, 32),
        ("dense", True, 1000, 0),
    ],
)
def test_plain_towers_match_pallas_interpret(route, planar, combine_layer, d_latent):
    d_in, H, nb, B, T = 42, 64, 3, 150, 48  # B ragged against the 128-row Pallas block
    _, params, port = _pair(d_in, d_latent, H, nb, combine_layer, impl="cuda")
    x, z, table, idx, w = _inputs(B, d_in, max(d_latent, 1), T)
    kw = dict(NS=1, d_latent=d_latent, d_in=d_in, n_blocks=nb, combine_layer=combine_layer,
              planar_out=planar, block_points=128, interpret=True)
    tower = port.tower(torch.device("cpu"))
    X = torch.from_numpy(x)
    rf.reset_launches()
    if route == "gather":
        ref = rp.resnetfc_pallas(params, (rp.LatentGather(jnp.asarray(table), jnp.asarray(idx),
                                                          jnp.asarray(w)), jnp.asarray(x)), **kw)
        g = rf.LatentGather(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w))
        out = rf.resnetfc_gather(g.idx, g.w, g.table, X, tower, nb, planar)
        with torch.no_grad():  # the fused-gather route is eval-only
            via_module = port((g, X), combine_inner_dims=(1, B), planar_out=planar)
    else:
        zz = jnp.asarray(z) if d_latent else None
        ref = rp.resnetfc_pallas(params, (zz, jnp.asarray(x)), **kw)
        Z = torch.from_numpy(z) if d_latent else None
        out = rf.resnetfc_dense(Z, X, tower, nb, planar)
        via_module = port((Z, X), combine_inner_dims=(1, B), planar_out=planar)
    close(out, ref[0])
    close(via_module, ref)
    assert set(rf.LAUNCHES) >= {"resnetfc_fwd_dense", "resnetfc_fwd_gather"}
    assert not any(rf.LAUNCHES.values())  # CPU tensors: the plain versions


@pytest.mark.parametrize(
    "NS,beta,use_spade,combine_type",
    [(1, 0.0, False, "average"), (2, 0.0, False, "average"), (2, 2.0, True, "max"),
     (3, 0.0, True, "average")],
)
def test_plain_forward_matches_jax_xla(NS, beta, use_spade, combine_type):
    d_in, d_latent, H, nb, B = 13, 24, 32, 4, 10
    jm, params, port = _pair(d_in, d_latent, H, nb, 2, beta, use_spade, combine_type)
    zx = np.random.default_rng(2).normal(size=(2 * NS * B, d_latent + d_in)).astype(np.float32)
    for planar in (False, True):
        ref = jm.apply({"params": params}, jnp.asarray(zx), combine_inner_dims=(NS, B),
                       planar_out=planar)
        close(port(torch.from_numpy(zx), combine_inner_dims=(NS, B), planar_out=planar), ref)


def test_reference_init_matches_jax_scheme():
    port = ResnetFC(d_in=5, d_latent=7, d_hidden=256, n_blocks=2, combine_layer=1)
    port.reset_parameters(torch.Generator().manual_seed(0))
    sd = port.state_dict()
    assert sorted(sd) == sorted(
        f"{m}.{p}" for m in ("lin_in", "lin_z.0", "blocks.0.fc_0", "blocks.0.fc_1",
                             "blocks.1.fc_0", "blocks.1.fc_1", "lin_out")
        for p in ("weight", "bias"))
    assert all(float(v.abs().max()) == 0.0 for k, v in sd.items() if "bias" in k or "fc_1" in k)
    std = float(sd["blocks.0.fc_0.weight"].std())
    assert abs(std - (2.0 / 256) ** 0.5) < 0.01  # kaiming fan-in normal


def test_kernel_dispatch():
    _, _, port = _pair(6, 8, 16, 2, 1, impl="cuda")
    _, _, plain = _pair(6, 8, 16, 2, 1, impl="torch")
    zx = torch.from_numpy(np.random.default_rng(5).normal(size=(2 * 3, 14)).astype(np.float32))
    # NS = 2 with the view mean inside the tower: the multi-view kernel
    # route, whose plain version runs on CPU tensors
    out = port(zx, combine_inner_dims=(2, 3))
    assert out.shape == (1, 3, 4)
    close(out, plain(zx, combine_inner_dims=(2, 3)).detach().numpy())
    _, _, soft = _pair(6, 8, 16, 2, 1, beta=1.0, impl="cuda")
    with pytest.raises(ValueError, match="beta 0"):
        soft(torch.zeros(3, 14), combine_inner_dims=(1, 3))
    _, _, auto = _pair(6, 8, 16, 2, 1, beta=1.0, impl="auto")
    assert auto(torch.zeros(3, 14), combine_inner_dims=(1, 3)).shape == (1, 3, 4)
    assert not auto._kernel_route((1, 3), torch.device("cpu"))
    _, _, auto = _pair(6, 8, 16, 2, 1, impl="auto")
    assert not auto._kernel_route((1, 3), torch.device("cpu"))
    # a 16-wide tower is outside the kernels' widths: plain on the card too
    # (the route rule's envelope, tests/test_torch_wide_latent.py); a 512-wide
    # one takes the kernels there
    assert not auto._kernel_route((1, 3), torch.device("cuda"))
    assert _wide(impl="auto")._kernel_route((1, 3), torch.device("cuda"))


def _wide(**kw):
    """A tower at the kernels' hidden width (512), on the meta device."""
    with torch.device("meta"):
        return ResnetFC(d_in=6, d_out=4, n_blocks=2, d_latent=16, d_hidden=512, combine_layer=1,
                        **kw)


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_multi_view_on_card_raises(impl):
    """NS > 1 with the view mean inside the tower (``combine_layer <
    n_blocks``) is the JAX package's multi-view kernel route: card tensors
    take the multi-view kernels under ``cuda`` and ``auto`` (no longer the
    ``NotImplementedError`` this test once pinned), at NS 2 and 3.  Without
    the view mean it is plain, as in the JAX package.  A tower outside the
    kernels' widths (16 wide) is plain on the card under ``auto`` and raises
    under ``cuda``."""
    _, _, port = _pair(6, 8, 16, 2, 1, impl=impl)
    for NS in (2, 3):
        assert _wide(impl=impl)._kernel_route((NS, 3), torch.device("cuda"))
        if impl == "auto":
            assert not port._kernel_route((NS, 3), torch.device("cuda"))
        else:
            with pytest.raises(ValueError, match="d_hidden"):
                port._kernel_route((NS, 3), torch.device("cuda"))
        # CPU tensors take the plain forward under "auto", the kernels' plain
        # versions under "cuda"
        assert port._kernel_route((NS, 3), torch.device("cpu")) == (impl == "cuda")
    _, _, no_mean = _pair(6, 8, 16, 2, 1000, impl=impl)
    assert not no_mean._kernel_route((2, 3), torch.device("cuda"))
    _, _, at_end = _pair(6, 8, 16, 2, 2, impl=impl)  # combine_layer == n_blocks
    assert not at_end._kernel_route((3, 3), torch.device("cuda"))


@pytest.mark.parametrize("combine_layer", [3, 1000])
def test_kernel_route_trains_like_the_plain_route(combine_layer):
    """The dense kernel route is differentiable: on the CPU, ``impl="cuda"``
    (the autograd Function over the kernels' plain versions) gives the
    parameter, ``z`` and ``x`` gradients of ``impl="torch"`` (autograd of the
    plain forward), f32, to 1e-5 of max|ref|."""
    d_in, d_latent, H, nb, B = 42, 32, 64, 5, 70
    _, _, plain = _pair(d_in, d_latent, H, nb, combine_layer, impl="torch")
    _, _, kern = _pair(d_in, d_latent, H, nb, combine_layer, impl="cuda")
    x, z, *_ = _inputs(B, d_in, d_latent, 8)
    cot = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 4, B)).astype(np.float32))
    grads = []
    for m in (plain, kern):
        Z, X = torch.from_numpy(z).requires_grad_(), torch.from_numpy(x).requires_grad_()
        out = m((Z, X), combine_inner_dims=(1, B), planar_out=True)
        assert out.requires_grad
        (out * cot).sum().backward()
        grads.append(dict({n: p.grad for n, p in m.named_parameters()}, z=Z.grad, x=X.grad))
    ref, got = grads
    assert sorted(ref) == sorted(got)
    for k, v in ref.items():
        assert got[k] is not None, k
        assert (got[k] - v).abs().max().item() <= 1e-5 * v.abs().max().item(), k


def test_kernel_route_packs_substituted_parameters():
    """Parameters substituted through ``torch.func.functional_call`` (the
    trainer's per-step bf16 copies under AMP) are packed on every call: a
    new set of weights at the address of the last one, at version 0 (here:
    fresh tensors over the same numpy buffers), must not reuse its packed
    tower."""
    from torch.func import functional_call

    d_in, d_latent, H, nb, B = 42, 32, 64, 3, 20
    _, _, plain = _pair(d_in, d_latent, H, nb, 2, impl="torch")
    _, _, kern = _pair(d_in, d_latent, H, nb, 2, impl="cuda")
    x, z, *_ = _inputs(B, d_in, d_latent, 8)
    args = ((torch.from_numpy(z), torch.from_numpy(x)),)
    base = {n: p.detach().numpy().copy() for n, p in kern.named_parameters()}
    bufs = {n: v.copy() for n, v in base.items()}
    for scale in (1.0, 0.5, 2.0):
        for n, v in bufs.items():
            np.copyto(v, base[n] * scale)
        sub = {n: torch.from_numpy(v) for n, v in bufs.items()}
        with torch.no_grad():
            out = functional_call(kern, sub, args, {"combine_inner_dims": (1, B)})
            ref = functional_call(plain, sub, args, {"combine_inner_dims": (1, B)})
        close(out, ref.numpy())


def test_fused_gather_route_is_eval_only():
    """As in the JAX package the fused-gather kernel has no backward: with
    grad enabled and parameters that require grad it raises, never returning
    a detached result; under no_grad it runs."""
    _, _, port = _pair(6, 8, 16, 2, 1, impl="cuda")
    x, _, table, idx, w = _inputs(5, 6, 8, 4)
    g = rf.LatentGather(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w))
    X = torch.from_numpy(x)
    with pytest.raises(RuntimeError, match="eval-only"):
        port((g, X), combine_inner_dims=(1, 5))
    with torch.no_grad():
        assert port((g, X), combine_inner_dims=(1, 5)).shape == (1, 5, 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["gather", "dense"])
def test_kernel_matches_plain_on_card(cuda_device, route):
    """sn64 widths, ragged B: the kernel against its bf16 plain version, to
    the bar of tests/test_pallas.py."""
    d_in, C, H, nb, B, T = 42, 512, 512, 5, 1000, 1024
    _, _, port = _pair(d_in, C, H, nb, 3, impl="cuda")
    port = port.to(cuda_device)
    tower = port.tower(cuda_device)
    x, z, table, idx, w = (torch.from_numpy(a).to(cuda_device) for a in _inputs(B, d_in, C, T))
    table = table.to(torch.bfloat16)
    zq = rf.gather_reference(idx, w, table, torch.bfloat16)
    ref = rf.resnetfc_reference(zq, x, tower, nb, compute_dtype=torch.bfloat16)
    before = dict(rf.LAUNCHES)
    if route == "gather":
        out = rf.resnetfc_gather(idx, w, table, x, tower, nb)
    else:
        out = rf.resnetfc_dense(zq.to(torch.bfloat16), x, tower, nb)
    torch.cuda.synchronize()
    name = f"resnetfc_fwd_{route}"
    assert rf.LAUNCHES[name] == before[name] + 1
    d = (out - ref).abs().max().item()
    assert d <= 0.015 * max(1.0, ref.abs().max().item())
    assert torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1] > 0.999
    with pytest.raises(TypeError):
        rf.resnetfc_gather(idx, w, table.float(), x, tower, nb)  # no silent cast
