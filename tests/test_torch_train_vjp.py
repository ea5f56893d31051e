"""The port's differentiable ResnetFC (``ops/resnetfc_vjp.py``) against the
JAX package.

The JAX side is ``resnetfc_pallas_diff`` -- the Pallas forward and
``_bwd_kernel`` -- run as ``tests/test_pallas_vjp.py`` runs it on the CPU
(``interpret=True``, f32 throughout); the port side is its autograd Function
on CPU tensors, whose backward is the plain transcription of
``_bwd_kernel``.  Cases: the NS = 1 rows of ``test_pallas_vjp.CASES`` at
widths up to 128.  Tolerances are those of ``test_pallas_vjp``: the value to
rtol 2e-4, every gradient to 5e-4 of max(max|ref|, 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops.resnetfc_vjp import resnetfc_pallas_diff
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

CASES = [
    # sb, B_obj, d_in, d_latent, d_hidden, n_blocks, combine_layer
    (1, 150, 42, 128, 128, 5, 3),  # a latent, ragged against the 128-point block
    (1, 100, 39, 0, 128, 3, 1000),  # no latent, combine past the end
    (2, 80, 42, 256, 128, 5, 3),  # superbatch of two objects
    (1, 64, 42, 96, 64, 4, 4),  # combine_layer == n_blocks
]


def _setup(sb, B_obj, d_in, d_latent, H, nb, cl):
    jm = JResnetFC(d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H, combine_layer=cl)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, d_latent + d_in)))["params"]
    rng = np.random.default_rng(0)
    # every parameter live: fc_1 and the biases are zero at init
    params = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * (0.05 if p.ndim == 1 else 1.0 / np.sqrt(p.shape[0])))
        .astype(np.float32), params)
    rows = sb * B_obj
    x = rng.normal(size=(rows, d_in)).astype(np.float32)
    z = rng.normal(size=(rows, d_latent)).astype(np.float32) if d_latent else None
    cot = rng.normal(size=(1, rows, 4)).astype(np.float32)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H,
                    combine_layer=cl, impl="cuda")
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    return params, x, z, cot, port


def _port_value_and_grads(port, x, z, cot, B_obj):
    X = torch.from_numpy(x).requires_grad_()
    Z = torch.from_numpy(z).requires_grad_() if z is not None else None
    out = port((Z, X), combine_inner_dims=(1, B_obj))
    value = torch.sum(out * torch.from_numpy(cot))
    value.backward()
    return value, X.grad, None if Z is None else Z.grad, {n: p.grad for n, p in port.named_parameters()}


def _close(b, a, what):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(np.abs(a).max(), 1e-3)
    np.testing.assert_allclose(b, a, atol=5e-4 * scale, err_msg=f"grad mismatch at {what}")


@pytest.mark.parametrize("sb,B_obj,d_in,d_latent,H,nb,cl", CASES)
def test_function_value_and_grads_match_pallas_interpret(sb, B_obj, d_in, d_latent, H, nb, cl):
    params, x, z, cot, port = _setup(sb, B_obj, d_in, d_latent, H, nb, cl)

    def loss(p, z, x):
        out = resnetfc_pallas_diff(p, (z, x), NS=1, d_latent=d_latent, d_in=d_in, n_blocks=nb,
                                   combine_layer=cl, sb=sb, block_points=128,
                                   bwd_block_points=128, interpret=True)
        return jnp.sum(out * cot)

    argnums = (0, 2) if z is None else (0, 1, 2)
    zj = None if z is None else jnp.asarray(z)
    v_ref, g_ref = jax.value_and_grad(loss, argnums=argnums)(params, zj, jnp.asarray(x))
    rv.reset_launches()
    value, dx, dz, dparams = _port_value_and_grads(port, x, z, cot, sb * B_obj)
    assert rv.LAUNCHES == {"resnetfc_bwd_data": 0, "resnetfc_bwd_weights": 0}  # CPU: plain

    np.testing.assert_allclose(value.item(), float(v_ref), rtol=2e-4)
    ref_params = from_jax_variables({"params": {"mlp_coarse": jax.tree.map(np.asarray, g_ref[0])}})
    assert sorted(k[len("mlp_coarse."):] for k in ref_params) == sorted(dparams)
    for k, v in ref_params.items():
        _close(dparams[k[len("mlp_coarse."):]], v.numpy(), k)
    _close(dx, g_ref[-1], "x")
    if z is not None:
        _close(dz, g_ref[1], "z")


@pytest.mark.parametrize("sb,B_obj,d_in,d_latent,H,nb,cl", CASES)
def test_function_grads_match_plain_autograd(sb, B_obj, d_in, d_latent, H, nb, cl):
    """The Function's transcribed backward against autograd of the plain
    forward, both f32: 1e-5 of max|ref|."""
    _, x, z, cot, port = _setup(sb, B_obj, d_in, d_latent, H, nb, cl)
    plain = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H,
                     combine_layer=cl, impl="torch")
    plain.load_state_dict(port.state_dict())
    got = _port_value_and_grads(port, x, z, cot, sb * B_obj)
    ref = _port_value_and_grads(plain, x, z, cot, sb * B_obj)
    pairs = [("value", got[0], ref[0]), ("x", got[1], ref[1]), ("z", got[2], ref[2])]
    pairs += [(k, got[3][k], ref[3][k]) for k in ref[3]]
    for what, a, b in pairs:
        if b is None:
            assert a is None, what
            continue
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * b.abs().max().item(), (what, err)


def test_plain_backward_rounds_where_the_kernel_rounds():
    """With ``compute_dtype=bf16`` the plain backward's weight gradients take
    bf16 operands and cotangents: the lin_out gradient is exactly
    t^T bf16(g) over the bf16-rounded forward operand t."""
    _, x, z, cot, port = _setup(1, 40, 42, 32, 64, 3, 2)
    tw = port.tower(torch.device("cpu"))
    X, Z = torch.from_numpy(x), torch.from_numpy(z)
    g = torch.from_numpy(cot[0]).t().contiguous()
    ops = rv.forward_operands(Z, X, tw, 3, torch.bfloat16)
    gr = rv.resnetfc_bwd_reference(g, Z, X, tw, 3, compute_dtype=torch.bfloat16)
    t = ops[-1]
    assert torch.equal(t, t.bfloat16().float())
    torch.testing.assert_close(gr.w_out, t.t() @ g.t().bfloat16().float(), rtol=0, atol=0)
    same = rv.resnetfc_bwd_reference(g, Z, X, tw, 3, compute_dtype=torch.bfloat16, operands=ops)
    for name in rv.Grads._fields:
        torch.testing.assert_close(getattr(gr, name), getattr(same, name), rtol=0, atol=0)
    f32 = rv.resnetfc_bwd_reference(g, Z, X, tw, 3)
    assert not torch.equal(gr.w_in, f32.w_in)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    _, x, z, cot, port = _setup(1, 40, 42, 32, 64, 3, 2)
    tw = port.tower(torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rv.bwd_data(torch.zeros(4, 40), torch.from_numpy(z), torch.from_numpy(x), tw, 3, True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card(cuda_device):
    """sn64 widths, ragged B: every output of the two backward kernels
    against the plain bf16 backward walked through the kernel's stashed
    forward operands, to the bar of tests/test_pallas.py, and bit-identical
    on a second call."""
    nb, B = 5, 1000
    _, x, z, _, port = _setup(1, B, 42, 512, 512, nb, 3)
    tw = port.to(cuda_device).tower(cuda_device)
    x = torch.from_numpy(x).to(cuda_device)
    z = torch.from_numpy(z).to(cuda_device).to(torch.bfloat16)
    g = torch.randn(4, B, device=cuda_device)
    before = dict(rv.LAUNCHES)
    data = rv.bwd_data(g, z, x, tw, nb, True)
    gr = rv.bwd_weights(z, data, tw, nb)
    torch.cuda.synchronize()
    assert all(rv.LAUNCHES[k] == before[k] + 1 for k in before)
    ref = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16,
                                    operands=data.ws_act[:, :B].float())
    for name in rv.Grads._fields:
        out, r = getattr(gr, name).float(), getattr(ref, name)
        assert (out - r).abs().max().item() <= 0.015 * max(1.0, r.abs().max().item()), name
        assert torch.corrcoef(torch.stack([out.flatten(), r.flatten()]))[0, 1] > 0.999, name
    again = rv.resnetfc_bwd(g, z, x, tw, nb)
    assert all(torch.equal(getattr(gr, n), getattr(again, n)) for n in rv.Grads._fields)
    with pytest.raises(TypeError):
        rv.bwd_data(g, z.float(), x, tw, nb, True)  # no silent cast
