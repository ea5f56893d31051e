"""The deferred positional code (``RawCode``, row 6 of PERF.md: ``_x_feat``
inside the four forward kernels) in the port against the JAX package, on the
CPU.  Inputs are drawn from numpy seeds and handed to both.

Tolerances:
* ``materialize_code``: 1e-6 absolute.  Both take the select product exactly
  in f32 and the sin in f32; XLA's and torch's sin differ by an ulp.
* the four wrappers on CPU tensors (their plain versions, f32 throughout)
  against ``resnetfc_pallas`` with a ``RawCode`` in interpret mode: 1e-4 of
  max(1, max|ref|), the bar of ``tests/test_torch_multiview.py`` (f32 sums
  reassociated).
* ``query`` with ``PIXELNERF_DEFER_CODE=1`` against the JAX ``query`` under
  the same variable: 2e-5 absolute in f32, the bar of the JAX package's own
  deferred-vs-default check (``tests/test_models.py``).  With
  ``compute_dtype=bfloat16`` the encoded code is rounded to bf16 on the
  plain routes of both, so an ulp of difference in a sin can flip one
  rounding; 2e-3 absolute (the gaps measured are under 1e-6; one flipped code
  element moves the output by ~1e-3 at these weights).

The kernels themselves run only on a CUDA card (marker ``cuda``): their
checks are at the end and skip here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.models import PixelNeRFNet as JPixelNeRFNet
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.models.code import PositionalEncoding as JPositionalEncoding
from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops import resnetfc_pallas as rp
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import SyntheticDataset
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.models.code import PositionalEncoding
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

PE = dict(num_freqs=6, d_in=3, freq_factor=1.5, include_input=True)  # sn64's code
TAIL = 3  # the raw viewdirs after the code block, as sn64 takes them


def close(port, ref, tol, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    assert err <= tol, f"{what} max|d| {err:.3g} > {tol:.3g}"


def _code_arrays():
    """The sn64 code's flat arrays from the JAX package and the port (equal)."""
    W, f, p, m = JPositionalEncoding(**PE).flat_arrays(tail=TAIL)
    mine = PositionalEncoding(**PE).flat_arrays(tail=TAIL)
    for a, b in zip((W, f, p, m), mine):
        np.testing.assert_array_equal(a, b)
    return W, f, p, m


def _raw(rng, rows):
    """Raw (xyz, viewdir) coordinates as the sn64 query hands them over,
    |xyz| up to ~1.4: the top frequency's argument reaches ~70 rad."""
    xyz = rng.uniform(-1.4, 1.4, size=(rows, 3))
    vd = rng.normal(size=(rows, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return np.concatenate([xyz, vd], axis=-1).astype(np.float32)


def test_materialize_code_matches_jax():
    W, f, p, m = _code_arrays()
    raw = _raw(np.random.default_rng(0), 500)
    ref = rp.materialize_code(rp.RawCode(*(jnp.asarray(a) for a in (raw, W, f, p, m))))
    rc = rf.RawCode(*(torch.from_numpy(a) for a in (raw, W, f, p, m)))
    out = rf.materialize_code(rc)
    assert out.dtype == torch.float32
    close(out, ref, 1e-6)
    # the layout is [code(xyz), viewdirs], the encoded input of the default path
    close(out, torch.cat([PositionalEncoding(**PE)(rc.x[:, :3]), rc.x[:, 3:]], -1), 1e-6)
    # the compute-dtype marker casts only the f32-encoded output
    amp = rf.materialize_code(rc._replace(cd=torch.bfloat16))
    assert amp.dtype == torch.bfloat16 and torch.equal(amp, out.bfloat16())


# ---------------------------------------------------------------------------
# the four wrappers with a RawCode against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _pair(d_in, d_latent, H, nb, combine_layer, seed=0):
    """JAX ResnetFC parameters drawn from numpy (fc_1 and biases live) and the
    port module (kernel route) holding the same weights."""
    jm = JResnetFC(d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H,
                   combine_layer=combine_layer)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((4, d_latent + d_in)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * (0.05 if p.ndim == 1 else 1.0 / np.sqrt(p.shape[0])))
        .astype(np.float32), params)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=d_latent, d_hidden=H,
                    combine_layer=combine_layer, impl="cuda")
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    return params, port


@pytest.mark.parametrize("NS", [1, 2])
@pytest.mark.parametrize("gather", [False, True])
def test_wrappers_with_raw_code_match_pallas_interpret(NS, gather):
    W, f, p, m = _code_arrays()
    d_in, C, H, nb, cl, B, T = W.shape[1], 32, 32, 3, 2, 64, 40
    params, port = _pair(d_in, C, H, nb, cl)
    rng = np.random.default_rng(NS * 10 + gather)
    raw = _raw(rng, NS * B)
    jrc = rp.RawCode(*(jnp.asarray(a) for a in (raw, W, f, p, m)))
    rc = rf.RawCode(*(torch.from_numpy(a) for a in (raw, W, f, p, m)))
    kw = dict(NS=NS, d_latent=C, d_in=d_in, n_blocks=nb, combine_layer=cl, planar_out=True,
              block_points=128, interpret=True)
    tower = port.tower(torch.device("cpu"))
    rf.reset_launches()
    if gather:
        tables = rng.normal(size=(T, C) if NS == 1 else (NS, T, C)).astype(np.float32)
        idx = rng.integers(0, T, size=(NS * B, 8)).astype(np.int32)
        w = rng.uniform(0, 1, size=(NS * B, 8)).astype(np.float32)
        w[:, 4:] = 0.0
        ref = rp.resnetfc_pallas(
            params, (rp.LatentGather(jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(w)), jrc),
            **kw)
        z = rf.LatentGather(*(torch.from_numpy(a) for a in (tables, idx, w)))
        if NS == 1:
            out = rf.resnetfc_gather(z.idx, z.w, z.table, rc, tower, nb)
        else:
            out = rf.resnetfc_gather_mv(z.idx, z.w, z.table, rc, tower, nb, cl)
    else:
        zn = rng.normal(size=(NS * B, C)).astype(np.float32)
        ref = rp.resnetfc_pallas(params, (jnp.asarray(zn), jrc), **kw)
        z = torch.from_numpy(zn)
        if NS == 1:
            out = rf.resnetfc_dense(z, rc, tower, nb)
        else:
            out = rf.resnetfc_dense_mv(z, rc, tower, nb, NS, cl)
    tol = 1e-4 * max(1.0, float(np.abs(np.asarray(ref)).max()))
    close(out, ref[0], tol)
    with torch.no_grad():  # the deferred inputs are eval-only
        close(port((z, rc), combine_inner_dims=(NS, B), planar_out=True), ref, tol, "module")
    # the plain version equals the tower fed the materialized code
    close(out, rf.resnetfc_reference(rf.materialize_gather(z) if gather else z,
                                     rf.materialize_code(rc), tower, nb, NS=NS,
                                     combine_layer=cl), 1e-6)
    assert not any(rf.LAUNCHES.values())  # CPU tensors: the plain versions


def test_raw_code_is_eval_only_on_the_kernel_route():
    """As in the JAX package, the deferred code has no backward: the kernel
    route raises under grad; the plain route materializes it differentiably."""
    W, f, p, m = _code_arrays()
    params, port = _pair(W.shape[1], 8, 16, 2, 1)
    rc = rf.RawCode(*(torch.from_numpy(a) for a in (_raw(np.random.default_rng(1), 12), W, f, p,
                                                      m)))
    z = torch.zeros(12, 8)
    with pytest.raises(RuntimeError, match="eval-only"):
        port((z, rc), combine_inner_dims=(1, 12))
    with torch.no_grad():
        want = port((z, rc), combine_inner_dims=(1, 12))
    port.impl = "torch"
    out = port((z, rc), combine_inner_dims=(1, 12))
    out.sum().backward()
    assert port.lin_in.weight.grad is not None and port.lin_in.weight.grad.abs().sum() > 0
    close(out, want, 1e-5)


# ---------------------------------------------------------------------------
# query with PIXELNERF_DEFER_CODE=1 against the JAX query
# ---------------------------------------------------------------------------

CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 6\n freq_factor = 1.5\n include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet\n n_blocks = 3\n d_hidden = 32\n combine_layer = 2 }
    mlp_fine { type = resnet\n n_blocks = 3\n d_hidden = 32\n combine_layer = 2 }
    encoder { backbone = resnet18\n pretrained = False\n num_layers = 2\n use_first_pool = False }
}
"""
IMG = 24


@pytest.fixture(scope="module")
def world():
    """Two source views of one object, query points, and JAX variables with
    live fc_1 and MLP biases."""
    s = SyntheticDataset(n_objs=1, n_views=2, image_size=IMG, seed=2)[0]
    rng = np.random.default_rng(9)
    B = 48
    xyz = (rng.normal(size=(1, B, 3)) * 0.5).astype(np.float32)
    vd = rng.normal(size=(1, B, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    conf = jhocon.parse_string(CONF)
    jnet = jmake_model(conf["model"], mlp_impl="xla")
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(s["images"][None, :1]),
                                   jnp.asarray(s["poses"][None, :1]), jnp.asarray(s["focal"]),
                                   jnp.asarray(xyz), jnp.asarray(vd))

    def bump(tree, path=()):
        if isinstance(tree, dict):
            return {k: bump(v, path + (k,)) for k, v in tree.items()}
        v = np.array(tree, np.float32)
        if ("fc_1" in path and path[-1] == "kernel") or (path[1].startswith("mlp") and
                                                          path[-1] == "bias"):
            v = rng.normal(size=v.shape).astype(np.float32) * 0.1
        return v

    return dict(images=s["images"], poses=s["poses"], focal=np.float32(s["focal"]), xyz=xyz,
                vd=vd, conf=conf, variables=bump(jax.tree.map(np.asarray, dict(variables))))


@pytest.mark.parametrize(
    "impl,jimpl,cap,NS,dtype",
    [
        ("torch", "xla", 2048, 1, "float32"),  # plain route: materialize_parts
        ("cuda", "pallas", 2048, 1, "float32"),  # fused gather + code (rows 1 + 6)
        ("cuda", "pallas", 0, 1, "float32"),  # dense + code (rows 2 + 6)
        ("cuda", "pallas", 2048, 2, "float32"),  # multi-view gather + code (rows 4 + 6)
        ("torch", "xla", 2048, 1, "bfloat16"),
        ("cuda", "pallas", 2048, 1, "bfloat16"),
    ],
)
def test_deferred_query_matches_jax(world, monkeypatch, impl, jimpl, cap, NS, dtype):
    monkeypatch.setenv("PIXELNERF_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PIXELNERF_FUSED_GATHER_MAX_ROWS", str(cap))
    monkeypatch.setenv("PIXELNERF_DEFER_CODE", "1")
    images, poses = world["images"][None, :NS], world["poses"][None, :NS]
    jnet = jmake_model(world["conf"]["model"], mlp_impl=jimpl)
    jscene = jnet.apply(world["variables"], jnp.asarray(images), jnp.asarray(poses),
                        jnp.asarray(world["focal"]), method=JPixelNeRFNet.encode)
    net = make_model(hocon.parse_string(CONF)["model"], mlp_impl=impl, device="cpu")
    net.load_state_dict(from_jax_variables(world["variables"]))
    scene = net.encode(torch.from_numpy(images), torch.from_numpy(poses), float(world["focal"]))
    seen = []
    net.mlp_coarse.register_forward_pre_hook(lambda m, args: seen.append(args[0][1]))
    tol = 2e-5 if dtype == "float32" else 2e-3
    rf.reset_launches()
    for coarse in (True, False):
        ref = jnet.apply(world["variables"], jscene, jnp.asarray(world["xyz"]),
                         viewdirs=jnp.asarray(world["vd"]), coarse=coarse, planar_out=True,
                         compute_dtype=getattr(jnp, dtype), method=JPixelNeRFNet.query)
        with torch.no_grad():  # an eval query: the deferred inputs are eval-only
            out = net.query(scene, torch.from_numpy(world["xyz"]), torch.from_numpy(world["vd"]),
                            coarse=coarse, planar_out=True,
                            compute_dtype=getattr(torch, dtype))
        close(out, ref, tol, f"coarse={coarse}")
    assert isinstance(seen[0], rf.RawCode) and seen[0].x.dtype == torch.float32
    assert seen[0].cd == getattr(torch, dtype) and seen[0].x.shape == (NS * 48, 6)
    assert not any(rf.LAUNCHES.values())  # CPU tensors never launch a kernel


@pytest.mark.parametrize("diff_mode", [False, True])
def test_diff_mode_keeps_the_code_dense(world, monkeypatch, diff_mode):
    """Training builds the model with ``diff_mode``: the field then gets the
    encoded code, not a RawCode, whatever PIXELNERF_DEFER_CODE says."""
    monkeypatch.setenv("PIXELNERF_DEFER_CODE", "1")
    net = make_model(hocon.parse_string(CONF)["model"], mlp_impl="cuda", device="cpu",
                     diff_mode=diff_mode)
    scene = net.encode(torch.from_numpy(world["images"][None, :1]),
                       torch.from_numpy(world["poses"][None, :1]), float(world["focal"]))
    seen = []
    net.mlp_coarse.register_forward_pre_hook(lambda m, args: seen.append(args[0][1]))
    with torch.set_grad_enabled(diff_mode):
        out = net.query(scene, torch.from_numpy(world["xyz"]), torch.from_numpy(world["vd"]))
    assert isinstance(seen[0], rf.RawCode) != diff_mode
    if diff_mode:
        assert seen[0].shape == (48, 42)
        out.sum().backward()  # the kernel route's autograd Function (plain on the CPU)
        assert net.mlp_coarse.lin_in.weight.grad is not None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["resnetfc_fwd_dense_code", "resnetfc_fwd_gather_code",
                                     "resnetfc_fwd_dense_mv_code", "resnetfc_fwd_gather_mv_code"])
def test_code_variant_matches_plain_on_card(cuda_device, variant):
    """sn64 widths, ragged B: each forward kernel's CODE variant on raw
    coordinates against its plain version (the code in f32, the tower in
    bf16), to the bar of tests/test_pallas.py, and within bf16 rounding of
    the same kernel fed the encoded code."""
    W, f, p, m = _code_arrays()
    NS = 1 if "_mv" not in variant else 2
    d_in, C, nb, cl, B, T = W.shape[1], 512, 5, 3, 700, 1024
    _, port = _pair(d_in, C, 512, nb, cl)
    tower = port.to(cuda_device).tower(cuda_device)
    rng = np.random.default_rng(3)
    rc = rf.RawCode(*(torch.from_numpy(a).to(cuda_device)
                      for a in (_raw(rng, NS * B), W, f, p, m)))
    tables = torch.from_numpy(rng.normal(size=(NS, T, C)).astype(np.float32)).to(cuda_device)
    tables = tables.bfloat16() if NS > 1 else tables[0].bfloat16()
    idx = torch.from_numpy(rng.integers(0, T, size=(NS * B, 8)).astype(np.int32)).to(cuda_device)
    w = torch.from_numpy(rng.uniform(0, 1, size=(NS * B, 8)).astype(np.float32)).to(cuda_device)
    z = rf.gather_reference(idx, w, tables, torch.bfloat16).bfloat16()
    kern = {
        "resnetfc_fwd_dense_code": lambda x: rf.resnetfc_dense(z, x, tower, nb),
        "resnetfc_fwd_gather_code": lambda x: rf.resnetfc_gather(idx, w, tables, x, tower, nb),
        "resnetfc_fwd_dense_mv_code": lambda x: rf.resnetfc_dense_mv(z, x, tower, nb, NS, cl),
        "resnetfc_fwd_gather_mv_code": lambda x: rf.resnetfc_gather_mv(idx, w, tables, x, tower,
                                                                       nb, cl),
    }[variant]
    before = rf.LAUNCHES[variant]
    out = kern(rc)
    torch.cuda.synchronize()
    assert rf.LAUNCHES[variant] == before + 1
    kw = dict(NS=NS, combine_layer=cl) if NS > 1 else {}
    ref = rf.resnetfc_reference(z, rc, tower, nb, compute_dtype=torch.bfloat16, **kw)
    d = (out - ref).abs().max().item()
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1].item()
    assert out.shape == (4, B) and d <= 0.015 * max(1.0, ref.abs().max().item()) and corr > 0.999
    enc = kern(rf.materialize_code(rc))
    assert (out - enc).abs().max().item() <= 0.015 * max(1.0, enc.abs().max().item())
