"""On the card only (``cuda``-marked; skipped without one): the dense
forwards at a 640-wide latent, the backward kernels (rows 5a / 5b) at
latent widths 128, 640 and 1024, and the four forward kernels with their
CODE twins (rows 1-4, 6) at d_hidden 64, 128 and 256, and 1024 and 640
(the 1024 library's cluster of two CTAs) against their plain versions,
and the Python mirrors of the kernels' limits that the route rule
reads against what each library reports.  No JAX here: this file runs where
the card is.  ``chip_smoke.py`` makes the same checks at sn64's full
widths."""

import pytest
import torch

from pixelnerf_tpu_torch.models.code import PositionalEncoding
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from pixelnerf_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H", rf.BWD_HIDDEN)
def test_mirrored_limits_are_the_libraries(cuda_device, H):
    """Each width's libraries (d_hidden 64's 12-stage ring of 8 KB, 64 x 32
    weight boxes, included) report the limits the route rule mirrors: a
    latent to 4096 columns in the dense kernels, the gathers' tables and the
    data kernel."""
    assert rf.dense_limits(H) == rf.TILE_LIMITS[H]
    assert rf.dense_limits(H).max_c == rf.dense_limits(H).max_gather_c == 4096
    assert rv.data_limits(H).max_c == 4096
    assert rv.data_limits(H) == rv.DATA_LIMITS[H]
    assert rv.kernel_limits(H) == rv.WEIGHT_LIMITS[H]


@pytest.mark.cuda
def test_1024_library_reports_its_mirror(cuda_device):
    """The forward's d_hidden 1024 library (a 64-point tile on a cluster of
    two CTAs) reports the limits the route rule mirrors."""
    assert rf.dense_limits(1024) == rf.TILE_LIMITS[1024]
    assert rf.dense_limits(1024).cluster == 2


@pytest.mark.cuda
@pytest.mark.parametrize("raw_code", [False, True])
@pytest.mark.parametrize("NS,sb,B_obj", [(1, 1, 2000), (1, 1, 160), (3, 2, 333), (2, 1, 1000)])
def test_wide_latent_kernels_match_plain_on_card(cuda_device, NS, sb, B_obj, raw_code):
    """sn64's tower at C = 640 (the global encoder's 128 before the pixel
    latent's 512): the dense kernel (NS 1) or the multi-view one against its
    plain version in bf16 at the bar of tests/test_pallas.py, one launch,
    bit-identical on a second call."""
    g = torch.Generator().manual_seed(NS * 1000 + B_obj)
    W, f, p, m = PositionalEncoding(num_freqs=6, d_in=3, freq_factor=1.5,
                                    include_input=True).flat_arrays(tail=3)
    port = ResnetFC(d_in=W.shape[1], d_out=4, n_blocks=5, d_latent=640, d_hidden=512,
                    combine_layer=3, impl="cuda")
    with torch.no_grad():
        for name, prm in port.named_parameters():
            std = 0.05 if name.endswith("bias") else prm.shape[1] ** -0.5
            prm.copy_(torch.randn(prm.shape, generator=g) * std)
    port = port.to(cuda_device)
    tw = port.tower(cuda_device)
    rows = NS * sb * B_obj
    raw = torch.cat([torch.rand(rows, 3, generator=g) * 2.8 - 1.4,
                     torch.nn.functional.normalize(torch.randn(rows, 3, generator=g), dim=-1)],
                    -1).to(cuda_device)
    code = rf.RawCode(raw, *(torch.from_numpy(a).to(cuda_device) for a in (W, f, p, m)))
    x = code if raw_code else rf.materialize_code(code._replace(cd=torch.float32)).contiguous()
    z = (torch.randn(rows, 640, generator=g) * 0.5).to(cuda_device).bfloat16()

    def run():
        if NS == 1:
            return rf.resnetfc_dense(z, x, tw, 5, True)
        return rf.resnetfc_dense_mv(z, x, tw, 5, NS, 3, sb, True)

    name = ("resnetfc_fwd_dense" if NS == 1 else "resnetfc_fwd_dense_mv") + (
        "_code" if raw_code else "")
    before = rf.LAUNCHES[name]
    out = run()
    torch.cuda.synchronize()
    assert rf.LAUNCHES[name] == before + 1
    ref = rf.resnetfc_reference(z, x, tw, 5, True, compute_dtype=torch.bfloat16, NS=NS, sb=sb,
                                combine_layer=3)
    assert (out - ref).abs().max().item() <= 0.015 * max(1.0, ref.abs().max().item())
    assert torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1] > 0.999
    assert torch.equal(out, run())


def _agree(out, ref):
    """The bar of tests/test_pallas.py: max|d| <= 0.015 max(1, max|ref|), corr > 0.999."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max().item() <= 0.015 * max(1.0, ref.abs().max().item())
            and torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1].item() > 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 640, 1024])
@pytest.mark.parametrize("NS,sb,B_obj", [(1, 2, 1000), (3, 2, 333)])
def test_backward_kernels_at_other_latent_widths_match_plain_on_card(cuda_device, C, NS, sb,
                                                                    B_obj):
    """sn64's tower at C = 128 (the ConvEncoder), 640 (the global encoder) and
    1024, B_pad an odd multiple of 32 (the last 64-point tile half full):
    the data kernel's stashed operands against the plain recompute (relu-mask
    flips <= 1e-3), every gradient against the plain backward walked through
    those operands, the weights kernel against ``bwd_weights_reference`` on
    its own DataOut, at the bar of tests/test_pallas.py; a launch each, and
    bit-identical second calls."""
    g = torch.Generator().manual_seed(C + NS)
    d_in = 42
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=5, d_latent=C, d_hidden=512, combine_layer=3,
                    impl="cuda")
    with torch.no_grad():
        for name, prm in port.named_parameters():
            std = 0.05 if name.endswith("bias") else prm.shape[1] ** -0.5
            prm.copy_(torch.randn(prm.shape, generator=g) * std)
    tw = port.to(cuda_device).tower(cuda_device)
    rows, B = NS * sb * B_obj, sb * B_obj
    x = torch.randn(rows, d_in, generator=g).to(cuda_device)
    z = (torch.randn(rows, C, generator=g) * 0.5).to(cuda_device).bfloat16()
    cot = torch.randn(4, B, generator=g).to(cuda_device)
    kw = dict(NS=NS, sb=sb, combine_layer=3) if NS > 1 else {}
    rv.reset_launches()
    data = rv.bwd_data(cot, z, x, tw, 5, True, **kw)
    gr = rv.bwd_weights(z, data, tw, 5)
    torch.cuda.synchronize()
    assert rv.LAUNCHES == {"resnetfc_bwd_data": 1, "resnetfc_bwd_weights": 1}
    assert data.dz.shape == (NS * -(-B // 32) * 32, C)
    ops_k = data.ws_act[:, :B].float()
    ops_p = rv.forward_operands(z, x, tw, 5, torch.bfloat16, **kw)
    assert ((ops_k > 0) != (ops_p > 0)).float().mean().item() <= 1e-3
    assert _agree(ops_k, ops_p)
    ref = rv.resnetfc_bwd_reference(cot, z, x, tw, 5, True, torch.bfloat16, operands=ops_k, **kw)
    wref = rv.bwd_weights_reference(z, data, tw, 5)
    for name in rv.Grads._fields:
        assert _agree(getattr(gr, name), getattr(ref, name)), name
        if name not in ("dz", "dx"):
            assert _agree(getattr(gr, name), getattr(wref, name)), name
    again = rv.bwd_weights(z, rv.bwd_data(cot, z, x, tw, 5, True, **kw), tw, 5)
    assert all(torch.equal(getattr(gr, n), getattr(again, n)) for n in rv.Grads._fields)


@pytest.mark.cuda
@pytest.mark.parametrize("raw_code", [False, True])
@pytest.mark.parametrize("kind", ["dense", "gather"])
@pytest.mark.parametrize("NS,sb,B_obj", [(1, 1, 2000), (1, 1, 160), (3, 2, 333), (2, 1, 1000)])
@pytest.mark.parametrize("H", [64, 128, 256, 1024, 640])
def test_narrow_forward_kernels_match_plain_on_card(cuda_device, H, NS, sb, B_obj, kind,
                                                    raw_code):
    """sn64's other widths at d_hidden 64, 128 and 256, and 1024 and 640
    (zero-padded onto the 1024 library; C = 512 one piece, 5 blocks, the
    views' mean at block 3): the dense kernel or the fused gather
    (NS 1), the multi-view dense kernel or gather (the gather at SB 1), each
    encoded and as its CODE twin, against its plain version in bf16 at the
    bar of tests/test_pallas.py, one launch of the width's library,
    bit-identical on a second call."""
    if kind == "gather" and sb > 1:
        pytest.skip("the multi-view gather takes one object")
    g = torch.Generator().manual_seed(H + NS * 1000 + B_obj)
    W, f, p, m = PositionalEncoding(num_freqs=6, d_in=3, freq_factor=1.5,
                                    include_input=True).flat_arrays(tail=3)
    port = ResnetFC(d_in=W.shape[1], d_out=4, n_blocks=5, d_latent=512, d_hidden=H,
                    combine_layer=3, impl="cuda")
    with torch.no_grad():
        for name, prm in port.named_parameters():
            std = 0.05 if name.endswith("bias") else prm.shape[1] ** -0.5
            prm.copy_(torch.randn(prm.shape, generator=g) * std)
    tw = port.to(cuda_device).tower(cuda_device)
    rows, T = NS * sb * B_obj, 1024
    raw = torch.cat([torch.rand(rows, 3, generator=g) * 2.8 - 1.4,
                     torch.nn.functional.normalize(torch.randn(rows, 3, generator=g), dim=-1)],
                    -1).to(cuda_device)
    code = rf.RawCode(raw, *(torch.from_numpy(a).to(cuda_device) for a in (W, f, p, m)))
    x = code if raw_code else rf.materialize_code(code._replace(cd=torch.float32)).contiguous()
    tables = (torch.randn(NS, T, 512, generator=g) * 0.5).to(cuda_device).bfloat16()
    idx = torch.randint(-1, T + 1, (rows, 8), generator=g).int().to(cuda_device)
    w = torch.rand(rows, 8, generator=g).to(cuda_device)
    w[:, 4:] = 0.0
    if kind == "dense":
        z = (torch.randn(rows, 512, generator=g) * 0.5).to(cuda_device).bfloat16()
    else:
        z = rf.gather_reference(idx, w, tables if NS > 1 else tables[0], torch.bfloat16)

    def run():
        if kind == "dense":
            if NS == 1:
                return rf.resnetfc_dense(z, x, tw, 5, True)
            return rf.resnetfc_dense_mv(z, x, tw, 5, NS, 3, sb, True)
        if NS == 1:
            return rf.resnetfc_gather(idx, w, tables[0].contiguous(), x, tw, 5, True)
        return rf.resnetfc_gather_mv(idx, w, tables, x, tw, 5, 3, True)

    name = f"resnetfc_fwd_{kind}{'_mv' if NS > 1 else ''}{'_code' if raw_code else ''}"
    before = rf.LAUNCHES[name]
    out = run()
    torch.cuda.synchronize()
    assert rf.LAUNCHES[name] == before + 1
    ref = rf.resnetfc_reference(z, x, tw, 5, True, compute_dtype=torch.bfloat16, NS=NS, sb=sb,
                                combine_layer=3)
    assert _agree(out, ref)
    assert torch.equal(out, run())
