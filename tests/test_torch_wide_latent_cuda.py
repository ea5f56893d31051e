"""On the card only (``cuda``-marked; skipped without one): the dense
forwards at a 640-wide latent against their plain versions, and the Python
mirrors of the kernels' limits that the route rule reads against what the
libraries report.  No JAX here: this file runs where the card is.
``chip_smoke.py`` makes the same checks at sn64's full widths."""

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
def test_mirrored_limits_are_the_libraries(cuda_device):
    assert rf.dense_limits() == rf.TILE_LIMITS
    assert rv.data_limits() == rv.DATA_LIMITS
    assert rv.kernel_limits() == rv.WEIGHT_LIMITS


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
