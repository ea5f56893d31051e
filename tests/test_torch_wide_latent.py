"""The dense forwards past a 512-wide latent and the route rule's width
envelope, on the CPU.

* ``resnetfc_dense`` / ``resnetfc_dense_mv`` (rows 2 and 3 of PERF.md, and
  row 6's deferred code) take a latent up to 4096 wide, injected in pieces
  of 512 columns (the global encoder's code before the pixel latent: 128 +
  512 = 640 at sn64; ResNet50's unified map, 832 / 1856 / 3904).  Their plain versions on CPU tensors are held against
  the JAX ``_kernel_2d`` / ``_kernel_2d_mv`` through ``resnetfc_pallas`` in
  interpret mode at C = 640, to 1e-4 of max(1, max|ref|) (f32 sums
  reassociated), as ``tests/test_torch_fwd_dense*.py`` hold them at 32;
  ``dense_steps`` and ``check_dense_widths`` count and refuse the pieces.
* ``ResnetFC._kernel_route`` sends a tower outside the kernels' envelope to
  the plain route under ``auto`` and raises under ``cuda``, reading only the
  Python mirrors of the kernels' limits (no library is built or loaded).
  Under grad the backward kernels take the forward's latent widths (16 to
  4096, a multiple of 16): the global encoder's 640, the ConvEncoder's 128,
  1040 and ResNet50's 1856 train on the kernels; 4112 and 24 stay plain, and
  so does 3904 at d_hidden 64 with a fourth injection and 47 blocks (the
  data kernel's program: 61 walk-back steps an injection).  The forward and the
  backward kernels take every multiple of 64 up to 512 but 448 (a library
  each of each) and any other width up to 512 zero-padded on the next one's:
  narrower towers render and train on them; 576 and 1024 render on the
  forward's 1024 library and train plain, 1040 and 2048 stay plain.  Under
  grad a tower trains on the kernels to the depth the card's gates hold
  (``GRAD_MAX_BLOCKS``, 32 blocks), inside the data kernel's program (512
  16-bit steps) and the weights kernel's plan; deeper ones, and a tower past
  the data kernel's program, keep the forward kernels and train plain.
* The steepened field of the eval CLIs' replay (its sigma row x 50, shifted
  to leave 1/32 of the points occupied) read past the per-kernel bar on the
  card: the JAX kernel's own bf16 arithmetic reads alike on it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.code import PositionalEncoding as JPositionalEncoding
from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops import resnetfc_pallas as rp
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables

PE = dict(num_freqs=6, d_in=3, freq_factor=1.5, include_input=True)  # sn64's code
WIDE = 640  # the global encoder's code (128) before sn64's pixel latent (512)


def _setup(rows, H, nb, cl, seed=0, C=WIDE):
    """JAX ResnetFC parameters drawn from numpy (every parameter live), the
    port module holding them, the sn64 code's raw coordinates and flat
    arrays, the encoded code and a C-wide latent."""
    W, f, p, m = JPositionalEncoding(**PE).flat_arrays(tail=3)
    d_in = W.shape[1]
    jm = JResnetFC(d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=cl)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, C + d_in)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * (0.05 if a.ndim == 1 else 1.0 / np.sqrt(a.shape[0])))
        .astype(np.float32), params)
    port = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=cl,
                    impl="cuda")
    sd = from_jax_variables({"params": {"mlp_coarse": params}})
    port.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()})
    xyz = rng.uniform(-1.4, 1.4, size=(rows, 3))
    vd = rng.normal(size=(rows, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    raw = np.concatenate([xyz, vd], axis=-1).astype(np.float32)
    enc = (raw.astype(np.float64) @ W).astype(np.float32)
    enc = np.where(m > 0, np.sin(enc * f + p), enc).astype(np.float32)
    z = rng.normal(size=(rows, C)).astype(np.float32)
    return params, port, raw, (W, f, p, m), enc, z


def _x(raw_code, raw, code, enc):
    if raw_code:
        return (rp.RawCode(*(jnp.asarray(a) for a in (raw,) + code)),
                rf.RawCode(*(torch.from_numpy(a) for a in (raw,) + code)))
    return jnp.asarray(enc), torch.from_numpy(enc)


def _close(out, ref):
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("B,raw_code,planar", [(2000, False, True), (2000, True, False),
                                               (160, False, False), (160, True, True)])
def test_dense_plain_at_a_640_wide_latent_matches_pallas_interpret(B, raw_code, planar):
    """resnetfc_dense's plain version at C = 640 (two pieces: 512 and 128
    columns) against ``_kernel_2d`` in interpret mode, at a ragged last tile."""
    H, nb = 64, 3
    params, port, raw, code, enc, z = _setup(B, H, nb, nb, seed=B + raw_code)
    jx, x = _x(raw_code, raw, code, enc)
    ref = rp.resnetfc_pallas(params, (jnp.asarray(z), jx), NS=1, d_latent=WIDE, d_in=enc.shape[1],
                             n_blocks=nb, combine_layer=nb, block_points=512, interpret=True,
                             planar_out=planar)
    ref = np.asarray(ref)[0]
    rf.reset_launches()
    out = rf.resnetfc_dense(torch.from_numpy(z), x, port.tower(torch.device("cpu")), nb, planar)
    assert not any(rf.LAUNCHES.values())
    assert tuple(out.shape) == ref.shape == ((4, B) if planar else (B, 4))
    _close(out, ref)


@pytest.mark.parametrize("NS,sb,B_obj,raw_code,planar", [
    (2, 1, 100, False, True),
    (3, 2, 333, True, False),
    (2, 2, 333, True, True),
    (3, 1, 100, False, False),
])
def test_dense_mv_plain_at_a_640_wide_latent_matches_pallas_interpret(NS, sb, B_obj, raw_code,
                                                                      planar):
    """resnetfc_dense_mv's plain version at C = 640 against
    ``_kernel_2d_mv`` in interpret mode, tiles straddling objects."""
    H, nb, cl = 64, 4, 2
    rows = sb * NS * B_obj
    params, port, raw, code, enc, z = _setup(rows, H, nb, cl, seed=rows + raw_code)
    jx, x = _x(raw_code, raw, code, enc)
    ref = rp.resnetfc_pallas(params, (jnp.asarray(z), jx), NS=NS, d_latent=WIDE,
                             d_in=enc.shape[1], n_blocks=nb, combine_layer=cl, sb=sb,
                             block_points=128, interpret=True, planar_out=planar)
    ref = np.asarray(ref)[0]
    out = rf.resnetfc_dense_mv(torch.from_numpy(z), x, port.tower(torch.device("cpu")), nb, NS, cl,
                               sb, planar)
    B = sb * B_obj
    assert tuple(out.shape) == ref.shape == ((4, B) if planar else (B, 4))
    _close(out, ref)


def test_dense_steps_and_widths_count_the_latent_pieces():
    """An injection of a latent past 512 columns is a step of the stored
    program a piece of 512 columns: sn64 (5 blocks, 3 injections) is 14
    steps at C = 512, 17 at 640 and at 1024, 23 at ResNet50's 1856 and 35 at
    its 3904, and 18 from NS = 2 up at 640; ``check_dense_widths`` takes C
    to 4096 and refuses 4112, and the gathers build the same pieces to 4096."""
    lim = rf.TILE_LIMITS[512]
    assert ([rf.latent_pieces(c) for c in (16, 512, 528, 640, 1024, 832, 1856, 3904, 4096)]
            == [1, 1, 2, 2, 2, 2, 4, 8, 8])
    assert rf.dense_steps(5, 3, C=512) == rf.dense_steps(5, 3) == 14
    assert rf.dense_steps(5, 3, C=640) == rf.dense_steps(5, 3, C=1024) == 17
    assert rf.dense_steps(5, 3, C=1856) == 23 and rf.dense_steps(5, 3, C=3904) == 35
    assert rf.dense_steps(5, 3, 3, 3, C=640) == rf.dense_steps(5, 3, 255, 3, C=640) == 18
    for C in (640, 1024, 832, 1856, 3904, 4096):
        rf.check_dense_widths(48, 512, C, 3, 5, 4, lim)
        rf._check_gather_width(C, lim)
    for C, what in ((4112, "C"), (648, "C")):
        with pytest.raises(ValueError, match=what):
            rf.check_dense_widths(48, 512, C, 3, 5, 4, lim)
    with pytest.raises(ValueError, match="kin"):  # the code stays one operand tile
        rf.check_dense_widths(528, 512, 640, 3, 5, 4, lim)
    with pytest.raises(ValueError, match="steps"):  # 2 pieces a block: 63 blocks overflow
        rf.check_dense_widths(48, 512, 640, 42, 42, 4, lim)
    for C in (4112, 516):  # past the widest table; a row not of whole 16-byte chunks
        with pytest.raises(ValueError, match="gather"):
            rf._check_gather_width(C, lim)
    rf._check_gather_width(512, lim)


def _tower(**kw):
    args = dict(d_in=42, d_out=4, n_blocks=5, d_latent=512, d_hidden=512, combine_layer=3,
                impl="auto")
    args.update(kw)
    with torch.device("meta"):
        return ResnetFC(**args)


CUDA = torch.device("cuda")  # only compared by type: nothing is allocated on it


@pytest.mark.parametrize("kw,NS,grad", [
    (dict(d_hidden=1040), 1, False),  # past the widest library, 1024
    (dict(d_hidden=2048), 3, False),  # past it too
    (dict(d_hidden=576), 1, True),  # past the widest backward library (512), under grad
    (dict(d_hidden=1024), 3, True),
    (dict(d_in=520), 1, True),  # kin 528 > 512: past the operand tile, forward and backward
    # the data kernel's program: 516 steps of 512 at d_hidden 64, four
    # 4096-wide injections and 45 blocks
    (dict(d_latent=4096, d_hidden=64, combine_layer=4, n_blocks=45), 1, True),
    (dict(n_blocks=33), 1, True),  # past the depth the card's gates hold (32 blocks)
    (dict(n_blocks=61), 3, True),  # inside the forward's programs, past the gates
    (dict(d_latent=4112), 1, True),  # past the kernels' 4096, under grad
    (dict(d_latent=4112), 3, True),
    (dict(d_latent=24), 1, True),  # not a multiple of 16
    (dict(d_latent=4112), 1, False),  # past the forward's 4096
    # ResNet50's 3904 at d_hidden 64 with a fourth injection: 61 walk-back
    # steps each, the data kernel's program 514 steps of 512 at 47 blocks
    (dict(d_latent=3904, d_hidden=64, combine_layer=4, n_blocks=47), 1, True),
])
def test_route_sends_towers_outside_the_envelope_to_the_plain_route(kw, NS, grad):
    """Under ``auto`` on a CUDA device a tower the kernels do not take is
    routed plain -- decided from the Python mirrors, with no library built
    (none can be here) -- and under ``cuda`` it raises."""
    assert not rf._LIBS and not rf.dense_limits.cache_info().currsize
    t = _tower(**kw)
    assert t._kernel_route((NS, 64), CUDA, grad) is False
    t.impl = "cuda"
    with pytest.raises(ValueError):
        t._kernel_route((NS, 64), CUDA, grad)
    assert t._kernel_route((NS, 64), torch.device("cpu"), grad) is True  # plain versions
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("kw,NS,grad", [
    ({}, 1, True),  # sn64: forward and backward kernels
    ({}, 3, True),
    (dict(d_latent=WIDE), 1, False),  # the global encoder's eval: the widened forward
    (dict(d_latent=WIDE), 3, False),
    (dict(d_latent=1024, n_blocks=3, combine_layer=2), 2, False),
    (dict(d_latent=128), 1, False),  # the ConvEncoder's eval
    (dict(d_latent=WIDE), 1, True),  # the global encoder's train step: the backward in pieces
    (dict(d_latent=WIDE), 3, True),
    (dict(d_latent=128), 1, True),  # the ConvEncoder's train step
    (dict(d_latent=1024), 1, True),
    (dict(d_latent=1040), 1, True),  # past 1024 since ResNet50's widths: 3 pieces
    (dict(d_latent=1040), 3, True),
    (dict(d_latent=1040), 1, False),
    (dict(d_latent=1856), 1, True),  # ResNet50's 4 layers, 4 pieces each way
    (dict(d_latent=1856), 3, True),
    (dict(d_latent=3904), 2, False),  # its 5 layers, 8 pieces
    (dict(d_latent=3904, d_hidden=64), 1, True),  # 61 dz steps an injection: 235 steps
    (dict(d_latent=4096, d_hidden=64), 3, True),
    (dict(d_hidden=128), 1, False),  # the narrow towers' forward: a library each
    (dict(d_hidden=256), 3, False),
    (dict(d_hidden=128), 2, False),
    (dict(d_hidden=256), 1, False),
    (dict(d_hidden=256), 1, True),  # the narrow towers' train steps: a backward library each
    (dict(d_hidden=256), 3, True),
    (dict(d_hidden=128), 1, True),
    (dict(d_hidden=128), 3, True),
    (dict(d_hidden=128, d_latent=WIDE), 1, True),  # 640 at 128: 2 pieces, 5 dz steps a way
    (dict(d_hidden=64), 1, False),  # d_hidden 64's forward: its own library
    (dict(d_hidden=64), 3, False),
    (dict(d_hidden=64), 1, True),  # and its backward, 8 dz steps an injection
    (dict(d_hidden=64), 3, True),
    (dict(d_hidden=384), 1, False),  # d_hidden 384's forward: three 64-column pieces
    (dict(d_hidden=384), 3, False),
    (dict(d_hidden=384), 1, True),  # and its backward, 2 dz steps an injection
    (dict(d_hidden=384), 3, True),
    (dict(d_hidden=192), 1, False),  # d_hidden 192 / 320: a library each
    (dict(d_hidden=320), 3, False),
    (dict(d_hidden=448), 1, True),  # zero-padded onto the 512 library
    (dict(d_hidden=192), 3, True),
    (dict(d_hidden=200), 1, True),  # zero-padded onto the 256 library
    (dict(d_hidden=100), 3, True),
    (dict(n_blocks=6), 1, True),  # past 5 blocks: the weights kernel's table in device memory
    (dict(n_blocks=6, d_hidden=192), 3, True),  # the deepest tower the card's gates
    (dict(n_blocks=6, d_hidden=200), 1, True),  # hold, at other widths
    (dict(n_blocks=6), 3, True),
])
def test_route_takes_the_kernels_inside_the_envelope(kw, NS, grad):
    """Decided from the Python mirrors as well: no library built or loaded."""
    t = _tower(**kw)
    assert t._kernel_route((NS, 64), CUDA, grad) is True
    assert t._kernel_route((NS, 64), torch.device("cpu"), grad) is False  # auto on the CPU
    assert not rf._LIBS and not rv._LIBS


@pytest.mark.parametrize("option,want", [("global", True), ("conv", True), ("narrow", True),
                                         ("narrow128", True), ("narrow64", True),
                                         ("narrow192", True), ("narrow384", True),
                                         ("narrow576", False), ("narrow200", True)])
def test_option_train_steps_take_the_backward_kernels(monkeypatch, option, want):
    """sn64's conf with the global encoder (C = 640) or the ConvEncoder (C =
    128), built in code as ``chip_smoke.py``'s ``option_confs`` builds it,
    or with both heads at d_hidden 256, 128, 64, 192, 384 or 200 (zero-padded
    onto the 256 library; ``narrow_conf``): under ``auto`` with card
    parameters ``field_backward_in_kernel`` holds at -V 1 and -V 3, so the
    trainer's remat default, which follows it and not the conf, is off; a
    d_hidden 576 tower, past the widest library, stays plain.  The card is
    faked: the
    rule reads only the parameters' device, and no library is built or
    loaded."""
    from types import SimpleNamespace

    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.models import make_model

    conf = entry.load_conf(pretrained=False)
    if option == "global":
        conf.put("model.use_global_encoder", True)
        conf.put("model.global_encoder.pretrained", False)
    elif option == "conv":
        conf.put("model.encoder.type", "conv")
    else:
        for head in ("mlp_coarse", "mlp_fine"):
            conf.put(f"model.{head}.d_hidden", int(option[6:] or 256))
    net = make_model(conf["model"], mlp_impl="auto", device="cpu", diff_mode=True)
    assert net.mlp_fine.d_latent == {"global": WIDE, "conv": 128}.get(option, 512)
    assert not net.field_backward_in_kernel(1)  # auto on CPU parameters: the plain field
    monkeypatch.setattr(net, "parameters", lambda: iter([SimpleNamespace(device=CUDA)]))
    assert [net.field_backward_in_kernel(nv) for nv in (1, 3)] == [want, want]
    assert not rf._LIBS and not rv._LIBS


def test_mirrored_limits_are_the_kernels_limits_by_hand():
    """The mirrors the route reads, by hand from the sources' constants: the
    64-point tile, 256 threads, 3 ring stages of 32 KB, 4 outputs, 128
    stored steps, a 512-wide code, a 4096-wide latent in the dense kernels
    and in the gathers' tables, two 64 KB operand tiles (the data kernel:
    512 16-bit steps, the same 4096-wide latent and 512-wide code, 64
    blocks: a step's k); the
    weights kernel's 128 x 256 tile, 24 splits, 256 tensor maps and 128
    products (every tower the forward's 128 steps take, in a table in device
    memory).  The narrower libraries keep the operand tiles, the code's
    and the latent's widths and the 96 KB ring (6 stages of 16 KB at
    d_hidden 128 and 384, where a warpgroup's piece is one 64-column box; 12
    of 8 KB at 64, where it is one 64 x 32 box; 4 of 24 KB at 192,
    where it is a warpgroup's whole half in three such boxes; 4 of 20 KB at
    320, where it is half a warpgroup's half in five 64 x 16 boxes), and a
    view-sum slot of the H-wide stream (H / 4 f32 a thread), the data
    kernel's as the forward's: 32768 / 24576 / 20480 / 16384 / 12288 /
    8192 / 4096 f32 at 512 / 384 / 320 / 256 / 192 / 128 / 64; the weights
    kernel's tile is 128 x min(256, H), 128 x 192 at 384, 128 x 160 at
    320.  Any other width (448 too) reads the next library's, and past 512
    none.  ``chip_smoke.py`` holds them
    equal to what the libraries report."""
    assert rf.TILE_LIMITS == {
        64: rf.DenseLimits(64, 256, 12, 4, 128, 512, 4096, 230400, 448, 4096, 64, 4096),
        128: rf.DenseLimits(64, 256, 6, 4, 128, 512, 8192, 230400, 448, 4096, 128, 4096),
        192: rf.DenseLimits(64, 256, 4, 4, 128, 512, 12288, 230400, 448, 4096, 192, 4096),
        256: rf.DenseLimits(64, 256, 3, 4, 128, 512, 16384, 230400, 448, 4096, 256, 4096),
        320: rf.DenseLimits(64, 256, 4, 4, 128, 512, 20480, 214016, 448, 4096, 320, 4096),
        384: rf.DenseLimits(64, 256, 6, 4, 128, 512, 24576, 230400, 448, 4096, 384, 4096),
        512: rf.DenseLimits(64, 256, 3, 4, 128, 512, 32768, 230400, 448, 4096, 512, 4096),
        # a cluster of two CTAs, each owning 512 columns: the 512 layout
        # (pieces of 64), a 128 KB block operand and a 32 KB ring of 2 stages
        1024: rf.DenseLimits(64, 256, 2, 4, 128, 512, 32768, 230400, 448, 4096, 1024, 4096,
                             cluster=2),
    }
    assert tuple(rf.TILE_LIMITS) == rf.FWD_HIDDEN
    assert rv.DATA_LIMITS == {
        64: rv.DataLimits(64, 256, 4096, 12, 4, 512, 4096, 230400, 64, 512, 64),
        128: rv.DataLimits(64, 256, 8192, 6, 4, 512, 4096, 230400, 128, 512, 64),
        192: rv.DataLimits(64, 256, 12288, 4, 4, 512, 4096, 230400, 192, 512, 64),
        256: rv.DataLimits(64, 256, 16384, 3, 4, 512, 4096, 230400, 256, 512, 64),
        320: rv.DataLimits(64, 256, 20480, 4, 4, 512, 4096, 214016, 320, 512, 64),
        384: rv.DataLimits(64, 256, 24576, 6, 4, 512, 4096, 230400, 384, 512, 64),
        512: rv.DataLimits(64, 256, 32768, 3, 4, 512, 4096, 230400, 512, 512, 64),
    }
    assert rv.WEIGHT_LIMITS == {64: rv.KernelLimits(128, 64, 24, 256, 128),
                                128: rv.KernelLimits(128, 128, 24, 256, 128),
                                192: rv.KernelLimits(128, 192, 24, 256, 128),
                                256: rv.KernelLimits(128, 256, 24, 256, 128),
                                320: rv.KernelLimits(128, 160, 24, 256, 128),
                                384: rv.KernelLimits(128, 192, 24, 256, 128),
                                512: rv.KernelLimits(128, 256, 24, 256, 128)}
    assert tuple(rv.DATA_LIMITS) == tuple(rv.WEIGHT_LIMITS) == rf.BWD_HIDDEN
    for H, lim in rf.TILE_LIMITS.items():
        assert lim.smem <= rf.MAX_SMEM_BYTES and lim.hidden == H
        assert rf.tile_limits(H) is lim
    for H in rf.BWD_HIDDEN:
        lim, dlim = rf.TILE_LIMITS[H], rv.DATA_LIMITS[H]
        assert dlim.max_c == lim.max_c == lim.max_gather_c and dlim.hidden == H
        assert dlim.smem <= rf.MAX_SMEM_BYTES
        assert dlim.slot_floats == dlim.threads * H // 4  # a thread's share of the 64 x H stream
        # a ring of the stages that 96 KB holds: 32 KB (two warpgroups x two or
        # one 8 KB box), 16 KB (x one 8 KB box), 8 KB or 24 KB (x one or three
        # 64 x 32 boxes of 4 KB), 20 KB (x five 64 x 16 boxes of 2 KB)
        stage = {128: 2 * 8192, 384: 2 * 8192, 256: 4 * 8192, 512: 4 * 8192, 192: 6 * 4096,
                 320: 10 * 2048}.get(H, 2 * 4096)
        assert rf.ring_stage_bytes(H) == stage
        assert dlim.stages * stage <= 3 * 32768 < (dlim.stages + 1) * stage
        assert dlim.smem == lim.smem == 2 * 65536 + dlim.stages * stage + 1024
    for H, L in ((1, 64), (100, 128), (200, 256), (448, 512), (500, 512), (576, 1024),
                 (1024, 1024)):  # zero-padded
        assert rf.library_width(H) == L and rf.tile_limits(H) is rf.TILE_LIMITS[L]
    for H in (1025, 2048, 0):
        with pytest.raises(ValueError, match="d_hidden"):
            rf.tile_limits(H)


# ----------------------------------------------------------------------------
# the steepened field
# ----------------------------------------------------------------------------


class _Ref:
    """An array standing in for a Pallas ref, so that the kernel body runs
    as plain JAX ops with its TPU compute dtype."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a = v


def _kernel_2d_bf16(p, z, x):
    """JAX's ``_kernel_2d`` body on its TPU arithmetic (``interpret=False``:
    bf16 operands, f32 products and stream) over all points at once."""
    bf, H, d_in = jnp.bfloat16, 512, x.shape[1]
    n_lin_z = sum(k.startswith("lin_z_") for k in p)
    n_blocks = sum(k.startswith("blocks_") for k in p)
    d = jnp.zeros((1, 128))
    out = _Ref(None)
    rp._kernel_2d(
        _Ref(jnp.asarray(z, bf)),
        _Ref(jnp.zeros((x.shape[0], 128), bf).at[:, :d_in].set(jnp.asarray(x, bf))),
        _Ref(jnp.zeros((128, H), bf).at[:d_in].set(jnp.asarray(p["lin_in"]["kernel"], bf))),
        _Ref(jnp.asarray(p["lin_in"]["bias"])[None]),
        _Ref(jnp.stack([p[f"lin_z_{k}"]["kernel"] for k in range(n_lin_z)]).astype(bf)),
        _Ref(jnp.stack([p[f"lin_z_{k}"]["bias"][None] for k in range(n_lin_z)])),
        _Ref(jnp.stack([jnp.stack([p[f"blocks_{k}"][f]["kernel"] for f in ("fc_0", "fc_1")])
                        for k in range(n_blocks)]).astype(bf)),
        _Ref(jnp.stack([jnp.stack([p[f"blocks_{k}"][f]["bias"][None] for f in ("fc_0", "fc_1")])
                        for k in range(n_blocks)])),
        _Ref(jnp.zeros((H, 8), bf).at[:, :4].set(jnp.asarray(p["lin_out"]["kernel"], bf))),
        _Ref(jnp.zeros((1, 8)).at[0, :4].set(p["lin_out"]["bias"])),
        d, d, d, d, out, d_latent=z.shape[1], n_blocks=n_blocks, combine_layer=n_lin_z,
        planar_out=False, fused_code=False, interpret=False)
    return np.asarray(out.a, np.float64)[:, :4]


def test_steepened_field_reads_alike_in_the_reference():
    """A field like the eval CLIs' replayed one: the sn64 render model
    (seeded, every block live, random ResNet34 encoder) on 256 ring rays x
    64 samples, its sigma row scaled x 50, shifted so that 1/32 of the
    points are occupied; held at the per-kernel bar (|d| <= 0.015 max(1,
    max|ref|)) in calls of 64 points, where the bar's range is smallest.
    The JAX ``_kernel_2d`` in interpret mode computes in f32 and reads
    nothing of the bar: it cannot show bf16 rounding.  Its body on its TPU
    arithmetic (bf16 operands, f32 products) reads past the bar against the
    f32 XLA tower (1.51; 1.31 unsteepened) and 0.65 of it against the
    port's bf16 plain version (0.91 unsteepened), where the card's kernel
    read 1.06-1.26 on the CLI's field.  So the reference's own kernel reads
    a like share: the bar is the field's and the call's to pass."""
    from pixelnerf_tpu_torch import entry

    conf = entry.load_conf(pretrained=False)
    net = entry.build_model(conf, "cpu", mlp_impl="torch", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for blk in net.mlp_fine.blocks:
            blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
    src = entry.source_view(64, 0)
    rays = torch.from_numpy(np.asarray(entry.ring_rays(src, 1)).reshape(-1, 8)[::16][:256])
    seen = {}
    mlp = net.mlp_fine
    forward = mlp.forward

    def spy(zx, *args, **kwargs):
        seen["zx"] = zx
        return forward(zx, *args, **kwargs)

    with torch.no_grad():
        scene = net.encode(torch.as_tensor(src["images"]), torch.as_tensor(src["poses"]),
                           float(src["focal"]))
        t = torch.linspace(0.0, 1.0, 64)
        depth = rays[:, 6:7] + (rays[:, 7:8] - rays[:, 6:7]) * t
        pts = (rays[:, None, :3] + depth[..., None] * rays[:, None, 3:6]).reshape(1, -1, 3)
        dirs = rays[:, None, 3:6].expand(-1, 64, -1).reshape(1, -1, 3)
        mlp.forward = spy
        net.query(scene, pts, dirs, coarse=False)
        mlp.forward = forward
    z, x = (a.numpy() for a in seen["zx"])
    sd = {k: v.numpy() for k, v in mlp.state_dict().items()}
    p = {"lin_in": {"kernel": sd["lin_in.weight"].T, "bias": sd["lin_in.bias"]},
         "lin_out": {"kernel": sd["lin_out.weight"].T.copy(), "bias": sd["lin_out.bias"].copy()}}
    for k in range(3):
        p[f"lin_z_{k}"] = {"kernel": sd[f"lin_z.{k}.weight"].T, "bias": sd[f"lin_z.{k}.bias"]}
    for k in range(5):
        p[f"blocks_{k}"] = {f: {"kernel": sd[f"blocks.{k}.{f}.weight"].T,
                                "bias": sd[f"blocks.{k}.{f}.bias"]} for f in ("fc_0", "fc_1")}

    def f32_tower():
        h = x @ p["lin_in"]["kernel"] + p["lin_in"]["bias"]
        for k in range(5):
            if k < 3:
                h = h + (z @ p[f"lin_z_{k}"]["kernel"] + p[f"lin_z_{k}"]["bias"])
            s = np.maximum(h, 0) @ p[f"blocks_{k}"]["fc_0"]["kernel"] + p[f"blocks_{k}"]["fc_0"]["bias"]
            h = h + (np.maximum(s, 0) @ p[f"blocks_{k}"]["fc_1"]["kernel"]
                     + p[f"blocks_{k}"]["fc_1"]["bias"])
        return (np.maximum(h, 0) @ p["lin_out"]["kernel"] + p["lin_out"]["bias"]).astype(np.float64)

    def worst(out, ref, n=64):
        return max(np.abs(out[i:i + n] - ref[i:i + n]).max()
                   / (0.015 * max(1.0, np.abs(ref[i:i + n]).max())) for i in range(0, len(ref), n))

    reads = {}
    for scale in (1.0, 50.0):
        p["lin_out"]["kernel"][:, 3] = sd["lin_out.weight"][3] * scale
        p["lin_out"]["bias"][3] = sd["lin_out.bias"][3] * scale
        p["lin_out"]["bias"][3] -= np.quantile(f32_tower()[:, 3], 1 - 1 / 32)
        ref = f32_tower()
        assert np.isclose((ref[:, 3] > 0).mean(), 1 / 32, atol=1e-3)
        tw = rf.pack_tower({k: torch.from_numpy(v) for k, v in sd.items()}, x.shape[1], 512, 5, 3,
                           "cpu")
        tw = tw._replace(w_out=torch.from_numpy(p["lin_out"]["kernel"].copy()),
                         b_out=torch.from_numpy(p["lin_out"]["bias"].copy()))
        plain = rf.resnetfc_reference(torch.from_numpy(z), torch.from_numpy(x), tw, 5, False,
                                      compute_dtype=torch.bfloat16).double().numpy()
        interp = np.asarray(rp.resnetfc_pallas(
            jax.tree.map(jnp.asarray, p), (jnp.asarray(z), jnp.asarray(x)), NS=1, d_latent=512,
            d_in=x.shape[1], n_blocks=5, combine_layer=3, block_points=512, interpret=True))[0]
        tpu = _kernel_2d_bf16(p, z, x)
        reads[scale] = (worst(interp, ref), worst(tpu, ref), worst(tpu, plain))
    (i1, f1, b1), (i50, f50, b50) = reads[1.0], reads[50.0]
    assert i1 < 1e-3 and i50 < 1e-3  # interpret mode: f32 throughout
    assert f50 > 1.0  # the reference's bf16 kernel itself past the bar on the steep field
    assert b1 <= 1.0 and b50 <= 1.0  # and within it against the port's bf16 plain version
