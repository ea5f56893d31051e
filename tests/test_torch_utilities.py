"""The port's utilities against the JAX package, on the CPU: the geometry
helpers (``utils/geometry.py``), depth-based warping (``utils/warping.py``),
``TrainingMonitor`` (``train/monitor.py``) and ``DiagnosticTool``
(``train/diagnostic.py``).

Inputs are seeded numpy.  Tolerances: the geometry helpers 1e-6 of
max(1, max|ref|); the warp 1e-5; the monitor's stats and text exactly
(the clock pinned); the diagnostic's verdicts, counts and lines exactly and
its printed rgb / sigma ranges within 1e-4 (one unit of the 4 printed
decimals).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.config import hocon as jhocon
from pixelnerf_tpu.data import SyntheticDataset as JSyntheticDataset
from pixelnerf_tpu.models import make_model as jmake_model
from pixelnerf_tpu.train import diagnostic as jdiagnostic
from pixelnerf_tpu.train import monitor as jmonitor
from pixelnerf_tpu.utils import geometry as jgeo
from pixelnerf_tpu.utils import warping as jwarp
from pixelnerf_tpu_torch.config import hocon
from pixelnerf_tpu_torch.data import SyntheticDataset
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.train import diagnostic, monitor
from pixelnerf_tpu_torch.utils import geometry as geo
from pixelnerf_tpu_torch.utils import warping
from pixelnerf_tpu_torch.utils.jax_convert import from_jax_variables


def close(port, ref, tol):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    err = np.abs(port.astype(np.float64) - ref).max() if ref.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0), err


def t(x):
    return torch.from_numpy(np.asarray(x))


def _poses(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return np.stack([geo.pose_spherical(a, e, r) for a, e, r in zip(
        rng.uniform(0, 360, n), rng.uniform(-40, 10, n), rng.uniform(1.0, 1.6, n))]).astype(
        np.float32)


def _forward_facing(seed=0, n=3):
    """Poses looking down -z from near the origin (NDC's setting)."""
    rng = np.random.default_rng(seed)
    P = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    P[:, :3, 3] = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    return P


def _geometry_case(name):
    """(port result, JAX result) of one helper on seeded inputs."""
    rng = np.random.default_rng(1)
    poses = _poses()
    if name == "unproj_map":
        return geo.unproj_map(9, 7, 6.5), jgeo.unproj_map(9, 7, 6.5)
    if name == "unproj_map_c":
        return (geo.unproj_map(9, 7, t(np.float32([6.5, 7.25])), c=[4.2, 3.1]),
                jgeo.unproj_map(9, 7, np.float32([6.5, 7.25]), c=[4.2, 3.1]))
    if name == "gen_rays":
        return (geo.gen_rays(t(poses), 10, 8, 9.0, 0.8, 1.8, c=[4.7, 3.9]),
                jgeo.gen_rays(poses, 10, 8, 9.0, 0.8, 1.8, c=[4.7, 3.9]))
    if name == "gen_rays_np":  # the device twin against the host-side numpy twin
        return (geo.gen_rays(t(poses), 10, 8, [9.0, 8.5], 0.8, 1.8),
                geo.gen_rays_np(poses, 10, 8, [9.0, 8.5], 0.8, 1.8))
    if name == "gen_rays_ndc":
        P = _forward_facing()
        with pytest.warns(UserWarning, match="NDC"):
            port = geo.gen_rays(t(P), 10, 8, [9.0, 8.5], 0.8, 1.8, ndc=True)
        with pytest.warns(UserWarning, match="NDC"):
            ref = jgeo.gen_rays(P, 10, 8, [9.0, 8.5], 0.8, 1.8, ndc=True)
        return port, ref
    if name == "ndc_rays":
        o = rng.uniform(-0.3, 0.3, (5, 3)).astype(np.float32)
        d = rng.normal(size=(5, 3)).astype(np.float32)
        d[:, 2] = -np.abs(d[:, 2]) - 0.5
        port = geo.ndc_rays(12, 10, np.float32(11.0), 1.0, t(o), t(d))
        ref = jgeo.ndc_rays(12, 10, np.float32(11.0), 1.0, jnp.asarray(o), jnp.asarray(d))
        return torch.stack(port), np.stack([np.asarray(r) for r in ref])
    if name == "batched_index_select_nd":
        x = rng.normal(size=(3, 6, 4, 2)).astype(np.float32)
        i = rng.integers(0, 6, (3, 5))
        return (geo.batched_index_select_nd(t(x), t(i)),
                jgeo.batched_index_select_nd(jnp.asarray(x), jnp.asarray(i)))
    if name == "batched_index_select_nd_last":
        x = rng.normal(size=(3, 4, 7)).astype(np.float32)
        i = rng.integers(0, 7, (3, 5))
        return (geo.batched_index_select_nd_last(t(x), t(i)),
                jgeo.batched_index_select_nd_last(jnp.asarray(x), jnp.asarray(i)))
    if name == "masked_sample_np":
        m = (rng.uniform(size=(3, 8, 9, 1)) > 0.6).astype(np.float32)
        return (geo.masked_sample_np(m, 50, 0.7, np.random.default_rng(5)),
                jgeo.masked_sample_np(m, 50, 0.7, np.random.default_rng(5)))
    if name == "look_at":
        o, tg = np.float32([1.2, 0.4, -0.9]), np.float32([0.1, -0.2, 0.05])
        return geo.look_at(o, tg), jgeo.look_at(o, tg)
    if name == "rot_to_quat":
        R = poses[:, :3, :3]
        port = geo.rot_to_quat(t(R))
        # quat_to_rot inverts it (the DTU spline path's pair)
        close(geo.quat_to_rot(port.numpy()), R, 1e-5)
        return port, jgeo.rot_to_quat(R)
    if name == "homogeneous":
        p = rng.normal(size=(2, 5, 3)).astype(np.float32)
        return geo.homogeneous(t(p)), jgeo.homogeneous(jnp.asarray(p))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "unproj_map", "unproj_map_c", "gen_rays", "gen_rays_np", "gen_rays_ndc", "ndc_rays",
    "batched_index_select_nd", "batched_index_select_nd_last", "masked_sample_np", "look_at",
    "rot_to_quat", "homogeneous"])
def test_geometry_helpers_match_jax(name):
    port, ref = _geometry_case(name)
    close(port, ref, 1e-6)


def test_gen_rays_keeps_the_poses_device_and_dtype():
    """A double-precision pose tensor comes back as f32 rays on its device."""
    poses = t(_poses()).double()
    rays = geo.gen_rays(poses, 6, 5, 5.0, 0.5, 2.0)
    assert rays.dtype == torch.float32 and rays.device == poses.device
    assert rays.shape == (3, 5, 6, 8)


# ---------------------------------------------------------------------------
# warping
# ---------------------------------------------------------------------------


def _warp_inputs(seed=0, B=2, H=12, W=16, C=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (B, H, W, C)).astype(np.float32)
    depth = rng.uniform(1.5, 3.0, (B, H, W)).astype(np.float32)
    K = np.tile(np.float32([[18.0, 0, 7.5], [0, 17.0, 5.5], [0, 0, 1]]), (B, 1, 1))
    K[1, 0, 2] += 0.7
    # a turn and a shift large enough that a band of pixels leaves the frame
    pose = np.stack([geo.rot_theta(np.deg2rad(a)) @ geo.rot_phi(np.deg2rad(e))
                     for a, e in ((9.0, -4.0), (-12.0, 6.0))]).astype(np.float32)
    pose[:, :3, 3] = np.float32([[0.35, -0.1, 0.2], [-0.3, 0.25, -0.15]])
    target_K = K.copy()
    target_K[:, 0, 0] *= 1.1
    return img, depth, K, pose, target_K


@pytest.mark.parametrize("depth_4d", [False, True])
@pytest.mark.parametrize("own_target_K", [False, True])
def test_warp_image_matches_jax(depth_4d, own_target_K):
    """A non-identity pose: part of the frame warps outside, so the zero
    padding and ``valid`` matter; the occlusion mask and the reprojection
    error (masked and not) on its output."""
    img, depth, K, pose, target_K = _warp_inputs()
    d = depth[..., None] if depth_4d else depth
    tk = target_K if own_target_K else None
    warped, valid = warping.warp_image(t(img), t(d), t(K), t(pose),
                                       None if tk is None else t(tk))
    jwarped, jvalid = jwarp.warp_image(jnp.asarray(img), jnp.asarray(d), jnp.asarray(K),
                                       jnp.asarray(pose), None if tk is None else jnp.asarray(tk))
    close(warped, jwarped, 1e-5)
    close(valid, jvalid, 0)
    assert 0.2 < float(valid.mean()) < 0.95  # the frame's edge is crossed
    # a pixel that lands over a pixel outside the frame samples zeros
    assert bool((warped.abs().sum(-1) == 0).any())
    # the occlusion mask of the warped depth, the reprojection error
    dw = depth * np.float32(1.0 + 0.02 * np.random.default_rng(2).standard_normal(depth.shape))
    close(warping.compute_occlusion_mask(t(depth), t(dw)),
          jwarp.compute_occlusion_mask(jnp.asarray(depth), jnp.asarray(dw)), 0)
    close(warping.compute_occlusion_mask(t(depth), t(dw), threshold=0.03),
          jwarp.compute_occlusion_mask(jnp.asarray(depth), jnp.asarray(dw), threshold=0.03), 0)
    for mask in (valid, None):
        err = warping.compute_reprojection_error(t(img), warped, mask)
        jerr = jwarp.compute_reprojection_error(jnp.asarray(img), jwarped,
                                                None if mask is None else jvalid)
        close(err, jerr, 1e-6)


def test_warp_identity_and_samplers_match_jax():
    """The identity warp gives the image back, every pixel valid (a plane
    depth and intrinsics exact in binary, so that the frame's edge does not
    round outside); ``bilinear_sampler`` and ``generate_depth_map`` against
    JAX; an all-invalid mask divides by 1."""
    img = _warp_inputs(seed=3)[0]
    depth = np.full(img.shape[:3], 2.0, np.float32)
    K = np.tile(np.float32([[16.0, 0, 8.0], [0, 16.0, 6.0], [0, 0, 1]]), (2, 1, 1))
    eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    warped, valid = warping.warp_image(t(img), t(depth), t(K), t(eye))
    close(warped, img, 1e-5)
    assert float(valid.mean()) == 1.0
    coords = np.random.default_rng(4).uniform(-1.3, 1.3, (2, 40, 2)).astype(np.float32)
    close(warping.bilinear_sampler(t(img), t(coords)),
          jwarp.bilinear_sampler(jnp.asarray(img), jnp.asarray(coords)), 1e-6)
    close(warping.generate_depth_map(2.5, 5, 7, batch=3), jwarp.generate_depth_map(2.5, 5, 7, 3), 0)
    zero = np.zeros((2, 12, 16, 1), np.float32)
    close(warping.compute_reprojection_error(t(img), warped, t(zero)),
          jwarp.compute_reprojection_error(jnp.asarray(img), jnp.asarray(warped.numpy()),
                                           jnp.asarray(zero)), 0)


@pytest.mark.parametrize("n_views,n_sample,exclude", [(10, 3, (0, 1)), (5, 9, ()), (6, 4, (5,))])
def test_sample_random_views_matches_jax(n_views, n_sample, exclude):
    """The same ``default_rng`` gives the same indices."""
    for seed in range(3):
        got = warping.sample_random_views(n_views, n_sample, np.random.default_rng(seed), exclude)
        want = jwarp.sample_random_views(n_views, n_sample, np.random.default_rng(seed), exclude)
        np.testing.assert_array_equal(got, want)
        assert not set(got.tolist()) & set(exclude)


# ---------------------------------------------------------------------------
# TrainingMonitor
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def time(self):
        self.now += 7.5
        return self.now


def _monitored(mod, monkeypatch, psnr0, slope, n=30, window=8):
    monkeypatch.setattr(mod, "time", _Clock())
    mon = mod.TrainingMonitor(window_size=window)
    for i in range(n):
        mon.update(1.0 / (i + 2), psnr0 + slope * i + 0.3 * np.sin(i))
    return mon


@pytest.mark.parametrize("psnr0", [6.0, 12.0, 20.0, 27.0, 33.0])
def test_monitor_matches_jax(monkeypatch, capsys, psnr0):
    """Each quality band: the same stats, the same printed report and
    advisory, the same convergence verdict and text at two thresholds."""
    port = _monitored(monitor, monkeypatch, psnr0, 0.02)
    ref = _monitored(jmonitor, monkeypatch, psnr0, 0.02)
    assert port.get_stats() == ref.get_stats()
    capsys.readouterr()
    port.print_stats(1, 17, 300)
    got = capsys.readouterr().out
    ref.print_stats(1, 17, 300)
    assert got == capsys.readouterr().out
    assert "PSNR:" in got
    for patience, threshold in ((5, 1.0), (5, 0.01), (20, 1.0)):
        verdict = port.check_convergence(patience, threshold)
        got = capsys.readouterr().out
        assert verdict == ref.check_convergence(patience, threshold)
        assert got == capsys.readouterr().out


def test_monitor_growth_and_empty_stats_match_jax(capsys):
    """Past its first buffer (1024 values) the history grows; before any
    update the stats are empty and nothing prints."""
    port, ref = monitor.TrainingMonitor(), jmonitor.TrainingMonitor()
    assert port.get_stats() == ref.get_stats() == {}
    port.print_stats(0, 0, 10)
    assert capsys.readouterr().out == ""
    for i in range(2100):
        for m in (port, ref):
            m.update(1.0 / (i + 1), 20.0 + 0.001 * i)
    assert port.get_stats() == ref.get_stats()
    assert port.check_convergence(900, 0.5) == ref.check_convergence(900, 0.5)


# ---------------------------------------------------------------------------
# DiagnosticTool
# ---------------------------------------------------------------------------

DIAG_CONF = ("model { use_encoder = True\n use_xyz = True\n use_viewdirs = False\n"
             " use_code = False\n"
             " mlp_coarse { type = resnet\n n_blocks = 2\n d_hidden = 16 }\n"
             " mlp_fine { type = empty }\n"
             " encoder { backbone = resnet18\n pretrained = False\n num_layers = 1 } }")


@pytest.fixture(scope="module")
def diag_world():
    """The 2-block d_hidden 16 model of tests/test_misc.py in both packages,
    one set of weights."""
    ds = JSyntheticDataset(n_objs=1, n_views=2, image_size=16)
    s = ds[0]
    jnet = jmake_model(jhocon.parse_string(DIAG_CONF)["model"], mlp_impl="xla")
    variables = jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(s["images"][None, :1]),
        jnp.asarray(s["poses"][None, :1]), jnp.asarray(np.float32(s["focal"])),
        jnp.zeros((1, 4, 3), jnp.float32), None)
    variables = jax.tree.map(np.asarray, dict(variables))
    net = make_model(hocon.parse_string(DIAG_CONF)["model"], device="cpu")
    net.load_state_dict(from_jax_variables(variables))
    return dict(jnet=jnet, variables=variables, net=net, sample=s)


def _run(capsys, fn, *args):
    capsys.readouterr()
    verdict = fn(*args)
    return verdict, capsys.readouterr().out


class _ListDataset(list):
    pass


@pytest.mark.parametrize("kind", ["synthetic", "unit_range", "nan"])
def test_diagnostic_data_range_matches_jax(tmp_path, capsys, kind):
    """The same verdict and the same report: the synthetic set passes,
    [0, 1] images and a NaN fail."""
    if kind == "synthetic":
        ds, jds = SyntheticDataset(n_objs=2, n_views=2, image_size=16), \
            JSyntheticDataset(n_objs=2, n_views=2, image_size=16)
    else:
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        if kind == "nan":
            img = img * 2 - 1
            poses[0, 0, 3] = np.nan
        ds = jds = _ListDataset([{"images": img, "poses": poses, "path": "x"}])
    tool = diagnostic.DiagnosticTool(save_dir=str(tmp_path / "p"))
    jtool = jdiagnostic.DiagnosticTool(save_dir=str(tmp_path / "j"))
    ok, out = _run(capsys, tool.check_data_range, ds, 2)
    jok, jout = _run(capsys, jtool.check_data_range, jds, 2)
    assert ok == jok == (kind == "synthetic")
    assert out == jout


def test_diagnostic_model_checks_match_jax(tmp_path, capsys, diag_world):
    """``check_model_architecture``: the same verdict and lines, parameters
    and batch statistics counted alike (the port leaves out BatchNorm's step
    counters); ``check_model_output``: the same verdict and the printed
    rgb / sigma ranges within 1e-4."""
    w = diag_world
    tool = diagnostic.DiagnosticTool(save_dir=str(tmp_path / "p"))
    jtool = jdiagnostic.DiagnosticTool(save_dir=str(tmp_path / "j"))
    ok, out = _run(capsys, tool.check_model_architecture, w["net"])
    jok, jout = _run(capsys, jtool.check_model_architecture, w["jnet"], w["variables"])
    assert ok and jok
    assert out == jout
    counts = re.search(r"Parameters: ([\d,]+) \(\+ ([\d,]+) batch stats\)", out).groups()
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(w["variables"]["params"]))
    n_stats = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(w["variables"]["batch_stats"]))
    assert [int(c.replace(",", "")) for c in counts] == [n_params, n_stats] and n_stats > 0

    ok, out = _run(capsys, tool.check_model_output, w["net"], w["sample"])
    jok, jout = _run(capsys, jtool.check_model_output, w["jnet"], w["variables"], w["sample"])
    assert ok and jok

    def ranges(text):
        return [float(x) for x in re.findall(r"range \[(-?[\d.]+), (-?[\d.]+)\]", text)
                for x in x]

    assert len(ranges(out)) == 4
    np.testing.assert_allclose(ranges(out), ranges(jout), rtol=0, atol=1e-4 + 1e-9)
    assert [ln for ln in out.splitlines() if "range" not in ln] == \
        [ln for ln in jout.splitlines() if "range" not in ln]


def test_diagnostic_flags_a_latent_width_mismatch(tmp_path, capsys, diag_world):
    """A field whose latent width is not the encoder's fails the check, as
    the JAX check fails it."""
    net = make_model(hocon.parse_string(DIAG_CONF)["model"], device="cpu")
    net.latent_size = net.latent_size + 1
    ok, out = _run(capsys, diagnostic.DiagnosticTool(str(tmp_path / "p")).check_model_architecture,
                   net)
    assert not ok and "latent size mismatch" in out
