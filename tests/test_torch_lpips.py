"""The port's VGG16-LPIPS (``pixelnerf_tpu_torch/eval/lpips.py``) against the
JAX package's ``pixelnerf_tpu.eval.lpips.LPIPS`` on the weights that
``load_torch_lpips`` reads from the same seeded file in the ``lpips``
package's layout, at full VGG16 widths on 2 x 32 x 32 images, on the CPU.

Tolerance: the distances within 1e-5 relative (both float32; the JAX
convolutions at ``precision="highest"``; only the summation order of the
convolutions differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.eval import lpips as jlpips
from pixelnerf_tpu_torch.eval import lpips as L


def _images(seed=0, shape=(2, 32, 32, 3)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.2, shape), -1, 1).astype(np.float32)
    return x, y


def _jax_lpips(path, x, y):
    variables = jlpips.load_torch_lpips(str(path))
    with jax.default_matmul_precision("highest"):
        return np.asarray(jlpips.LPIPS().apply(variables, jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("features_keys", [False, True], ids=["slice_lin", "features_lins"])
def test_lpips_matches_jax(tmp_path, features_keys):
    """``net.slice{k}.{idx}`` + ``lin{i}.model.1`` keys, and torchvision's
    ``features.{idx}`` + ``lins.{i}.model.1``: the same distances as JAX."""
    path = tmp_path / "vgg.pth"
    torch.save(L.seeded_state(7, features_keys=features_keys), path)
    x, y = _images()
    want = _jax_lpips(path, x, y)
    got = L.lpips_fn(str(path), device="cpu")(x, y)
    assert got.shape == want.shape == (2,) and got.dtype == np.float32
    assert (want > 1e-3).all()  # distances well above the rounding
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.all(L.lpips_fn(str(path), device="cpu")(x, x) == 0)


def test_lpips_needs_weights(tmp_path, monkeypatch):
    """No argument and no ``LPIPS_WEIGHTS`` (or a path that does not exist):
    ``FileNotFoundError``, as the JAX function; ``LPIPS_WEIGHTS`` is read
    when no path is given; a state dict missing a weight is refused."""
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    for path in (None, str(tmp_path / "missing.pth")):
        with pytest.raises(FileNotFoundError, match="LPIPS_WEIGHTS"):
            L.lpips_fn(path, device="cpu")
    path = tmp_path / "vgg.pth"
    torch.save(L.seeded_state(3), path)
    monkeypatch.setenv("LPIPS_WEIGHTS", str(path))
    assert L.lpips_fn(device="cpu") is L.lpips_fn(str(path), device="cpu")
    partial = {k: v for k, v in L.seeded_state(3).items() if not k.startswith("lin4")}
    with pytest.raises(RuntimeError, match="lins.4.weight"):
        L.load_lpips_state(L.LPIPS(), partial)


def test_lpips_cache_is_keyed_by_path(tmp_path, monkeypatch):
    """The port's cache holds one model a weights file: a second file gives
    its own distances.  The JAX ``lpips_fn`` returns the first weights it
    loaded for any later path (its module cache ignores the path), the
    reference gap of ROADMAP.md section 3."""
    a, b = tmp_path / "a.pth", tmp_path / "b.pth"
    torch.save(L.seeded_state(1), a)
    torch.save(L.seeded_state(2), b)
    x, y = _images(1)
    fa, fb = L.lpips_fn(str(a), device="cpu"), L.lpips_fn(str(b), device="cpu")
    assert fa is not fb and fa is L.lpips_fn(str(tmp_path / "." / "a.pth"), device="cpu")
    np.testing.assert_allclose(fa(x, y), _jax_lpips(a, x, y), rtol=1e-5, atol=0)
    np.testing.assert_allclose(fb(x, y), _jax_lpips(b, x, y), rtol=1e-5, atol=0)
    assert np.abs(fa(x, y) - fb(x, y)).min() > 1e-4
    monkeypatch.setattr(jlpips, "_cached", None)
    assert jlpips.lpips_fn(str(a)) is jlpips.lpips_fn(str(b))  # the reference's gap
