"""The PyTorch port's sample_pdf / sample_pdf_python against the JAX package
and the native C++ library, on the CPU: the same numpy inputs go through
all of them. Deterministic quantiles agree to 1e-5; random quantiles are
drawn from a torch.Generator, and the same draw fed to the native library
gives the same samples; support, shapes and the validation errors as in
the JAX package's tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu import native
from pytorch3d_pointops_tpu.ops.sample_pdf import sample_pdf as jax_sample_pdf
from pytorch3d_pointops_tpu.ops.sample_pdf import (
    sample_pdf_python as jax_sample_pdf_python,
)
import pytorch3d_pointops_tpu_torch as ppt
from pytorch3d_pointops_tpu_torch.ops.sample_pdf import _uniform_quantiles

torch.set_num_threads(2)
TOL = 1e-5


def _setup(seed, batch=(4,), n_bins=16, zero_bins=False):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(size=(*batch, n_bins + 1)), axis=-1).astype(np.float32)
    weights = rng.uniform(size=(*batch, n_bins)).astype(np.float32)
    if zero_bins:  # empty bins, and a distribution with no weight at all
        weights[..., ::3] = 0.0
        weights.reshape(-1, n_bins)[0] = 0.0
    return bins, weights


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("batch,n_bins,n_samples,zero_bins", [
    ((4,), 16, 32, False),
    ((8,), 64, 64, True),
    ((2, 3), 5, 10, False),
    ((3,), 1, 7, False),
])
def test_sample_pdf_det_matches_jax_and_native(batch, n_bins, n_samples, zero_bins):
    bins, weights = _setup(n_bins, batch, n_bins, zero_bins)
    out = ppt.sample_pdf(_t(bins), _t(weights), n_samples, det=True)
    ref = jax_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), n_samples, det=True)
    u = np.broadcast_to(np.linspace(0.0, 1.0, n_samples, dtype=np.float32),
                        (*batch, n_samples))
    nat = native.sample_pdf(bins, weights, np.ascontiguousarray(u))
    assert out.shape == (*batch, n_samples) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(out.numpy(), nat, atol=TOL)


@pytest.mark.parametrize("zero_bins", [False, True])
def test_sample_pdf_random_matches_native_on_the_same_draw(zero_bins):
    bins, weights = _setup(3, (6,), 12, zero_bins)
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    out = ppt.sample_pdf(_t(bins), _t(weights), 40, det=False, generator=gen)
    gen.set_state(state)
    u = _uniform_quantiles((6,), 40, False, gen, "cpu").numpy()
    assert ((u >= 0) & (u < 1)).all()
    np.testing.assert_allclose(out.numpy(), native.sample_pdf(bins, weights, u), atol=TOL)
    # The same generator state draws the same samples.
    gen.set_state(state)
    again = ppt.sample_pdf(_t(bins), _t(weights), 40, det=False, generator=gen)
    assert torch.equal(out, again)


def test_sample_pdf_python_matches_jax_and_sample_pdf():
    bins, weights = _setup(1, (8,), 64)
    a = ppt.sample_pdf(_t(bins), _t(weights), 64, det=True)
    b = ppt.sample_pdf_python(_t(bins), _t(weights), 64, det=True)
    ref = jax_sample_pdf_python(jnp.asarray(bins), jnp.asarray(weights), 64, det=True)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3)


def test_samples_within_support_and_no_gradient():
    bins, weights = _setup(2)
    tb = _t(bins).requires_grad_(True)
    tw = _t(weights).requires_grad_(True)
    gen = torch.Generator().manual_seed(3)
    for fn in (ppt.sample_pdf, ppt.sample_pdf_python):
        out = fn(tb, tw, 100, det=False, generator=gen)
        assert not out.requires_grad
        out = out.numpy()
        assert (out >= bins[:, :1] - 1e-6).all() and (out <= bins[:, -1:] + 1e-6).all()


def test_sample_distribution_follows_weights():
    bins = np.broadcast_to(np.linspace(0.0, 1.0, 5, dtype=np.float32), (1, 5))
    weights = np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)
    gen = torch.Generator().manual_seed(4)
    out = ppt.sample_pdf(_t(bins), _t(weights), 20000, det=False, generator=gen)
    hist, _ = np.histogram(out.numpy()[0], bins=np.linspace(0, 1, 5))
    np.testing.assert_allclose(hist / hist.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.02)


def test_batch_shapes_preserved():
    bins, weights = _setup(5, (6,))
    out = ppt.sample_pdf(_t(bins.reshape(2, 3, -1)), _t(weights.reshape(2, 3, -1)),
                         10, det=True)
    assert out.shape == (2, 3, 10)
    flat = ppt.sample_pdf(_t(bins), _t(weights), 10, det=True)
    np.testing.assert_allclose(out.reshape(6, 10).numpy(), flat.numpy(), atol=1e-6)


def test_validation_and_generator():
    bins, weights = _setup(6)
    for fn in (ppt.sample_pdf, ppt.sample_pdf_python):
        with pytest.raises(ValueError):
            fn(_t(bins), _t(weights[:, :-1]), 4, det=True)
        with pytest.raises(ValueError):
            fn(_t(bins), _t(weights), 4, det=False)  # no generator
