"""The PyTorch port's masked_gather, wmean and get_point_covariances against
the JAX package, on the CPU: the same numpy inputs go through both; values
and gradients agree to 1e-5, and masked_gather's backward is bit-equal from
run to run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu.ops.utils import get_point_covariances as jax_cov
from pytorch3d_pointops_tpu.ops.utils import masked_gather as jax_masked_gather
from pytorch3d_pointops_tpu.ops.utils import wmean as jax_wmean
import pytorch3d_pointops_tpu_torch as ppt

torch.set_num_threads(2)
TOL = 1e-5


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


@pytest.mark.parametrize("idx_shape", [(2, 7), (2, 5, 4)])
def test_masked_gather_matches_jax(idx_shape):
    rng = np.random.default_rng(len(idx_shape))
    pts = rng.normal(size=(2, 12, 3)).astype(np.float32)
    idx = rng.integers(-1, 12, size=idx_shape)
    w = rng.normal(size=(*idx_shape, 3)).astype(np.float32)
    jidx = jnp.asarray(idx.astype(np.int32))
    ref = jax_masked_gather(jnp.asarray(pts), jidx)
    gref = jax.grad(lambda p: jnp.sum(w * jax_masked_gather(p, jidx)))(jnp.asarray(pts))
    tp = _t(pts, requires_grad=True)
    out = ppt.masked_gather(tp, _t(idx))
    (out * _t(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    assert (out.detach().numpy()[idx == -1] == 0).all()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gref), rtol=TOL, atol=TOL)


def test_masked_gather_backward_is_bit_equal_run_to_run():
    """Many entries land on the same rows; two backwards give the same bits
    (the deterministic segment-sum, not float atomics)."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(2, 6, 4)).astype(np.float32)
    idx = _t(rng.integers(-1, 6, size=(2, 50, 8)))
    w = _t(rng.normal(size=(2, 50, 8, 4)).astype(np.float32))
    grads = []
    for _ in range(2):
        tp = _t(pts, requires_grad=True)
        (ppt.masked_gather(tp, idx) * w).sum().backward()
        grads.append(tp.grad)
    assert torch.equal(grads[0], grads[1])


def test_masked_gather_backward_skips_padded_slots(monkeypatch):
    """A query whose slots are all -1 beside a real neighbour at row 0: the
    gradient is jax.grad's, and the backward scatter skips the padded slots
    (index -1) instead of summing their zeros into row 0."""
    from pytorch3d_pointops_tpu_torch.kernels import scatter as ks

    rng = np.random.default_rng(6)
    pts = rng.normal(size=(2, 5, 3)).astype(np.float32)
    idx = np.array([[[-1, -1, -1, -1], [0, 3, -1, -1], [0, 0, 4, -1]],
                    [[-1, -1, -1, -1], [-1, -1, -1, -1], [2, 0, -1, -1]]])
    w = rng.normal(size=(2, 3, 4, 3)).astype(np.float32)
    jidx = jnp.asarray(idx.astype(np.int32))
    gref = jax.grad(lambda p: jnp.sum(w * jax_masked_gather(p, jidx)))(jnp.asarray(pts))
    seen = []

    def spy(i, c, P2):
        seen.append(i.clone())
        return ks.scatter_add_plain(i, c, P2)

    monkeypatch.setattr(ks, "scatter_add_rows", spy)
    tp = _t(pts, requires_grad=True)
    (ppt.masked_gather(tp, _t(idx)) * _t(w)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gref), rtol=TOL, atol=TOL)
    (scattered,) = seen
    assert torch.equal(scattered, _t(idx).reshape(2, -1))
    assert int((scattered == 0).sum()) == 4  # the real row-0 neighbours only


def test_masked_gather_errors():
    pts = torch.zeros((2, 5, 3))
    with pytest.raises(ValueError):
        ppt.masked_gather(pts, torch.zeros((3, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        ppt.masked_gather(pts, torch.zeros((2,), dtype=torch.int64))


@pytest.mark.parametrize("axis,keepdims", [(-2, True), (1, False), ((0, 1), True)])
def test_wmean_matches_jax(axis, keepdims):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 8, 2)).astype(np.float32)
    w = rng.uniform(size=(3, 8)).astype(np.float32)
    w[1] = 0.0  # the eps clamp
    for weight in (None, w):
        ref = jax_wmean(jnp.asarray(x), None if weight is None else jnp.asarray(weight),
                        axis=axis, keepdims=keepdims)
        out = ppt.wmean(_t(x), None if weight is None else _t(weight),
                        axis=axis, keepdims=keepdims)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_wmean_rejects_incompatible_weights():
    with pytest.raises(ValueError):
        ppt.wmean(torch.zeros((3, 8, 2)), torch.ones((3, 7)))


def test_get_point_covariances_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(2, 30, 3)).astype(np.float32)
    lengths = np.array([30, 17])
    cov_ref, knn_ref = jax_cov(jnp.asarray(pts), jnp.asarray(lengths), 6)
    cov, knn = ppt.get_point_covariances(_t(pts), _t(lengths), 6)
    assert cov.shape == (2, 30, 3, 3) and knn.shape == (2, 30, 6, 3)
    np.testing.assert_allclose(knn.numpy(), np.asarray(knn_ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cov.numpy(), np.asarray(cov_ref), rtol=TOL, atol=TOL)
