"""The PyTorch port's packed_to_padded / padded_to_packed against the JAX
package and the native C++ library, on the CPU: the same numpy inputs go
through all three. Values and both gradients must be exactly equal (both
directions are gathers), over flat, 2-D and N-D inputs, ``max_size_dim``,
empty clouds and the ``ValueError``s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu import native
from pytorch3d_pointops_tpu.ops.packed_padded import packed_to_padded as jax_p2p
from pytorch3d_pointops_tpu.ops.packed_padded import padded_to_packed as jax_pd2pk
import pytorch3d_pointops_tpu_torch as ppt

torch.set_num_threads(2)

# (cloud sizes, trailing shape of a packed row): flat, 2-D and N-D inputs;
# empty clouds first, in the middle and last.
_CASES = [
    ((3, 5, 2), ()),
    ((3, 5, 2), (4,)),
    ((4, 6), (2, 3)),
    ((0, 3, 0, 5), (3,)),
    ((2, 0), ()),
    ((1,), (1,)),
]


def _setup(seed, sizes, trail):
    rng = np.random.default_rng(seed)
    F = sum(sizes)
    inputs = rng.normal(size=(F, *trail)).astype(np.float32)
    first = np.zeros(len(sizes), np.int64)
    first[1:] = np.cumsum(sizes[:-1])
    return inputs, first, max(max(sizes), 1), F


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_packed_to_padded_and_gradient_match_jax_and_native(case):
    sizes, trail = _CASES[case]
    inputs, first, max_size, F = _setup(case, sizes, trail)
    w = np.random.default_rng(100 + case).normal(
        size=(len(sizes), max_size, *trail)).astype(np.float32)

    ref = jax_p2p(jnp.asarray(inputs), jnp.asarray(first), max_size)
    gref = jax.grad(lambda x: jnp.sum(w * jax_p2p(x, jnp.asarray(first), max_size)))(
        jnp.asarray(inputs))
    x = _t(inputs, requires_grad=True)
    out = ppt.packed_to_padded(x, _t(first), max_size)
    (out * _t(w)).sum().backward()

    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  native.packed_to_padded(inputs, first, max_size))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(gref))
    # The gradient is padded_to_packed of the cotangent.
    np.testing.assert_array_equal(x.grad.numpy(), native.padded_to_packed(w, first, F))


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_padded_to_packed_and_gradient_match_jax_and_native(case):
    sizes, trail = _CASES[case]
    _, first, max_size, F = _setup(case, sizes, trail)
    rng = np.random.default_rng(200 + case)
    padded = rng.normal(size=(len(sizes), max_size, *trail)).astype(np.float32)
    w = rng.normal(size=(F, *trail)).astype(np.float32)

    ref = jax_pd2pk(jnp.asarray(padded), jnp.asarray(first), F)
    gref = jax.grad(lambda x: jnp.sum(w * jax_pd2pk(x, jnp.asarray(first), F)))(
        jnp.asarray(padded))
    x = _t(padded, requires_grad=True)
    out = ppt.padded_to_packed(x, _t(first), F)
    (out * _t(w)).sum().backward()

    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  native.padded_to_packed(padded, first, F))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(gref))
    np.testing.assert_array_equal(x.grad.numpy(),
                                  native.packed_to_padded(w, first, max_size))


def test_roundtrip_and_list_first_idxs():
    inputs, first, max_size, F = _setup(7, (3, 5, 2), (4,))
    padded = ppt.packed_to_padded(_t(inputs), first.tolist(), max_size)
    assert padded.shape == (3, max_size, 4)
    back = ppt.padded_to_packed(padded, first.tolist(), F)
    np.testing.assert_array_equal(back.numpy(), inputs)


@pytest.mark.parametrize("max_size_dim", [1, 2, 3])
def test_max_size_dim_matches_jax(max_size_dim):
    rng = np.random.default_rng(max_size_dim)
    shape = [2, 3, 4, 5]
    shape[max_size_dim] = 6
    x = rng.normal(size=shape).astype(np.float32)
    first = np.array([0, 4])
    ref = jax_pd2pk(jnp.asarray(x), jnp.asarray(first), 9, max_size_dim=max_size_dim)
    out = ppt.padded_to_packed(_t(x), _t(first), 9, max_size_dim=max_size_dim)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_non_int_sizes_raise():
    inputs, first, max_size, F = _setup(9, (3, 5, 2), (4,))
    with pytest.raises(ValueError):
        ppt.packed_to_padded(_t(inputs), _t(first), torch.tensor(5))
    with pytest.raises(ValueError):
        ppt.packed_to_padded(_t(inputs), _t(first), 5.0)
    padded = np.zeros((3, max_size, 4), np.float32)
    with pytest.raises(ValueError):
        ppt.padded_to_packed(_t(padded), _t(first), np.float32(F))
