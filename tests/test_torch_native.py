"""The port's host library (``pytorch3d_pointops_tpu_torch/native.py``, its
own copy of ``csrc/pointops_cpu.cpp``) against the JAX package's: the same
source built with the same flags, so the seven entry points are bit-equal
on the cases and shapes of ``tests/test_native.py``. It is also held
against the port's plain ops (indices equal, values within 1e-5), and
takes no tensor off the host."""

import filecmp
import os

import numpy as np
import pytest
import torch

from pytorch3d_pointops_tpu import native as jax_native
from pytorch3d_pointops_tpu_torch import (
    _build,
    ball_query,
    knn_points,
    native,
    packed_to_padded,
    padded_to_packed,
    sample_farthest_points,
    sample_pdf,
)
from pytorch3d_pointops_tpu_torch.ops.knn import knn_backward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True)
def _toolchain():
    if not native.is_available():
        pytest.skip("no C++ toolchain")


def _clouds(seed, N=3, P1=64, P2=80, D=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, P1, D)).astype(np.float32),
            rng.normal(size=(N, P2, D)).astype(np.float32),
            rng.integers(1, P1 + 1, size=N), rng.integers(1, P2 + 1, size=N))


def _equal(port, jax_out):
    port = port if isinstance(port, tuple) else (port,)
    jax_out = jax_out if isinstance(jax_out, tuple) else (jax_out,)
    assert len(port) == len(jax_out)
    for a, b in zip(port, jax_out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


def test_source_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(
        os.path.join(REPO, "pytorch3d_pointops_tpu_torch", "csrc", "pointops_cpu.cpp"),
        os.path.join(REPO, "pytorch3d_pointops_tpu", "csrc", "pointops_cpu.cpp"),
        shallow=False,
    )
    assert _build.CXX_FLAGS == ("-O3", "-std=c++17", "-shared", "-fPIC",
                                "-march=native", "-pthread")
    path = _build.host_lib_path()
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.exists(path)
    assert not any(path == _build.lib_path(name) for name in _build.SOURCES)


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("K", [1, 5, 16])
def test_knn(norm, K):
    p1, p2, l1, l2 = _clouds(norm * 10 + K)
    out = native.knn_points(p1, p2, l1, l2, K=K, norm=norm)
    _equal(out, jax_native.knn_points(p1, p2, l1, l2, K=K, norm=norm))
    ref = knn_points(*map(torch.from_numpy, (p1, p2, l1, l2)), norm=norm, K=K)
    assert torch.equal(out[1].long(), ref.idx)
    torch.testing.assert_close(out[0], ref.dists, atol=TOL, rtol=TOL)


def test_knn_backward():
    p1, p2, l1, l2 = _clouds(3)
    _, idx = native.knn_points(p1, p2, l1, l2, K=4)
    g = np.random.default_rng(9).normal(size=idx.shape).astype(np.float32)
    out = native.knn_backward(p1, p2, idx, g, l1, l2, norm=2)
    _equal(out, jax_native.knn_backward(p1, p2, idx.numpy(), g, l1, l2, norm=2))
    T = [torch.from_numpy(np.asarray(a)) for a in (p1, p2, l1, l2)]
    ref = knn_backward(*T, idx.long(), 2, torch.from_numpy(g))
    for a, b in zip(out, ref):
        assert (a - b).abs().max() <= TOL * b.abs().max()


def test_ball_query():
    p1, p2, l1, l2 = _clouds(5)
    out = native.ball_query(p1, p2, l1, l2, K=8, radius=0.9)
    _equal(out, jax_native.ball_query(p1, p2, l1, l2, K=8, radius=0.9))
    ref = ball_query(*map(torch.from_numpy, (p1, p2, l1, l2)), K=8, radius=0.9,
                     return_nn=False)
    assert torch.equal(out[1].long(), ref.idx)
    torch.testing.assert_close(out[0], ref.dists, atol=TOL, rtol=TOL)


def test_fps():
    pts = np.random.default_rng(0).normal(size=(3, 50, 3)).astype(np.float32)
    lengths = np.array([50, 30, 7])
    out = native.sample_farthest_points(pts, lengths, K=[12, 5, 12])
    _equal(out, jax_native.sample_farthest_points(pts, lengths, K=[12, 5, 12]))
    _, ref = sample_farthest_points(torch.from_numpy(pts), torch.from_numpy(lengths),
                                    K=[12, 5, 12])
    assert torch.equal(out.long(), ref)
    starts = np.array([3, 29, 6])
    out = native.sample_farthest_points(torch.from_numpy(pts), torch.from_numpy(lengths),
                                        K=torch.tensor([12, 5, 12]),
                                        start_idxs=torch.from_numpy(starts))
    _equal(out, jax_native.sample_farthest_points(pts, lengths, K=[12, 5, 12],
                                                  start_idxs=starts))


@pytest.mark.parametrize("direction", ["packed_to_padded", "padded_to_packed"])
def test_packed_padded(direction):
    F, D = 25, 4
    inputs = np.random.default_rng(1).normal(size=(F, D)).astype(np.float32)
    first = np.array([0, 10, 13])
    pad = native.packed_to_padded(inputs, first, 12)
    if direction == "packed_to_padded":
        _equal(pad, jax_native.packed_to_padded(inputs, first, 12))
        ref = packed_to_padded(torch.from_numpy(inputs), torch.from_numpy(first), 12)
        assert torch.equal(pad, ref)
    else:
        back = native.padded_to_packed(pad, first, F)
        _equal(back, jax_native.padded_to_packed(pad.numpy(), first, F))
        assert torch.equal(back, padded_to_packed(pad, torch.from_numpy(first), F))
        assert torch.equal(back, torch.from_numpy(inputs))


def test_sample_pdf():
    B, n_bins, S = 6, 20, 15
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(size=(B, n_bins + 1)), axis=-1).astype(np.float32)
    weights = rng.uniform(size=(B, n_bins)).astype(np.float32)
    u = np.broadcast_to(np.linspace(0.0, 1.0, S, dtype=np.float32), (B, S))
    out = native.sample_pdf(bins, weights, u)
    _equal(out, jax_native.sample_pdf(bins, weights, u))
    ref = sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), S, det=True)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=0)


def test_takes_no_tensor_off_the_host():
    # The meta device stands in for a card here: any tensor that is not on
    # the CPU is refused, never copied to the host on the caller's behalf.
    off = torch.zeros((1, 4, 3), device="meta")
    host = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="CPU tensors or numpy"):
        native.knn_points(off, host)
    with pytest.raises(ValueError, match="CPU tensors or numpy"):
        native.sample_farthest_points(off, K=2)
    with pytest.raises(ValueError, match="lengths2"):
        native.knn_points(host, host, lengths2=[5])


def test_load_raises_without_a_compiler(monkeypatch):
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CXX", "no-such-compiler")
    native.load.cache_clear()  # a library loaded by an earlier test
    with pytest.raises(ImportError, match="C\\+\\+ compiler"):
        native.load()
    assert not native.is_available()
