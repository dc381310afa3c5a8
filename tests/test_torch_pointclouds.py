"""The PyTorch port's Pointclouds, its free functions, the list/padded/packed
helpers and the numpy conversion helpers against the JAX package, on the
CPU: the same numpy clouds go through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_pointops_tpu as jp
from pytorch3d_pointops_tpu.structures import utils as jutils
import pytorch3d_pointops_tpu_torch as ppt
from pytorch3d_pointops_tpu_torch.structures import utils as tutils

torch.set_num_threads(2)


def _lists(seed=0, sizes=(5, 0, 3, 7)):
    rng = np.random.default_rng(seed)
    pts = [rng.normal(size=(s, 3)).astype(np.float32) for s in sizes]
    nrm = [rng.normal(size=(s, 2)).astype(np.float32) for s in sizes]
    return pts, nrm


def _pair(seed=0, sizes=(5, 0, 3, 7)):
    pts, nrm = _lists(seed, sizes)
    jpc = jp.Pointclouds([jnp.asarray(p) for p in pts],
                         features={"n": [jnp.asarray(f) for f in nrm]})
    tpc = ppt.Pointclouds([torch.tensor(p) for p in pts],
                          features={"n": [torch.tensor(f) for f in nrm]})
    return jpc, tpc


def _eq(t, j):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j), atol=1e-6)


def _eq_lists(ts, js):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        assert tuple(t.shape) == tuple(j.shape)
        _eq(t, j)


def test_views_match_jax():
    jpc, tpc = _pair()
    assert len(tpc) == len(jpc) and tpc.isempty() == jpc.isempty()
    assert tpc.equisized == jpc.equisized
    _eq(tpc.points_padded(), jpc.points_padded())
    _eq(tpc.num_points_per_cloud(), jpc.num_points_per_cloud())
    _eq(tpc.valid, jpc.valid)
    _eq(tpc.get_features_padded("n"), jpc.get_features_padded("n"))
    _eq_lists(tpc.points_list(), jpc.points_list())
    _eq_lists(tpc.get_features_list("n"), jpc.get_features_list("n"))
    assert set(tpc.features_list()) == set(jpc.features_list())
    _eq(tpc.points_packed(), jpc.points_packed())
    _eq(tpc.get_features_packed("n"), jpc.get_features_packed("n"))
    _eq(tpc.packed_to_cloud_idx(), jpc.packed_to_cloud_idx())
    _eq(tpc.cloud_to_packed_first_idx(), jpc.cloud_to_packed_first_idx())
    _eq(tpc.padded_to_packed_idx(), jpc.padded_to_packed_idx())
    assert tpc.points_packed().device.type == "cpu"
    assert tpc.num_points_per_cloud().dtype == torch.int64


@pytest.mark.parametrize("index", [1, slice(1, 4), [3, 0], "bool", "int"])
def test_getitem_matches_jax(index):
    jpc, tpc = _pair(1)
    if index == "bool":
        t_idx, j_idx = torch.tensor([True, False, True, True]), np.array([True, False, True, True])
    elif index == "int":
        t_idx, j_idx = torch.tensor([2, 0]), np.array([2, 0])
    else:
        t_idx = j_idx = index
    _eq(tpc[t_idx].points_padded(), jpc[j_idx].points_padded())
    _eq(tpc[t_idx].get_features_padded("n"), jpc[j_idx].get_features_padded("n"))
    with pytest.raises(IndexError):
        tpc[1.5]


def test_batch_methods_match_jax():
    jpc, tpc = _pair(2)
    _eq(tpc.clone().points_padded(), jpc.clone().points_padded())
    _eq(tpc.detach().points_padded(), jpc.detach().points_padded())
    _eq(tpc.extend(2).points_padded(), jpc.extend(2).points_padded())
    for t, j in zip(tpc.split([1, 3]), jpc.split([1, 3])):
        _eq(t.points_padded(), j.points_padded())
    tp, tf = tpc.get_cloud(3)
    jp_, jf = jpc.get_cloud(3)
    _eq(tp, jp_)
    _eq(tf["n"], jf["n"])
    assert tpc.to("cpu") is tpc
    assert tpc.to("cpu", copy=True) is not tpc
    with pytest.raises(ValueError):
        tpc.get_cloud(9)


def test_geometry_matches_jax():
    jpc, tpc = _pair(3)
    off = np.random.default_rng(4).normal(size=(15, 3)).astype(np.float32)
    _eq(ppt.offset(tpc, torch.tensor(off)).points_padded(),
        jp.offset(jpc, jnp.asarray(off)).points_padded())
    _eq(ppt.offset(tpc, torch.tensor([1.0, 2.0, 3.0])).points_padded(),
        jp.offset(jpc, jnp.asarray([1.0, 2.0, 3.0])).points_padded())
    s = np.array([1.0, 2.0, 0.5, -1.0], np.float32)
    _eq(ppt.scale(tpc, torch.tensor(s)).points_padded(),
        jp.scale(jpc, jnp.asarray(s)).points_padded())
    _eq(ppt.scale(tpc, 2.0).points_padded(), jp.scale(jpc, 2.0).points_padded())
    box = np.array([[-0.5, -0.5, -0.5], [0.5, 1.0, 0.5]], np.float32)
    _eq(tpc.inside_box(torch.tensor(box)), jpc.inside_box(jnp.asarray(box)))
    new = np.random.default_rng(5).normal(size=(4, 7, 3)).astype(np.float32)
    _eq(tpc.update_padded(torch.tensor(new)).points_packed(),
        jpc.update_padded(jnp.asarray(new)).points_packed())
    # An empty cloud has no box: its rows are +-inf in both packages.
    _eq(ppt.get_bounding_boxes(tpc), jp.get_bounding_boxes(jpc))


def test_free_functions_match_jax():
    jpc, tpc = _pair(6)
    jpc2, tpc2 = _pair(7, sizes=(2, 4))
    _eq(ppt.join_pointclouds_as_batch([tpc, tpc2]).points_padded(),
        jp.join_pointclouds_as_batch([jpc, jpc2]).points_padded())
    _eq(ppt.join_pointclouds_as_scene(tpc).points_padded(),
        jp.join_pointclouds_as_scene(jpc).points_padded())
    _eq(ppt.join_pointclouds_as_scene([tpc, tpc2]).get_features_padded("n"),
        jp.join_pointclouds_as_scene([jpc, jpc2]).get_features_padded("n"))
    ts, js = ppt.subsample(tpc, 4, seed=3), jp.subsample(jpc, 4, seed=3)
    _eq(ts.points_padded(), js.points_padded())
    _eq(ts.get_features_padded("n"), js.get_features_padded("n"))
    assert ppt.all_close(tpc, tpc.clone())
    assert not ppt.all_close(tpc, ppt.scale(tpc, 2.0))


def test_structure_utils_match_jax():
    pts, _ = _lists(8)
    tl = [torch.tensor(p) for p in pts]
    jl = [jnp.asarray(p) for p in pts]
    _eq(tutils.list_to_padded(tl), jutils.list_to_padded(jl))
    _eq(tutils.list_to_padded(tl, (8, 4), pad_value=-1.0),
        jutils.list_to_padded(jl, (8, 4), pad_value=-1.0))
    padded = tutils.list_to_padded(tl)
    _eq_lists(tutils.padded_to_list(padded, [5, 0, 3, 7]),
              jutils.padded_to_list(jnp.asarray(padded.numpy()), [5, 0, 3, 7]))
    for t, j in zip(tutils.list_to_packed(tl), jutils.list_to_packed(jl)):
        _eq(t, j)
    packed = torch.cat(tl)
    _eq_lists(tutils.packed_to_list(packed, [5, 0, 3, 7]),
              jutils.packed_to_list(jnp.asarray(packed.numpy()), [5, 0, 3, 7]))
    jpad = jnp.asarray(padded.numpy())
    _eq(tutils.padded_to_packed(padded, [5, 0, 3, 7]),
        jutils.padded_to_packed(jpad, [5, 0, 3, 7]))
    _eq(tutils.padded_to_packed(padded, pad_value=0.0),
        jutils.padded_to_packed(jpad, pad_value=0.0))
    _eq(tutils.padded_to_packed(padded), jutils.padded_to_packed(jpad))
    with pytest.raises(ValueError):
        tutils.padded_to_packed(padded, [5, 0, 3, 7], pad_value=0.0)


def test_conversion_helpers_carry_jax_state():
    jpc, _ = _pair(9)
    tpc = ppt.pointclouds_from_numpy(
        np.asarray(jpc.points_padded()), np.asarray(jpc.num_points_per_cloud()),
        {k: np.asarray(v) for k, v in jpc.features_padded().items()}, device="cpu",
    )
    _eq(tpc.points_packed(), jpc.points_packed())
    _eq(tpc.get_features_packed("n"), jpc.get_features_packed("n"))
    a, b, c = ppt.tensors_from_numpy(
        np.zeros((2, 3), np.float64), np.arange(3, dtype=np.int32),
        np.ones(2, bool), device="cpu",
    )
    assert (a.dtype, b.dtype, c.dtype) == (torch.float32, torch.int64, torch.bool)


def test_devices_default_to_cuda_and_never_fall_back():
    """numpy inputs go to CUDA unless the caller asks for the CPU; without
    CUDA that raises instead of quietly staying on the host."""
    pts, _ = _lists(10, sizes=(3, 2))
    if torch.cuda.is_available():
        assert ppt.Pointclouds(pts).device.type == "cuda"
    else:
        with pytest.raises(ValueError):
            ppt.Pointclouds(pts)
        with pytest.raises(ValueError):
            ppt.pointclouds_from_numpy(np.zeros((1, 2, 3)), np.array([2]))
    assert ppt.Pointclouds(pts, device="cpu").device == torch.device("cpu")
    assert ppt.make_device("cpu") == torch.device("cpu")
