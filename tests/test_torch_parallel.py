"""The port's mesh and sharding helpers and ``multihost`` on the CPU: mesh
shapes, repeated devices, ``shard`` / ``full`` and ``shard_pointclouds``
round trips, ``initialize`` (a no-op when a group exists, the swallowed
auto-detect failure with its warning, the failure raised again with
explicit arguments), and the slab helpers at world size 1 and across a
two-process gloo group."""

import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import pytorch3d_pointops_tpu_torch as ppt
from pytorch3d_pointops_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    multihost,
    point_sharding,
    shard_pointclouds,
)
from pytorch3d_pointops_tpu_torch.parallel.mesh import NamedSharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def test_make_mesh_shape_and_repeated_devices():
    mesh = make_mesh((2, 4), ("dp", "sp"), devices=[CPU] * 8)
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert mesh.devices.shape == (2, 4)
    assert all(d == CPU for d in mesh.devices.flat)
    one_axis = make_mesh(axis_names=("dp", "sp"), devices=[CPU] * 3)
    assert one_axis.shape == {"dp": 3, "sp": 1}
    with pytest.raises(ValueError):
        make_mesh((3, 2), devices=[CPU] * 8)
    with pytest.raises(ValueError):
        make_mesh((8,), ("dp", "sp"), devices=[CPU] * 8)


def test_make_mesh_default_devices_are_cuda():
    """With no devices the mesh takes every CUDA device, and without CUDA it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        mesh = make_mesh()
        assert [d.type for d in mesh.devices.flat] == ["cuda"] * torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("spec", [("dp", "sp", None), (None, "sp", None),
                                  ("dp", None, None), ("sp", "dp", None),
                                  (None, None, None)])
def test_shard_round_trip(spec):
    mesh = make_mesh((2, 4), ("dp", "sp"), devices=[CPU] * 8)
    t = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    sharded = NamedSharding(mesh, spec).shard(t)
    for coord in np.ndindex(2, 4):
        piece = sharded.pieces[coord]
        want = [s // (mesh.shape[a] if a else 1) for s, a in zip(t.shape, spec)]
        assert list(piece.shape) == want
    assert torch.equal(sharded.full(), t)


def test_shard_helpers_and_gradient():
    """batch_sharding / point_sharding place the blocks; ``full`` is
    differentiable back into the pieces; a size that does not split
    raises."""
    mesh = make_mesh((2, 4), ("dp", "sp"), devices=[CPU] * 8)
    t = torch.randn(4, 8, 3, requires_grad=True)
    assert batch_sharding(mesh).spec == ("dp", None, None)
    sh = point_sharding(mesh, batch_axis="dp").shard(t)
    assert sh.pieces[1, 2].shape == (2, 2, 3)
    assert torch.equal(sh.pieces[1, 2], t[2:4, 4:6].detach())
    (sh.full() * 2).sum().backward()
    assert torch.equal(t.grad, torch.full_like(t, 2.0))
    with pytest.raises(ValueError):
        point_sharding(mesh).shard(torch.zeros(2, 6, 3))
    with pytest.raises(ValueError):
        NamedSharding(mesh, ("tp", None, None))


def test_shard_pointclouds_round_trip():
    rng = np.random.default_rng(0)
    clouds = [torch.tensor(rng.normal(size=(n, 3)).astype(np.float32))
              for n in (5, 9, 1, 7)]
    normals = [torch.tensor(rng.normal(size=(c.shape[0], 3)).astype(np.float32))
               for c in clouds]
    pc = ppt.Pointclouds(clouds, features={"normals": normals})
    mesh = make_mesh((2, 4), ("dp", "sp"), devices=[CPU] * 8)
    parts = shard_pointclouds(pc, mesh, "dp")
    assert len(parts) == 8
    # Devices along sp hold the same clouds; dp blocks are [0, 1] and [2, 3].
    for k, part in enumerate(parts):
        block = k // 4
        assert len(part) == 2
        for j in range(2):
            assert torch.equal(part.points_list()[j], clouds[2 * block + j])
            assert torch.equal(part.get_features_list("normals")[j],
                               normals[2 * block + j])
    joined = ppt.join_pointclouds_as_batch([parts[0], parts[4]])
    assert all(torch.equal(a, b) for a, b in zip(joined.points_list(), clouds))
    with pytest.raises(ValueError):
        shard_pointclouds(pc, make_mesh((3,), ("dp",), devices=[CPU] * 3))


# ----------------------------- multihost -----------------------------

def test_initialize_noop_when_already_initialized(monkeypatch):
    def fail(*a, **kw):
        raise AssertionError("re-init attempted")

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group", fail)
    multihost.initialize()


def test_initialize_swallows_auto_detect_failure(monkeypatch, caplog):
    """The argument-free call with no group in the environment: the real
    ``init_process_group`` fails, the failure is logged as a warning and
    the process runs alone."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with caplog.at_level(logging.WARNING, logger="pytorch3d_pointops_tpu_torch"):
        multihost.initialize()
    assert not dist.is_initialized()
    assert any("auto-detection failed" in r.getMessage() for r in caplog.records)


def test_initialize_reraises_with_explicit_args(monkeypatch):
    seen = {}

    def fail(**kw):
        seen.update(kw)
        raise RuntimeError("cannot reach coordinator (simulated)")

    monkeypatch.setattr(dist, "init_process_group", fail)
    with pytest.raises(RuntimeError, match="simulated"):
        multihost.initialize(coordinator_address="tcp://127.0.0.1:1234",
                             num_processes=2, process_id=0)
    assert seen == {"backend": "nccl" if torch.cuda.is_available() else "gloo",
                    "init_method": "tcp://127.0.0.1:1234", "world_size": 2,
                    "rank": 0}


def test_host_local_to_global_single_process():
    """One process: the slab is the global tensor and the round trip is
    exact."""
    mesh = make_mesh((4, 2), ("dp", "sp"), devices=[CPU] * 8)
    local = np.arange(8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3)
    g = multihost.host_local_to_global(local, mesh, ("dp", "sp", None))
    assert g.shape == (8, 6, 3)
    assert torch.equal(g, torch.from_numpy(local))
    assert torch.equal(multihost.global_to_host_local(g), g)
    with pytest.raises(ValueError):
        multihost.host_local_to_global(local, mesh, ("dp", None))


_TWO_RANKS = """
import os, sys
import torch
import torch.distributed as dist

sys.path.insert(0, {repo!r})
from pytorch3d_pointops_tpu_torch.parallel import make_mesh, multihost


def worker(rank, init_file):
    multihost.initialize("file://" + init_file, num_processes=2, process_id=rank)
    assert dist.get_world_size() == 2 and dist.get_rank() == rank
    multihost.initialize()  # a no-op now
    mesh = make_mesh((2,), ("dp",), devices=[torch.device("cpu")] * 2)
    local = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3) + 100 * rank
    g = multihost.host_local_to_global(local, mesh, ("dp", None, None))
    want = torch.cat([torch.arange(12, dtype=torch.float32).reshape(2, 2, 3) + 100 * r
                      for r in range(2)])
    assert torch.equal(g, want), g
    assert torch.equal(multihost.global_to_host_local(g), local)
    # Sharded along dimension 1: the slabs join there and split back there.
    g1 = multihost.host_local_to_global(local, mesh, (None, "dp", None))
    assert torch.equal(g1, torch.cat([want[:2], want[2:]], dim=1)), g1
    assert torch.equal(multihost.global_to_host_local(g1, (None, "dp", None)), local)
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.multiprocessing.spawn(worker, args=(sys.argv[1],), nprocs=2)
    print("OK")
"""


def test_slabs_across_two_gloo_processes(tmp_path):
    """Two processes joined over gloo: the global tensor is the slabs in
    rank order, and each rank gets its own slab back."""
    script = tmp_path / "two_ranks.py"
    script.write_text(textwrap.dedent(_TWO_RANKS.format(repo=REPO)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["CUDA_VISIBLE_DEVICES"] = ""  # gloo on the CPU, on any machine
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "init")],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout
