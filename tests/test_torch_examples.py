"""The port's examples (``pytorch3d_pointops_tpu_torch/examples/``) on the
CPU: each ``main(device="cpu")`` runs to its end, and the numbers of
``knn_and_chamfer``, ``fps_and_ball_query``, ``covariances_demo``,
``ring_parallel``'s ring KNN and ``pointclouds_basics``' bounding boxes
agree with the JAX package's public ops on the same numpy inputs. The ring
example also runs on a process mesh of two gloo ranks under ``torchrun``,
its returned numbers held against the one-process ring's."""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_pointops_tpu as jp
from pytorch3d_pointops_tpu.ops.utils import get_point_covariances

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["pointclouds_basics", "packed_padded_walkthrough", "sample_pdf_demo",
            "knn_and_chamfer", "fps_and_ball_query", "covariances_demo",
            "ring_parallel", "performance"]
TOL = 1e-5
torch.set_num_threads(2)


def _example(name):
    return importlib.import_module(f"pytorch3d_pointops_tpu_torch.examples.{name}")


@pytest.fixture(scope="module")
def results():
    """Each example's ``main(device="cpu")``, run once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _example(name).main(device="cpu")
        return cache[name]

    return get


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, results):
    out = results(name)
    assert isinstance(out, dict) and out


def test_example_asked_for_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(ValueError, match="CUDA is not available"):
        _example("knn_and_chamfer").main(device="cuda")


def _padded(clouds):
    P = max(len(c) for c in clouds)
    out = np.zeros((len(clouds), P, clouds[0].shape[1]), np.float32)
    for i, c in enumerate(clouds):
        out[i, : len(c)] = c
    return out, np.array([len(c) for c in clouds])


def test_knn_and_chamfer_matches_jax(results):
    ex = _example("knn_and_chamfer")
    out = results("knn_and_chamfer")
    data = ex.make_inputs(0)
    pts1, lengths = _padded(data["points"])
    pts2, _ = _padded([p + np.float32(0.05) for p in data["points"]])
    normals, _ = _padded(data["normals"])

    knn = jp.knn_points(pts1, pts2, lengths, lengths, K=8)
    np.testing.assert_array_equal(out["knn_idx"], np.asarray(knn.idx))
    np.testing.assert_allclose(out["knn_dists"], np.asarray(knn.dists), atol=TOL, rtol=TOL)

    def loss_fn(p):
        loss, feats = jp.chamfer_distance(
            p, pts1, lengths, lengths, x_features={"normals": normals},
            y_features={"normals": normals}, feature_names=["normals"])
        return loss + feats["normals"]

    step = jax.jit(jax.value_and_grad(loss_fn))
    p = jnp.asarray(pts1 + np.float32(0.3) * data["noise"])
    loss, grad = step(p)
    assert abs(out["first_loss"] - float(loss)) <= TOL * abs(float(loss))
    g = np.asarray(grad)
    assert np.abs(out["first_grad"] - g).max() <= TOL * np.abs(g).max()
    for _ in range(ex.STEPS):
        loss, grad = step(p)
        p = p - ex.LR * grad
    # Rounding drifts apart over 100 steps: the final loss within 1e-4.
    assert abs(out["sgd_final_loss"] - float(loss)) <= 1e-4 * abs(float(loss))


def test_fps_and_ball_query_matches_jax(results):
    ex = _example("fps_and_ball_query")
    out = results("fps_and_ball_query")
    data = ex.make_inputs(0)
    cent, idx = jp.sample_farthest_points(data["points"], data["lengths"], K=ex.K_FPS)
    np.testing.assert_array_equal(out["fps_idx"], np.asarray(idx))
    grouped = jp.ball_query(data["points"], cent, lengths1=data["lengths"],
                            K=ex.K_BALL, radius=ex.RADIUS)
    np.testing.assert_array_equal(out["ball_idx"], np.asarray(grouped.idx))
    np.testing.assert_allclose(out["ball_dists"], np.asarray(grouped.dists), atol=TOL)


def test_covariances_match_jax(results):
    ex = _example("covariances_demo")
    out = results("covariances_demo")
    pts, lengths = _padded(ex.make_inputs(0))
    cov, _ = get_point_covariances(jnp.asarray(pts), jnp.asarray(lengths), ex.K)
    np.testing.assert_allclose(out["covariances"], np.asarray(cov), atol=TOL, rtol=TOL)


def test_pointclouds_basics_bounding_boxes_match_jax(results):
    out = results("pointclouds_basics")
    points = _example("pointclouds_basics").make_inputs(0)["points"]
    boxes = jp.get_bounding_boxes(jp.Pointclouds([jnp.asarray(p) for p in points]))
    np.testing.assert_array_equal(out["bounding_boxes"], np.asarray(boxes))


def test_ring_parallel_knn_matches_jax(results):
    ex = _example("ring_parallel")
    out = results("ring_parallel")
    data = ex.make_inputs(0)
    knn = jp.knn_points(data["p1"], data["p2"], K=ex.K)
    np.testing.assert_array_equal(out["ring_idx"], np.asarray(knn.idx))
    np.testing.assert_allclose(out["ring_dists"], np.asarray(knn.dists), atol=TOL, rtol=TOL)


# Each rank runs the example on the process mesh and saves what it returns.
RANK_SCRIPT = """
import sys

import numpy as np
import torch

from pytorch3d_pointops_tpu_torch.examples import ring_parallel

try:
    out = ring_parallel.main(device="cpu", process_mesh=True)
    np.savez(f"{sys.argv[1]}/rank{torch.distributed.get_rank()}.npz", **out)
finally:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
"""


def test_ring_parallel_on_a_process_mesh_of_two_ranks(results, tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["CUDA_VISIBLE_DEVICES"] = ""  # gloo on the CPU, on any machine
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         str(script), str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("OK") == 2, proc.stdout
    # Every rank returns the whole ring's numbers: the one-process ring's
    # (on a 2 x 4 mesh), indices equal, the losses within 1e-5 relative and
    # the 50-step SGD loop's within 1e-4 (rounding drifts over the steps).
    local = results("ring_parallel")
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_array_equal(got["ring_idx"], local["ring_idx"])
        np.testing.assert_allclose(got["ring_dists"], local["ring_dists"], atol=TOL, rtol=TOL)
        for key in ("first_loss", "feature_loss", "feature_normals"):
            assert abs(float(got[key]) - local[key]) <= TOL * abs(local[key]), key
        for key in ("sgd_losses", "sgd_final_loss", "sgd_single_loss"):
            np.testing.assert_allclose(got[key], local[key], rtol=1e-4, atol=0, err_msg=key)


def test_performance_raises_where_a_kernel_differs_from_its_twin():
    perf = _example("performance")
    d = torch.tensor([[[0.5, 2.0]]])
    i = torch.tensor([[[3, 1]]])
    assert perf.same_outputs("knn_topk", 2, (d, i), (d.clone(), i.clone())) == 0.0
    with pytest.raises(RuntimeError, match="knn_topk at P=2: output 0"):
        perf.same_outputs("knn_topk", 2, (d + 1e-3, i), (d, i))
    with pytest.raises(RuntimeError, match="knn_topk at P=2: output 1"):
        perf.same_outputs("knn_topk", 2, (d, i.flip(-1)), (d, i))
    with pytest.raises(RuntimeError, match="int32"):
        perf.same_outputs("knn_topk", 2, (d, i.int()), (d, i))
