"""The PyTorch port stands alone: importing it (its host library, sweep
and examples included), or chip_smoke.py, loads neither JAX nor the JAX
package, and it exports every public name of the JAX package and of its
``parallel`` layer, and has each of its examples."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(
    f[:-3] for f in os.listdir(os.path.join(REPO, "pytorch3d_pointops_tpu_torch", "examples"))
    if f.endswith(".py") and f != "__init__.py"
)

_PROBE = """
import sys
import importlib
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "pytorch3d_pointops_tpu"
             or m.startswith("pytorch3d_pointops_tpu."))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    modules = [
        "pytorch3d_pointops_tpu_torch",
        "pytorch3d_pointops_tpu_torch.ops.knn",
        "pytorch3d_pointops_tpu_torch.ops.chamfer",
        "pytorch3d_pointops_tpu_torch.ops.ball_query",
        "pytorch3d_pointops_tpu_torch.ops.fps",
        "pytorch3d_pointops_tpu_torch.ops.utils",
        "pytorch3d_pointops_tpu_torch.ops.packed_padded",
        "pytorch3d_pointops_tpu_torch.ops.sample_pdf",
        "pytorch3d_pointops_tpu_torch.kernels.knn",
        "pytorch3d_pointops_tpu_torch.kernels.spatial_sort",
        "pytorch3d_pointops_tpu_torch.kernels.scatter",
        "pytorch3d_pointops_tpu_torch.kernels.chamfer",
        "pytorch3d_pointops_tpu_torch.kernels.ball_query",
        "pytorch3d_pointops_tpu_torch.kernels.fps",
        "pytorch3d_pointops_tpu_torch.parallel",
        "pytorch3d_pointops_tpu_torch.parallel.mesh",
        "pytorch3d_pointops_tpu_torch.parallel.ring",
        "pytorch3d_pointops_tpu_torch.parallel.multihost",
        "pytorch3d_pointops_tpu_torch.tune_fps",
        "pytorch3d_pointops_tpu_torch.tune_knn",
        "pytorch3d_pointops_tpu_torch.tune_scatter",
        "pytorch3d_pointops_tpu_torch.tracing",
        "pytorch3d_pointops_tpu_torch.models",
        "pytorch3d_pointops_tpu_torch.models.pointnet2",
        "pytorch3d_pointops_tpu_torch.models.point_transformer",
        "pytorch3d_pointops_tpu_torch.structures.pointclouds",
        "pytorch3d_pointops_tpu_torch.convert",
        "pytorch3d_pointops_tpu_torch._build",
        "pytorch3d_pointops_tpu_torch.native",
        "pytorch3d_pointops_tpu_torch.sweep",
        "pytorch3d_pointops_tpu_torch.examples",
        *(f"pytorch3d_pointops_tpu_torch.examples.{name}" for name in EXAMPLES),
        "chip_smoke",
    ]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, *modules],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_has_every_example_of_the_jax_package():
    jax_examples = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                          if f.endswith(".py"))
    assert EXAMPLES == jax_examples


def test_port_exports_the_jax_names_it_ports():
    import pytorch3d_pointops_tpu as jp
    import pytorch3d_pointops_tpu_torch as ppt

    ported = set(ppt.__all__) - {"pointclouds_from_numpy", "tensors_from_numpy"}
    assert ported == set(jp.__all__)
    for name in ppt.__all__:
        assert hasattr(ppt, name)


def test_parallel_exports_the_jax_parallel_names():
    import pytorch3d_pointops_tpu.parallel as jpar
    import pytorch3d_pointops_tpu_torch as ppt
    import pytorch3d_pointops_tpu_torch.parallel as tpar

    assert set(tpar.__all__) == set(jpar.__all__)
    for name in tpar.__all__:
        assert hasattr(tpar, name)
    for name in ("initialize", "host_local_to_global", "global_to_host_local"):
        assert callable(getattr(tpar.multihost, name))
    # As in the JAX package, the top level does not export the ring.
    assert not set(tpar.__all__) & set(ppt.__all__)


def test_models_export_both_networks_and_their_modules():
    import pytorch3d_pointops_tpu_torch.models as models

    assert set(models.__all__) == {
        "PointNet2ClsSSG", "SetAbstraction", "PointTransformerSeg", "PointTransformerBlock",
        "PointTransformerLayer", "TransitionDown", "TransitionUp"}
    for name in models.__all__:
        assert isinstance(getattr(models, name), type), name
