"""The PyTorch port stands alone: importing it, or chip_smoke.py, loads
neither JAX nor the JAX package, and it exports the JAX package's names for
what it has ported."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
        "pytorch3d_pointops_tpu_torch.kernels.knn",
        "pytorch3d_pointops_tpu_torch.kernels.scatter",
        "pytorch3d_pointops_tpu_torch.kernels.chamfer",
        "pytorch3d_pointops_tpu_torch.structures.pointclouds",
        "pytorch3d_pointops_tpu_torch.convert",
        "pytorch3d_pointops_tpu_torch._build",
        "chip_smoke",
    ]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, *modules],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_exports_the_jax_names_it_ports():
    import pytorch3d_pointops_tpu as jp
    import pytorch3d_pointops_tpu_torch as ppt

    ported = set(ppt.__all__) - {"pointclouds_from_numpy", "tensors_from_numpy"}
    assert ported <= set(jp.__all__)
    for name in ppt.__all__:
        assert hasattr(ppt, name)
    assert {"knn_points", "knn_gather", "chamfer_distance", "Pointclouds"} <= ported
