"""The JAX package's eight example scripts, on the port.

Each is a module with ``main(device="cuda", seed=0) -> dict`` that returns
the numbers it prints, and runs from the command line:

    python -m pytorch3d_pointops_tpu_torch.examples.<name> [--device cpu] [--seed 0]

* ``pointclouds_basics``: the ``Pointclouds`` views, features, indexing,
  ``update_padded`` and bounding boxes;
* ``packed_padded_walkthrough``: the packed <-> padded round trip and its
  gradient;
* ``sample_pdf_demo``: inverse-CDF sampling, against the NeRF variant and
  the host library;
* ``knn_and_chamfer``: ragged KNN, ``knn_gather`` and a chamfer + normals
  fit;
* ``fps_and_ball_query``: PointNet++ grouping, farthest point sampling and
  a ball query;
* ``covariances_demo``: local covariances and their eigen-structure;
* ``ring_parallel``: the ring over a mesh (``--process-mesh`` under
  ``torchrun``: one process a position);
* ``performance``: latency by size, batch scaling, kernel against plain
  twin, peak memory and the empirical exponent.

Data comes from ``np.random.default_rng(seed)``, or from a
``torch.Generator`` where an op takes one. ``device`` defaults to CUDA and
raises when CUDA is absent; nothing changes with what the machine has. A
check that fails raises ``RuntimeError``.
"""

from __future__ import annotations

import argparse


def check(cond, what: str) -> None:
    """Raise ``RuntimeError`` unless ``cond``: an example's own check."""
    if not cond:
        raise RuntimeError(f"example check failed: {what}")


def parser(doc: str) -> argparse.ArgumentParser:
    """The command line every example takes: ``--device`` and ``--seed``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the ops run: cuda (the kernels) or cpu (the plain twins)")
    ap.add_argument("--seed", type=int, default=0, help="the data's seed")
    return ap
