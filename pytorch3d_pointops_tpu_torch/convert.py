"""Moving point-cloud state from numpy into the port.

The system has no learned weights: its state is the cloud data. These
helpers take numpy arrays, for example ``np.asarray`` of a JAX
``Pointclouds``' padded points, lengths and features, and place them on a
device, so that both packages compute on the same data.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .structures.pointclouds import Pointclouds, make_device


def tensors_from_numpy(*arrays, device="cuda"):
    """Each array as a tensor on ``device``: floating arrays as float32,
    integer arrays as int64, booleans as bool. ``device`` defaults to CUDA
    and raises when CUDA is absent; pass ``"cpu"`` for the host."""
    device = make_device(device)
    out = []
    for a in arrays:
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            dtype = torch.float32
        elif np.issubdtype(a.dtype, np.integer):
            dtype = torch.int64
        elif a.dtype == np.bool_:
            dtype = torch.bool
        else:
            raise ValueError(f"tensors_from_numpy: unsupported dtype {a.dtype}")
        out.append(torch.tensor(a, dtype=dtype, device=device))
    return tuple(out)


def pointclouds_from_numpy(
    points_padded,
    lengths,
    features: Optional[Dict[str, np.ndarray]] = None,
    device="cuda",
) -> Pointclouds:
    """A ``Pointclouds`` on ``device`` from padded (N, P, 3) points, (N,)
    lengths and an optional dict of padded (N, P, C) features."""
    points, lens = tensors_from_numpy(points_padded, lengths, device=device)
    feats = None
    if features:
        names = list(features)
        feats = dict(
            zip(names, tensors_from_numpy(*(features[n] for n in names), device=device))
        )
    return Pointclouds(points=points, lengths=lens, features=feats)
