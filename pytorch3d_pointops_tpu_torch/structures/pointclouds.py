"""Ragged batches of 3D point clouds on torch tensors.

The port of ``pytorch3d_pointops_tpu/structures/pointclouds.py``:

* The padded representation is canonical: ``points_padded (N, P, 3)`` plus
  ``num_points_per_cloud (N,)`` (int64) are what every op consumes. List and
  packed views are computed lazily from them.
* Features are an open dict of named channels ``{name: (N, P, C)}``.
* Every tensor of one ``Pointclouds`` lives on one ``torch.device``. Built
  from tensors, it stays on their device unless ``device`` says otherwise;
  built from numpy arrays or lists of them, it goes to ``device``, which
  defaults to ``"cuda"`` and raises when CUDA is absent (pass ``"cpu"`` for
  the host).
* ``offset_`` / ``scale_`` replace the padded storage with new tensors and
  return self.
"""

from __future__ import annotations

from numbers import Integral
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import tracing
from . import utils as struct_utils


def make_device(device) -> torch.device:
    """A ``torch.device`` from a string or device. A bare ``"cuda"`` resolves
    to the current CUDA device; a CUDA device raises when CUDA is absent."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(
                f"device {device} requested but CUDA is not available; "
                "pass device='cpu' to build on the host"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _first_tensor(points):
    if isinstance(points, torch.Tensor):
        return points
    if isinstance(points, (list, tuple)):
        for p in points:
            if isinstance(p, torch.Tensor):
                return p
    return None


def _to_tensor(a, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device``; numpy floating arrays become float32."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        if dtype is None and np.issubdtype(a.dtype, np.floating):
            dtype = torch.float32
        return torch.tensor(a, dtype=dtype, device=device)
    return a.to(device=device, dtype=dtype)


class Pointclouds:
    """Batch of up-to-``P``-point clouds with named per-point feature channels.

    Construct from either:
      * a list of N tensors or arrays of shape ``(P_i, 3)`` (ragged), or
      * a padded tensor or array of shape ``(N, P, 3)`` (optionally with
        ``lengths``).
    ``features`` is an optional dict mapping names to the matching list /
    padded representation.
    """

    def __init__(self, points, features=None, lengths=None, device=None):
        if device is not None:
            device = make_device(device)
        elif _first_tensor(points) is not None:
            device = _first_tensor(points).device
        else:
            device = make_device("cuda")
        self.device = device
        self.equisized = False
        self._points_list = None
        self._features_list: Dict[str, List[torch.Tensor]] = {}
        self._points_packed = None
        self._features_packed: Dict[str, torch.Tensor] = {}
        self._packed_to_cloud_idx = None
        self._cloud_to_packed_first_idx = None
        self._padded_to_packed_idx = None

        if isinstance(points, (list, tuple)):
            points = [_to_tensor(p, device) for p in points]
            self._points_list = list(points)
            self._N = len(points)
            if self._N > 0:
                for p in points:
                    if p.numel() > 0 and (p.ndim != 2 or p.shape[1] != 3):
                        raise ValueError("Clouds in list must be of shape Px3 or empty")
                lengths_l = [int(p.shape[0]) for p in points]
                self._P = max(lengths_l)
                self._num_points_per_cloud = torch.tensor(lengths_l, device=device)
                self.equisized = len(set(lengths_l)) == 1
                self._points_padded = struct_utils.list_to_padded(
                    [p.reshape(-1, 3).to(torch.float32) for p in points],
                    (self._P, 3),
                    pad_value=0.0,
                    equisized=self.equisized,
                )
            else:
                self._P = 0
                self._num_points_per_cloud = torch.zeros(
                    (0,), dtype=torch.int64, device=device
                )
                self._points_padded = torch.zeros((0, 0, 3), device=device)
        elif isinstance(points, (torch.Tensor, np.ndarray)):
            points = _to_tensor(points, device)
            if points.ndim != 3 or points.shape[2] != 3:
                raise ValueError("Points tensor has incorrect dimensions.")
            self._points_padded = points
            self._N = points.shape[0]
            self._P = points.shape[1]
            if lengths is None:
                self._num_points_per_cloud = torch.full(
                    (self._N,), self._P, dtype=torch.int64, device=device
                )
                self.equisized = True
            else:
                self._num_points_per_cloud = _to_tensor(
                    lengths, device, torch.int64
                )
                if self._N > 0:
                    tracing.sync("pointclouds.equisized")
                    self.equisized = (
                        len(set(self._num_points_per_cloud.tolist())) == 1
                    )
        else:
            raise ValueError(
                "Points must be either a list or a tensor of shape (N, P, 3)."
            )

        self._features_padded: Dict[str, torch.Tensor] = {}
        self._C: Dict[str, int] = {}
        if features is not None:
            if not isinstance(features, dict):
                raise ValueError(
                    "Features must be a dictionary with feature names as keys"
                )
            for name, data in features.items():
                if data is None:
                    continue
                if isinstance(data, (list, tuple)):
                    self._parse_feature_list(name, data)
                elif isinstance(data, (torch.Tensor, np.ndarray)):
                    data = _to_tensor(data, device)
                    if data.ndim != 3:
                        raise ValueError(
                            "Auxiliary input tensor has incorrect dimensions."
                        )
                    if data.shape[0] != self._N:
                        raise ValueError("Points and inputs must be the same length.")
                    if data.shape[1] != self._P:
                        raise ValueError(
                            "Inputs tensor must have the right maximum number of "
                            "points in each cloud."
                        )
                    self._features_padded[name] = data
                    self._C[name] = int(data.shape[2])
                else:
                    raise ValueError(
                        "Features must be either a list or a padded tensor of "
                        "shape (batch_size, P, C)."
                    )

    def _parse_feature_list(self, name, data):
        if len(data) != self._N:
            raise ValueError("Points and auxiliary input must be the same length.")
        C = None
        fixed = []
        tracing.sync("pointclouds.feature_list")
        for p_i, d in zip(self._num_points_per_cloud.tolist(), data):
            if d is not None and np.ndim(d) == 2:
                d = _to_tensor(d, self.device)
                if p_i > 0 and d.shape[0] != p_i:
                    raise ValueError(
                        "A cloud has mismatched numbers of points and inputs"
                    )
                if C is None:
                    C = int(d.shape[1])
                elif C != d.shape[1]:
                    raise ValueError(
                        "The clouds must have the same number of channels"
                    )
                fixed.append(d)
            else:
                fixed.append(None)
        if C is None:
            return
        fixed = [
            f if f is not None else torch.zeros((0, C), device=self.device)
            for f in fixed
        ]
        self._features_list[name] = fixed
        self._features_padded[name] = struct_utils.list_to_padded(
            fixed, (self._P, C), pad_value=0.0, equisized=self.equisized
        )
        self._C[name] = C

    # ------------------------------------------------------------------
    # Basic properties
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._N

    @property
    def valid(self) -> torch.Tensor:
        """Bool tensor (N,): True where a cloud has a nonzero number of points."""
        return self._num_points_per_cloud > 0

    def isempty(self) -> bool:
        if self._N == 0:
            return True
        tracing.sync("pointclouds.isempty")
        return bool((self._num_points_per_cloud == 0).all())

    def num_points_per_cloud(self) -> torch.Tensor:
        return self._num_points_per_cloud

    # ------------------------------------------------------------------
    # Padded getters
    # ------------------------------------------------------------------
    def points_padded(self) -> torch.Tensor:
        return self._points_padded

    def get_features_padded(self, name: str) -> Optional[torch.Tensor]:
        return self._features_padded.get(name)

    def features_padded(self) -> Dict[str, torch.Tensor]:
        return self._features_padded

    # ------------------------------------------------------------------
    # List getters
    # ------------------------------------------------------------------
    def points_list(self) -> List[torch.Tensor]:
        if self._points_list is None:
            tracing.sync("pointclouds.list")
            lengths = self._num_points_per_cloud.tolist()
            self._points_list = [
                self._points_padded[i, : lengths[i]] for i in range(self._N)
            ]
        return self._points_list

    def get_features_list(self, name: str) -> Optional[List[torch.Tensor]]:
        if name not in self._features_list:
            if name not in self._features_padded:
                return None
            tracing.sync("pointclouds.list")
            lengths = self._num_points_per_cloud.tolist()
            self._features_list[name] = [
                self._features_padded[name][i, : lengths[i]]
                for i in range(self._N)
            ]
        return self._features_list[name]

    def features_list(self) -> Dict[str, List[torch.Tensor]]:
        return {
            name: self.get_features_list(name)
            for name in set(self._features_list) | set(self._features_padded)
        }

    # ------------------------------------------------------------------
    # Packed getters
    # ------------------------------------------------------------------
    def _compute_packed(self):
        if self._points_packed is not None:
            return
        dev = self.device
        lengths = self._num_points_per_cloud
        total = 0
        if self._N:
            tracing.sync("pointclouds.packed")
            total = int(lengths.sum())
        if total == 0:
            self._points_packed = torch.zeros((0, 3), device=dev)
            self._packed_to_cloud_idx = torch.zeros((0,), dtype=torch.int64, device=dev)
            self._cloud_to_packed_first_idx = torch.zeros(
                (self._N,), dtype=torch.int64, device=dev
            )
            self._features_packed = {}
            return
        self._cloud_to_packed_first_idx = torch.cumsum(lengths, 0) - lengths
        self._packed_to_cloud_idx = torch.repeat_interleave(
            torch.arange(self._N, device=dev), lengths, output_size=total
        )
        gather_idx = self.padded_to_packed_idx()
        self._points_packed = self._points_padded.reshape(-1, 3)[gather_idx]
        self._features_packed = {
            name: fp.reshape(-1, fp.shape[-1])[gather_idx]
            for name, fp in self._features_padded.items()
        }

    def points_packed(self) -> torch.Tensor:
        self._compute_packed()
        return self._points_packed

    def get_features_packed(self, name: str) -> Optional[torch.Tensor]:
        self._compute_packed()
        return self._features_packed.get(name)

    def features_packed(self) -> Dict[str, torch.Tensor]:
        self._compute_packed()
        return self._features_packed

    def packed_to_cloud_idx(self) -> torch.Tensor:
        self._compute_packed()
        return self._packed_to_cloud_idx

    def cloud_to_packed_first_idx(self) -> torch.Tensor:
        self._compute_packed()
        return self._cloud_to_packed_first_idx

    def padded_to_packed_idx(self) -> torch.Tensor:
        """Indices into the flattened padded points giving the packed points."""
        if self._padded_to_packed_idx is None:
            tracing.sync("pointclouds.packed_idx")
            self._padded_to_packed_idx = torch.cat(
                [
                    torch.arange(v, device=self.device) + i * self._P
                    for i, v in enumerate(self._num_points_per_cloud.tolist())
                ]
                or [torch.zeros((0,), dtype=torch.int64, device=self.device)]
            )
        return self._padded_to_packed_idx

    # ------------------------------------------------------------------
    # Batch ops
    # ------------------------------------------------------------------
    def __getitem__(self, index) -> "Pointclouds":
        features_dict = self.features_list()
        if isinstance(index, Integral):
            idx_list = [int(index)]
        elif isinstance(index, slice):
            idx_list = list(range(self._N))[index]
        elif isinstance(index, list):
            idx_list = [int(i) for i in index]
        elif isinstance(index, (torch.Tensor, np.ndarray)):
            if isinstance(index, torch.Tensor):
                tracing.sync("pointclouds.getitem")
            index = np.asarray(index.cpu() if isinstance(index, torch.Tensor) else index)
            if index.ndim != 1 or np.issubdtype(index.dtype, np.floating):
                raise IndexError(index)
            if index.dtype == bool:
                idx_list = [int(i) for i in np.nonzero(index)[0]]
            else:
                idx_list = [int(i) for i in index]
        else:
            raise IndexError(index)

        points = [self.points_list()[i] for i in idx_list]
        features = {
            name: [flist[i] for i in idx_list]
            for name, flist in features_dict.items()
            if flist is not None
        }
        return self.__class__(
            points=points, features=features if features else None,
            device=self.device,
        )

    def _rebuild(self, fn) -> "Pointclouds":
        """A new Pointclouds with ``fn`` applied to every padded tensor."""
        new = self.__class__(
            points=fn(self._points_padded),
            lengths=fn(self._num_points_per_cloud),
            features={k: fn(v) for k, v in self._features_padded.items()} or None,
        )
        new.equisized = self.equisized
        return new

    def clone(self) -> "Pointclouds":
        return self._rebuild(torch.clone)

    def detach(self) -> "Pointclouds":
        return self._rebuild(torch.Tensor.detach)

    def to(self, device, copy: bool = False) -> "Pointclouds":
        """All tensors on ``device`` (a string or ``torch.device``). With
        ``copy=False`` and everything already there, returns ``self``."""
        device = make_device(device)
        if not copy and self.device == device:
            return self
        return self._rebuild(lambda t: t.to(device, copy=True))

    def cpu(self) -> "Pointclouds":
        return self.to("cpu")

    def accelerator(self) -> "Pointclouds":
        """All tensors on the current CUDA device."""
        return self.to("cuda")

    def cuda(self) -> "Pointclouds":
        return self.accelerator()

    def extend(self, N: int) -> "Pointclouds":
        if not isinstance(N, int):
            raise ValueError("N must be an integer.")
        if N <= 0:
            raise ValueError("N must be > 0.")
        new_points = []
        for p in self.points_list():
            new_points.extend([p] * N)
        new_features = {}
        for name, flist in self.features_list().items():
            out = []
            for f in flist:
                out.extend([f] * N)
            new_features[name] = out
        return self.__class__(
            points=new_points, features=new_features if new_features else None,
            device=self.device,
        )

    def split(self, split_sizes: list) -> List["Pointclouds"]:
        if not all(isinstance(x, int) for x in split_sizes):
            raise ValueError("Value of split_sizes must be a list of integers.")
        out = []
        cur = 0
        for s in split_sizes:
            out.append(self[cur : cur + s])
            cur += s
        return out

    def get_cloud(self, index: int):
        if not isinstance(index, Integral):
            raise ValueError("Cloud index must be an integer.")
        if index < 0 or index >= self._N:
            raise ValueError("Cloud index must be in the range [0, N).")
        points = self.points_list()[index]
        features = {
            name: flist[index]
            for name, flist in self.features_list().items()
            if flist is not None
        }
        return points, features

    # ------------------------------------------------------------------
    # Geometry ops
    # ------------------------------------------------------------------
    def _mask(self) -> torch.Tensor:
        """(N, P) bool validity mask from lengths."""
        return (
            torch.arange(self._P, device=self.device)[None, :]
            < self._num_points_per_cloud[:, None]
        )

    def offset_(self, offsets_packed) -> "Pointclouds":
        """Translate the clouds by (3,) or packed (sum(P_i), 3) offsets.
        Replaces this object's padded storage; returns self."""
        offsets_packed = _to_tensor(offsets_packed, self.device)
        mask = self._mask()[..., None]
        if offsets_packed.shape == (3,):
            off_padded = offsets_packed.expand(self._points_padded.shape)
        else:
            if offsets_packed.shape != self.points_packed().shape:
                raise ValueError("Offsets must have dimension (all_p, 3).")
            flat = offsets_packed.new_zeros((self._N * self._P, 3))
            flat[self.padded_to_packed_idx()] = offsets_packed
            off_padded = flat.reshape(self._N, self._P, 3)
        self._set_points_padded(
            torch.where(mask, self._points_padded + off_padded, self._points_padded)
        )
        return self

    def scale_(self, scale) -> "Pointclouds":
        """Scale cloud coordinates by a scalar or per-cloud (N,) factors."""
        scale = _to_tensor(scale, self.device, self._points_padded.dtype)
        if scale.ndim == 0:
            scale = scale.expand(len(self))
        mask = self._mask()[..., None]
        self._set_points_padded(
            torch.where(
                mask,
                self._points_padded * scale[:, None, None],
                self._points_padded,
            )
        )
        return self

    def _set_points_padded(self, new_padded: torch.Tensor):
        self._points_padded = new_padded
        self._points_list = None
        self._points_packed = None

    @tracing.spanned("update_padded")
    def update_padded(
        self, new_points_padded: torch.Tensor, new_features_padded=None
    ) -> "Pointclouds":
        """A new Pointclouds with new padded points (and optionally
        features), reusing the index tensors. Features not re-supplied are
        kept; a features dict replaces the whole dict."""

        def check_shapes(x, size):
            if x.shape[0] != size[0]:
                raise ValueError("new values must have the same batch dimension.")
            if x.shape[1] != size[1]:
                raise ValueError("new values must have the same number of points.")
            if size[2] is not None and x.shape[2] != size[2]:
                raise ValueError("new values must have the same number of channels.")

        check_shapes(new_points_padded, [self._N, self._P, 3])
        if new_features_padded is not None:
            if not isinstance(new_features_padded, dict):
                raise ValueError("new_features_padded must be a dictionary")
            for name, f in new_features_padded.items():
                check_shapes(f, [self._N, self._P, self._C.get(name)])

        new = self.__class__(
            points=new_points_padded,
            lengths=self._num_points_per_cloud,
            features=new_features_padded
            if new_features_padded is not None
            else (self._features_padded or None),
            device=self.device,
        )
        new.equisized = self.equisized
        new._packed_to_cloud_idx = self._packed_to_cloud_idx
        new._cloud_to_packed_first_idx = self._cloud_to_packed_first_idx
        new._padded_to_packed_idx = self._padded_to_packed_idx
        return new

    def inside_box(self, box) -> torch.Tensor:
        """Bool (sum(P_i),) mask of packed points inside an axis-aligned box
        given as (2, 3) or (N, 2, 3) [min; max] rows."""
        box = _to_tensor(box, self.device)
        if box.ndim > 3 or box.ndim < 2:
            raise ValueError("Input box must be of shape (2, 3) or (N, 2, 3).")
        if box.ndim == 3 and box.shape[0] != 1 and box.shape[0] != self._N:
            raise ValueError("Input box dimension is incompatible with pointcloud size.")
        if box.ndim == 2:
            box = box[None]
        tracing.sync("pointclouds.inside_box")
        if bool((box[..., 0, :] > box[..., 1, :]).any()):
            raise ValueError("Input box is invalid: min values larger than max values.")

        points_packed = self.points_packed()
        if box.shape[0] == 1:
            box_per_point = box.expand(points_packed.shape[0], 2, 3)
        else:
            box_per_point = box[self.packed_to_cloud_idx()]
        coord_inside = (points_packed >= box_per_point[:, 0]) & (
            points_packed <= box_per_point[:, 1]
        )
        return coord_inside.all(dim=-1)


# ----------------------------------------------------------------------
# Free functions
# ----------------------------------------------------------------------
def join_pointclouds_as_batch(pointclouds: Sequence[Pointclouds]) -> Pointclouds:
    """Concatenate several Pointclouds batches into one; a feature channel is
    kept only if present in every member."""
    if isinstance(pointclouds, Pointclouds) or not isinstance(pointclouds, Sequence):
        raise ValueError("Wrong first argument to join_points_as_batch.")
    points_list = [p for pc in pointclouds for p in pc.points_list()]

    all_dicts = [pc.features_list() for pc in pointclouds]
    names = set()
    for d in all_dicts:
        names.update(d.keys())
    combined = {}
    for name in names:
        feats = []
        ok = True
        for d in all_dicts:
            if name in d and d[name] is not None:
                feats.extend(d[name])
            else:
                ok = False
                break
        if ok:
            if feats and any(f.shape[1] != feats[0].shape[1] for f in feats[1:]):
                raise ValueError(
                    f"Pointclouds must have the same number of channels for "
                    f"feature '{name}'"
                )
            combined[name] = feats
    return Pointclouds(
        points=points_list, features=combined if combined else None,
        device=pointclouds[0].device,
    )


def join_pointclouds_as_scene(
    pointclouds: Union[Pointclouds, List[Pointclouds]],
) -> Pointclouds:
    """Pack a batch (or list of batches) into a single-cloud Pointclouds."""
    if isinstance(pointclouds, list):
        pointclouds = join_pointclouds_as_batch(pointclouds)
    if len(pointclouds) == 1:
        return pointclouds
    points = pointclouds.points_packed()
    features = {name: f[None] for name, f in pointclouds.features_packed().items()}
    return Pointclouds(
        points=points[None], features=features if features else None,
        device=pointclouds.device,
    )


def get_bounding_boxes(pointcloud: Pointclouds) -> torch.Tensor:
    """(N, 3, 2) per-cloud axis-aligned min/max, from the padded points and
    a lengths mask. Raises ``ValueError`` where every cloud is empty, as
    the JAX package does."""
    pts = pointcloud.points_padded()
    if pts.shape[1] == 0:
        raise ValueError("zero-size array to reduction operation min which has "
                         "no identity")
    mask = pointcloud._mask()[..., None]
    mins = torch.where(mask, pts, float("inf")).amin(dim=1)
    maxs = torch.where(mask, pts, float("-inf")).amax(dim=1)
    return torch.stack([mins, maxs], dim=2)


def offset(pointcloud: Pointclouds, offsets_packed) -> Pointclouds:
    """Out-of-place offset."""
    return pointcloud.clone().offset_(offsets_packed)


def scale(pointcloud: Pointclouds, scale) -> Pointclouds:
    """Out-of-place scale."""
    return pointcloud.clone().scale_(scale)


def subsample(
    pointclouds: Pointclouds,
    max_points: Union[int, Sequence[int]],
    seed: int = 0,
) -> Pointclouds:
    """Randomly subsample each cloud to at most ``max_points`` points, with
    matched feature selection. The choice comes from
    ``numpy.random.default_rng(seed)``."""
    if isinstance(max_points, int):
        max_points = [max_points] * len(pointclouds)
    elif len(max_points) != len(pointclouds):
        raise ValueError("wrong number of max_points supplied")
    tracing.sync("subsample.lengths")
    lengths = pointclouds.num_points_per_cloud().tolist()
    if all(int(n) <= int(m) for n, m in zip(lengths, max_points)):
        return pointclouds

    rng = np.random.default_rng(seed)
    points_list = []
    all_features = pointclouds.features_list()
    features_out = {name: [] for name in all_features}
    for i, (max_, n_points, points) in enumerate(
        zip(map(int, max_points), map(int, lengths), pointclouds.points_list())
    ):
        if n_points > max_:
            keep = torch.from_numpy(
                np.sort(rng.choice(n_points, max_, replace=False))
            ).to(points.device)
            points = points[keep]
            for name, flist in all_features.items():
                features_out[name].append(flist[i][keep])
        else:
            for name, flist in all_features.items():
                features_out[name].append(flist[i])
        points_list.append(points)
    features_out = {k: v for k, v in features_out.items() if v}
    return Pointclouds(
        points=points_list, features=features_out if features_out else None,
        device=pointclouds.device,
    )


def all_close(
    pcd1: Pointclouds, pcd2: Pointclouds, rtol=1e-05, atol=1e-08, verbose=False
) -> bool:
    """True when two Pointclouds have allclose packed points and identical
    feature channel sets with allclose values."""
    tracing.sync("all_close")
    points_all_close = bool(
        torch.allclose(pcd1.points_packed(), pcd2.points_packed(), rtol, atol)
    )
    if verbose:
        print("Points all close:", points_all_close)
    if set(pcd1.features_packed().keys()) != set(pcd2.features_packed().keys()):
        if verbose:
            print(
                "Features keys mismatch:",
                pcd1.features_packed().keys(),
                pcd2.features_packed().keys(),
            )
        return False
    tracing.sync("all_close", len(pcd1.features_packed()))
    feats_close = {
        name: bool(
            torch.allclose(
                pcd1.get_features_packed(name),
                pcd2.get_features_packed(name),
                rtol,
                atol,
            )
        )
        for name in pcd1.features_packed()
    }
    if verbose:
        print("Features all close:", feats_close)
    return points_all_close and all(feats_close.values())
