"""A seeded sweep over every kernel's public route, at small shapes.

``cases(count)`` draws ``Case``s round-robin over six families, each from
its own seed:

* ``knn``: ``knn_points`` forward and backward (sorted, and the unsorted
  order and ``return_nn`` forward), K up to P2 + 7, both norms (the KNN
  kernel; its backward, the rows scatter);
* ``ball_query``: forward and backward, radii whose squares are exact in
  float32 (the ball query kernel; the rows scatter);
* ``fps``: ``sample_farthest_points`` with an int K or one a cloud,
  including 0 and K past the length, from 0 or from random starts (the FPS
  block kernel);
* ``chamfer``: ``chamfer_distance`` across its option matrix, with a
  feature channel and weights, forward and backward (the chamfer NN kernel
  and ``scatter_add_k1``; the KNN kernel and the rows scatter when single
  directional);
* ``gather``: ``masked_gather`` with -1 slots (its backward, the rows
  scatter) and ``packed_to_padded`` / ``padded_to_packed`` with gradients;
* ``sample_pdf``: deterministic and random quantiles.

Clouds have D in {1, 2, 3, 5}, lengths that include 0, points on a 1/8 grid
(so that distances are exact and ties real) or Gaussian, and sometimes
every point duplicated. ``run_case(case, device)`` runs a case through the
public ops on ``device`` and returns numpy outputs; on CUDA tensors the ops
launch the kernels, on CPU tensors they run the plain twins, so one case on
both devices holds the kernels against their twins (``compare``).
``check_native`` holds a card's outputs against the host library
(``native.py``) on the same inputs. Every failure names the case: its
family, seed, shapes and parameters.

The large clouds and the routes they take (the FPS grid kernel, sorted and
seeded KNN) are ``chip_smoke.py``'s directed phases, not the sweep's.

``empty_cases()`` is a directed list apart from the seeded one: empty
dimensions (N, P1, P2 or P = 0), K = 0, the chamfer option matrix with an
empty y cloud, and every length 0 with P > 0, through the same public ops
and five more families (``masked_gather``, ``knn_gather``,
``covariances``, ``fps_naive``, ``bounding_boxes``). Each case records in
``expect`` what the JAX package does with it: ``"returns"`` its outputs,
``"raises"`` a refusal that the port makes too, or ``"crashes"`` inside
its reshapes (integer modulo by zero at N = 0: KNN, ball query, the
grouped ``masked_gather``) where the port returns its empty outputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from . import native
from .ops import (
    ball_query,
    chamfer_distance,
    get_point_covariances,
    knn_gather,
    knn_points,
    masked_gather,
    packed_to_padded,
    padded_to_packed,
    sample_farthest_points,
    sample_farthest_points_naive,
    sample_pdf,
)
from .structures import Pointclouds, get_bounding_boxes

FAMILIES = ("knn", "ball_query", "fps", "chamfer", "gather", "sample_pdf")
DIMS = (1, 2, 3, 5)
# Squares exact in float32: the ops square the radius in double and round
# once, the host library squares it in float32; for these both agree.
RADII = (0.25, 0.375, 0.5, 0.75, 1.0)
TOL = 1e-5


@dataclass(frozen=True)
class Case:
    family: str
    seed: int
    params: tuple  # sorted (name, value) pairs
    expect: str = "returns"  # what the JAX package does: returns, raises, crashes

    @property
    def p(self) -> dict:
        return dict(self.params)

    def __str__(self) -> str:
        return (f"sweep case {self.family} seed={self.seed} "
                + " ".join(f"{k}={v}" for k, v in self.params))


def _pick(rng, options):
    return options[int(rng.integers(len(options)))]


def _cloud_params(rng, max_p1=70, max_p2=130) -> dict:
    return {
        "N": int(rng.integers(1, 4)),
        "P1": int(rng.integers(1, max_p1 + 1)),
        "P2": int(rng.integers(1, max_p2 + 1)),
        "D": int(_pick(rng, DIMS)),
        "grid": bool(rng.random() < 0.5),
        "dup": bool(rng.random() < 0.3),
    }


def _params(family: str, rng) -> dict:
    p = _cloud_params(rng)
    if family == "knn":
        p.update(K=int(rng.integers(1, p["P2"] + 8)), norm=int(_pick(rng, (1, 2))))
    elif family == "ball_query":
        p.update(K=int(rng.integers(1, p["P2"] + 8)), radius=float(_pick(rng, RADII)))
    elif family == "fps":
        p.update(P=int(rng.integers(1, 300)), per_cloud_K=bool(rng.random() < 0.5),
                 random_start=bool(rng.random() < 0.5))
        p.update(K=int(rng.integers(0, p["P"] + 8)))
    elif family == "chamfer":
        point_reduction = _pick(rng, ("mean", "sum", "max", None))
        p.update(
            norm=int(_pick(rng, (1, 2))),
            # point_reduction None takes no batch reduction.
            batch_reduction=_pick(rng, ("mean", "sum", None)) if point_reduction else None,
            point_reduction=point_reduction,
            single_directional=bool(rng.random() < 0.3),
            abs_cosine=bool(rng.random() < 0.5),
            # Two or three channels: one channel's cosine is +-1, and its
            # gradient (zero in exact arithmetic) is rounding noise.
            features=int(_pick(rng, (2, 3))) if point_reduction != "max"
            and rng.random() < 0.6 else 0,
            weights=_pick(rng, ("none", "random", "zero")) if rng.random() < 0.5 else "none",
        )
    elif family == "gather":
        p.update(S=int(rng.integers(1, 40)), grouped=bool(rng.random() < 0.5))
    elif family == "sample_pdf":
        p = {"B": int(rng.integers(1, 5)), "n_bins": int(rng.integers(1, 41)),
             "S": int(rng.integers(1, 51)), "det": bool(rng.random() < 0.5)}
    return p


def cases(count: int, first_seed: int = 0) -> list:
    """``count`` cases, the families in turn, case i from seed
    ``first_seed + i``."""
    out = []
    for i in range(count):
        family = FAMILIES[i % len(FAMILIES)]
        seed = first_seed + i
        params = _params(family, np.random.default_rng([seed, 0]))
        out.append(Case(family, seed, tuple(sorted(params.items(), key=lambda kv: kv[0]))))
    return out


# The chamfer reductions that ``chamfer_distance`` accepts, as
# (point_reduction, batch_reduction).
CHAMFER_REDUCTIONS = (("mean", "mean"), ("mean", "sum"), ("mean", None),
                      ("sum", "mean"), ("sum", "sum"), ("sum", None),
                      ("max", "mean"), ("max", "sum"), ("max", None), (None, None))


def _chamfer_params(N, P1, P2, i, point_reduction, batch_reduction, single,
                    weights, lengths="full") -> dict:
    return dict(N=N, P1=P1, P2=P2, D=3, grid=False, dup=False, lengths=lengths,
                norm=1 + i % 2, abs_cosine=i % 3 != 0,
                point_reduction=point_reduction, batch_reduction=batch_reduction,
                single_directional=single, weights=weights,
                features=0 if point_reduction == "max" else 2)


def _chamfer_expect(p) -> str:
    """A max reduction over a direction with no point raises in the JAX
    package (and in the port), unless all-zero weights return zero losses
    first; every other chamfer input returns."""
    empty = p["P1"] == 0 or (p["P2"] == 0 and not p["single_directional"])
    raises = (p["point_reduction"] == "max" and p["N"] and empty
              and p["weights"] != "zero")
    return "raises" if raises else "returns"


def empty_cases() -> list:
    """The directed empty cases: each ``Case`` with its inputs' shapes in
    ``params`` (``lengths`` "full" or "zero") and the JAX package's
    behaviour in ``expect``. Case i draws its values from seed i."""
    cloud = dict(D=3, grid=False, dup=False)
    specs = [
        # KNN: an empty y cloud in both norms (the forward, return_nn and
        # the backward), K past one 64-key round, K = 0, no query, every
        # length 0; N = 0 crashes a reshape in JAX.
        ("knn", "returns", dict(N=2, P1=5, P2=0, K=2, norm=2, lengths="full")),
        ("knn", "returns", dict(N=2, P1=5, P2=0, K=2, norm=1, lengths="full")),
        ("knn", "returns", dict(N=2, P1=5, P2=0, K=70, norm=2, lengths="full")),
        ("knn", "returns", dict(N=2, P1=5, P2=4, K=0, norm=2, lengths="full")),
        ("knn", "returns", dict(N=2, P1=0, P2=4, K=2, norm=1, lengths="full")),
        ("knn", "returns", dict(N=2, P1=5, P2=4, K=2, norm=2, lengths="zero")),
        ("knn", "crashes", dict(N=0, P1=5, P2=4, K=2, norm=2, lengths="full")),
        ("ball_query", "returns", dict(N=2, P1=5, P2=0, K=3, radius=1.0, lengths="full")),
        ("ball_query", "returns", dict(N=2, P1=5, P2=4, K=0, radius=1.0, lengths="full")),
        ("ball_query", "returns", dict(N=2, P1=0, P2=4, K=3, radius=1.0, lengths="full")),
        ("ball_query", "returns", dict(N=2, P1=5, P2=4, K=3, radius=1.0, lengths="zero")),
        ("ball_query", "crashes", dict(N=0, P1=5, P2=4, K=3, radius=1.0, lengths="full")),
        # The main FPS refuses N = 0 and P = 0 (JAX raises there); the naive
        # one returns.
        ("fps", "raises", dict(N=0, P=5, K=3, per_cloud_K=False, lengths="full")),
        ("fps", "raises", dict(N=2, P=0, K=3, per_cloud_K=False, lengths="full")),
        ("fps", "returns", dict(N=2, P=5, K=3, per_cloud_K=False, lengths="zero")),
        ("fps", "returns", dict(N=3, P=5, K=3, per_cloud_K=True, lengths="zero")),
        ("fps_naive", "returns", dict(N=0, P=5, K=3, per_cloud_K=False, lengths="full")),
        ("fps_naive", "returns", dict(N=2, P=0, K=3, per_cloud_K=False, lengths="full")),
        ("fps_naive", "returns", dict(N=2, P=5, K=3, per_cloud_K=False, lengths="zero")),
        ("masked_gather", "returns", dict(N=0, P=5, S=4, grouped=False)),
        ("masked_gather", "crashes", dict(N=0, P=5, S=4, P1=3, grouped=True)),
        ("masked_gather", "returns", dict(N=2, P=0, S=4, grouped=False)),
        ("masked_gather", "returns", dict(N=2, P=0, S=2, P1=4, grouped=True)),
        ("knn_gather", "returns", dict(N=2, M=0, U=3, L=5, K=3)),
        ("knn_gather", "returns", dict(N=2, M=4, U=3, L=5, K=0)),
        ("covariances", "returns", dict(N=2, P=5, K=0, lengths="full")),
        ("covariances", "returns", dict(N=2, P=0, K=2, lengths="full")),
        ("bounding_boxes", "raises", dict(N=2, P=0, lengths="full")),
    ]
    # The chamfer option matrix with y empty (features wherever the max
    # reduction allows them), then x empty, no cloud, and every length 0.
    chamfer = [_chamfer_params(2, 5, 0, i, pr, br, single, w)
               for i, ((pr, br), single, w) in enumerate(
                   (r, s, w) for r in CHAMFER_REDUCTIONS for s in (False, True)
                   for w in ("none", "random", "zero"))]
    chamfer += [_chamfer_params(2, 0, 5, i, pr, br, single, "random")
                for i, (pr, br, single) in enumerate((("mean", "mean", False),
                                                      (None, None, False),
                                                      ("sum", "mean", True),
                                                      ("max", "sum", False)))]
    # No features at N = 0: JAX's feature gather crashes there (integer
    # modulo by zero in a reshape).
    chamfer += [{**_chamfer_params(0, 5, 4, i, pr, br, False, "none"), "features": 0}
                for i, (pr, br) in enumerate((("mean", "mean"), ("max", None)))]
    chamfer += [_chamfer_params(2, 5, 4, i, pr, br, single, "random", "zero")
                for i, (pr, br, single) in enumerate((("mean", "mean", False),
                                                      ("max", "mean", False),
                                                      (None, None, True)))]
    specs += [("chamfer", _chamfer_expect(p), p) for p in chamfer]
    out = []
    for i, (family, expect, params) in enumerate(specs):
        params = {**cloud, **params} if family != "chamfer" else params
        if family in ("fps", "fps_naive"):
            params.setdefault("random_start", False)
        out.append(Case(family, i, tuple(sorted(params.items(), key=lambda kv: kv[0])),
                        expect))
    return out


def _points(rng, shape, grid: bool, dup: bool) -> np.ndarray:
    if grid:
        pts = rng.integers(-4, 5, size=shape).astype(np.float32) / 8.0
    else:
        pts = rng.normal(size=shape).astype(np.float32)
    if dup and shape[1] > 1:
        # Every point twice: the second half repeats the first.
        half = (shape[1] + 1) // 2
        pts[:, half:] = pts[:, : shape[1] - half]
    return pts


def _lengths(rng, N: int, P: int) -> np.ndarray:
    lengths = rng.integers(0, P + 1, size=N)
    lengths[rng.random(N) < 0.3] = P
    if rng.random() < 0.25:
        lengths[int(rng.integers(N))] = 0
    return lengths.astype(np.int64)


def _case_lengths(rng, p: dict, N: int, P: int) -> np.ndarray:
    """Drawn lengths, or every length ``P`` or 0 where ``p["lengths"]``
    says "full" or "zero" (the empty cases)."""
    if "lengths" not in p:
        return _lengths(rng, N, P)
    return np.full(N, P if p["lengths"] == "full" else 0, np.int64)


def inputs(case: Case) -> Dict[str, np.ndarray]:
    """The case's numpy inputs, drawn from its seed."""
    rng = np.random.default_rng([case.seed, 1])
    p = case.p
    f32 = np.float32
    if case.family in ("knn", "ball_query", "chamfer"):
        N, P1, P2, D = p["N"], p["P1"], p["P2"], p["D"]
        out = {
            "p1": _points(rng, (N, P1, D), p["grid"], p["dup"]),
            "p2": _points(rng, (N, P2, D), p["grid"], p["dup"]),
            "lengths1": _case_lengths(rng, p, N, P1),
            "lengths2": _case_lengths(rng, p, N, P2),
        }
        if case.family in ("knn", "ball_query"):
            out["g"] = rng.uniform(-1, 1, size=(N, P1, p["K"])).astype(f32)
        else:
            C = p["features"] or 2
            out["f1"] = rng.normal(size=(N, P1, C)).astype(f32)
            out["f2"] = rng.normal(size=(N, P2, C)).astype(f32)
            out["weights"] = {"none": None, "zero": np.zeros(N, f32),
                              "random": rng.uniform(0, 1, size=N).astype(f32)}[p["weights"]]
        return out
    if case.family in ("fps", "fps_naive"):
        N, P, D = p["N"], p["P"], p["D"]
        K = (rng.integers(0, P + 8, size=N).astype(np.int64) if p["per_cloud_K"]
             else np.int64(p["K"]))
        return {"points": _points(rng, (N, P, D), p["grid"], p["dup"]),
                "lengths": _case_lengths(rng, p, N, P), "K": K}
    if case.family == "masked_gather":
        N, P, D, S = p["N"], p["P"], p["D"], p["S"]
        shape = (N, p["P1"], S) if p["grouped"] else (N, S)
        return {"points": _points(rng, (N, P, D), False, False),
                "idx": rng.integers(-1, P, size=shape).astype(np.int64),
                "h": rng.uniform(-1, 1, size=(*shape, D)).astype(f32)}
    if case.family == "knn_gather":
        N, M, U, L, K = p["N"], p["M"], p["U"], p["L"], p["K"]
        return {"x": _points(rng, (N, M, U), False, False),
                "idx": rng.integers(0, max(M, 1), size=(N, L, K)).astype(np.int64),
                "h": rng.uniform(-1, 1, size=(N, L, K, U)).astype(f32)}
    if case.family in ("covariances", "bounding_boxes"):
        N, P, D = p["N"], p["P"], p["D"]
        return {"points": _points(rng, (N, P, D), False, False),
                "lengths": _case_lengths(rng, p, N, P),
                "h": rng.uniform(-1, 1, size=(N, P, D, D)).astype(f32),
                "h_nn": rng.uniform(-1, 1, size=(N, P, p.get("K", 0), D)).astype(f32)}
    if case.family == "gather":
        N, P, D, S = p["N"], p["P2"], p["D"], p["S"]
        shape = (N, p["P1"], S) if p["grouped"] else (N, S)
        idx = rng.integers(-1, P, size=shape).astype(np.int64)
        sizes = _lengths(rng, N, P)
        # Both packages reject an empty packed tensor (its rows' width is
        # unknown): keep one row.
        sizes[0] = max(sizes[0], 1)
        first = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        F, M = int(sizes.sum()), int(sizes.max())
        return {
            "points": _points(rng, (N, P, D), p["grid"], False),
            "idx": idx,
            "h": rng.uniform(-1, 1, size=(*shape, D)).astype(f32),
            "packed": rng.normal(size=(F, D)).astype(f32),
            "first_idxs": first,
            "max_size": np.int64(M),
            "h_padded": rng.uniform(-1, 1, size=(N, M, D)).astype(f32),
            "h_packed": rng.uniform(-1, 1, size=(F, D)).astype(f32),
        }
    B, n_bins, S = p["B"], p["n_bins"], p["S"]
    widths = rng.uniform(0.05, 1.0, size=(B, n_bins + 1)).astype(f32)
    return {"bins": np.cumsum(widths, axis=-1).astype(f32) - f32(5.0),
            "weights": rng.uniform(0.0, 1.0, size=(B, n_bins)).astype(f32)}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def chamfer_leaves(loss, loss_features) -> dict:
    """``chamfer_distance``'s outputs (a loss or a tuple of terms, and the
    feature losses) flattened into named arrays."""
    leaves = {}
    for i, t in enumerate(loss if isinstance(loss, tuple) else (loss,)):
        leaves[f"loss{i}"] = t
    for name, v in (loss_features or {}).items():
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            leaves[f"feature_{name}{i}"] = t
    return leaves


def run_case(case: Case, device) -> Dict[str, np.ndarray]:
    """The case through the port's public ops on ``device``; every output
    and gradient as a numpy array."""
    device = torch.device(device)
    x = inputs(case)
    p = case.p

    def T(a, grad=False):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t.requires_grad_(True) if grad else t

    if case.family == "knn":
        p1, p2 = T(x["p1"], True), T(x["p2"], True)
        l1, l2 = T(x["lengths1"]), T(x["lengths2"])
        res = knn_points(p1, p2, l1, l2, norm=p["norm"], K=p["K"], return_nn=True)
        (res.dists * T(x["g"])).sum().backward()
        uns = knn_points(p1.detach(), p2.detach(), l1, l2, norm=p["norm"], K=p["K"],
                         return_sorted=False)
        return {"dists": _np(res.dists), "idx": _np(res.idx), "nn": _np(res.knn),
                "unsorted_dists": _np(uns.dists), "unsorted_idx": _np(uns.idx),
                "grad_p1": _np(p1.grad), "grad_p2": _np(p2.grad)}
    if case.family == "ball_query":
        p1, p2 = T(x["p1"], True), T(x["p2"], True)
        res = ball_query(p1, p2, T(x["lengths1"]), T(x["lengths2"]), K=p["K"],
                         radius=p["radius"])
        (res.dists * T(x["g"])).sum().backward()
        return {"dists": _np(res.dists), "idx": _np(res.idx), "nn": _np(res.knn),
                "grad_p1": _np(p1.grad), "grad_p2": _np(p2.grad)}
    if case.family in ("fps", "fps_naive"):
        points = T(x["points"])
        K = int(x["K"]) if np.ndim(x["K"]) == 0 else T(x["K"])
        # The random starts come from a CPU generator, the same on every
        # device.
        gen = torch.Generator().manual_seed(case.seed) if p["random_start"] else None
        fps = sample_farthest_points if case.family == "fps" else sample_farthest_points_naive
        sel, idx = fps(points, T(x["lengths"]), K=K, random_start_point=p["random_start"],
                       generator=gen)
        return {"idx": _np(idx), "points": _np(sel)}
    if case.family in ("masked_gather", "knn_gather"):
        values = T(x["points" if case.family == "masked_gather" else "x"], True)
        gathered = (masked_gather(values, T(x["idx"])) if case.family == "masked_gather"
                    else knn_gather(values, T(x["idx"])))
        (gathered * T(x["h"])).sum().backward()
        return {"gathered": _np(gathered), "grad": _np(values.grad)}
    if case.family == "covariances":
        points = T(x["points"], True)
        cov, nn = get_point_covariances(points, T(x["lengths"]), p["K"])
        ((cov * T(x["h"])).sum() + (nn * T(x["h_nn"])).sum()).backward()
        return {"cov": _np(cov), "nn": _np(nn), "grad": _np(points.grad)}
    if case.family == "bounding_boxes":
        clouds = Pointclouds([T(x["points"][n, :length])
                              for n, length in enumerate(x["lengths"])])
        return {"boxes": _np(get_bounding_boxes(clouds))}
    if case.family == "chamfer":
        xs, ys = T(x["p1"], True), T(x["p2"], True)
        fx, fy = T(x["f1"], True), T(x["f2"], True)
        feats = bool(p["features"])
        loss, loss_f = chamfer_distance(
            xs, ys, T(x["lengths1"]), T(x["lengths2"]),
            x_features={"normals": fx} if feats else None,
            y_features={"normals": fy} if feats else None,
            weights=None if x["weights"] is None else T(x["weights"]),
            batch_reduction=p["batch_reduction"], point_reduction=p["point_reduction"],
            norm=p["norm"], single_directional=p["single_directional"],
            abs_cosine=p["abs_cosine"], feature_names=["normals"] if feats else None,
        )
        leaves = chamfer_leaves(loss, loss_f)
        total = sum((t * T(chamfer_cotangent(case, i, tuple(t.shape)))).sum()
                    for i, t in enumerate(leaves.values()))
        grads = torch.autograd.grad(total, [xs, ys, fx, fy], allow_unused=True)
        out = {k: _np(v) for k, v in leaves.items()}
        for name, g, like in zip(("grad_x", "grad_y", "grad_fx", "grad_fy"), grads,
                                 (xs, ys, fx, fy)):
            out[name] = _np(g if g is not None else torch.zeros_like(like))
        return out
    if case.family == "gather":
        points = T(x["points"], True)
        gathered = masked_gather(points, T(x["idx"]))
        (gathered * T(x["h"])).sum().backward()
        packed = T(x["packed"], True)
        first = T(x["first_idxs"])
        padded = packed_to_padded(packed, first, int(x["max_size"]))
        (padded * T(x["h_padded"])).sum().backward()
        padded_in = T(_np(padded), True)
        repacked = padded_to_packed(padded_in, first, x["packed"].shape[0])
        (repacked * T(x["h_packed"])).sum().backward()
        return {"gathered": _np(gathered), "grad_points": _np(points.grad),
                "padded": _np(padded), "grad_packed": _np(packed.grad),
                "repacked": _np(repacked), "grad_padded": _np(padded_in.grad)}
    gen = None if p["det"] else torch.Generator().manual_seed(case.seed)
    return {"samples": _np(sample_pdf(T(x["bins"]), T(x["weights"]), p["S"],
                                      det=p["det"], generator=gen))}


def chamfer_cotangent(case: Case, i: int, shape) -> np.ndarray:
    """The weights of the i-th chamfer output in the summed loss that the
    case differentiates: drawn from the case's seed."""
    rng = np.random.default_rng([case.seed, 2, i])
    return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)


def _fail(case, what: str):
    raise AssertionError(f"{case}: {what}")


def compare(case, got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
            what: str = "kernel vs plain twin", scaled: Dict[str, float] = None) -> float:
    """Integer and boolean outputs equal. A float output whose key starts
    with a prefix in ``scaled`` lies within that prefix's tolerance of its
    largest entry (the first prefix that matches counts); any other within
    ``TOL`` of each entry (relative past 1). ``scaled`` defaults to the
    gradients, ``{"grad": TOL}``. Entries that are not finite are equal,
    NaN to NaN. A failure names ``case`` (a ``Case`` or a label). Returns
    the largest absolute difference of a float output."""
    scaled = {"grad": TOL} if scaled is None else scaled
    if set(got) != set(want):
        _fail(case, f"{what}: outputs {sorted(got)} against {sorted(want)}")
    worst = 0.0
    for key, b in want.items():
        a = got[key]
        if a.shape != b.shape:
            _fail(case, f"{what}: {key} of shape {a.shape} against {b.shape}")
        if not np.issubdtype(b.dtype, np.floating):
            if not np.array_equal(a, b):
                bad = np.argwhere(a != b)[:3].tolist()
                _fail(case, f"{what}: {key} differ at {bad}")
            continue
        fin = np.isfinite(b)
        if not np.array_equal(fin, np.isfinite(a)) or not np.array_equal(
                a[~fin], b[~fin], equal_nan=True):
            _fail(case, f"{what}: {key} differ where they are not finite")
        if not fin.any():
            continue
        err = np.abs(a[fin].astype(np.float64) - b[fin])
        worst = max(worst, float(err.max()))
        tol = next((t for prefix, t in scaled.items() if key.startswith(prefix)), None)
        if tol is not None:
            scale = float(np.abs(b[fin]).max())
            if err.max() > tol * scale:
                _fail(case, f"{what}: {key} off by {err.max():.3g} (largest entry "
                            f"{scale:.3g}, tolerance {tol})")
        elif np.any(err > TOL * np.maximum(1.0, np.abs(b[fin]))):
            _fail(case, f"{what}: {key} off by {err.max():.3g}")
    return worst


def _near(a, b, tol=TOL):
    return np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))


def _close_call(a, b):
    """Distances near enough that another rounding may order them otherwise.
    Equal ones are no such pair: they come from duplicated points, which
    every implementation rounds alike and orders by index."""
    return _near(a, b) & (a != b)


def check_native(case: Case, out: Dict[str, np.ndarray]) -> bool:
    """Hold the outputs ``out`` of ``run_case`` against the host library on
    the same inputs, where it has the op. On grid clouds (exact distances)
    indices are equal and values within ``TOL``; on Gaussian clouds the
    library (compiled with contracted multiply-adds) may round a distance
    differently, so an index is held only where its distance stands more
    than ``TOL`` (relative) from its neighbours', the next one included.
    Returns whether the library has the case's op."""
    x = inputs(case)
    p = case.p
    if case.family == "knn":
        K = p["K"]
        d, i = (t.numpy() for t in native.knn_points(
            x["p1"], x["p2"], x["lengths1"], x["lengths2"], K=K + 1, norm=p["norm"]))
        if not np.all(_near(out["dists"], d[..., :K])):
            _fail(case, "native: knn dists")
        held = np.ones(out["idx"].shape, bool)
        if not p["grid"]:
            # The (K+1)-th distance counts only where the cloud has it.
            kv = np.minimum(K + 1, x["lengths2"])[:, None, None]
            nxt = np.where(np.arange(K + 1)[None, None] < kv, d, np.inf)
            left = np.concatenate([np.full_like(d[..., :1], -np.inf), d[..., :K]], -1)
            held = ~(_close_call(nxt[..., 1:], d[..., :K])
                     | _close_call(left[..., :K], d[..., :K]))
        if np.any((out["idx"] != i[..., :K]) & held):
            _fail(case, "native: knn idx")
        gp1, gp2 = native.knn_backward(x["p1"], x["p2"], out["idx"], x["g"],
                                       x["lengths1"], x["lengths2"], norm=p["norm"])
        compare(case, {"grad_p1": out["grad_p1"], "grad_p2": out["grad_p2"]},
                {"grad_p1": gp1.numpy(), "grad_p2": gp2.numpy()}, "native: knn backward")
        return True
    if case.family == "ball_query":
        d, i = (t.numpy() for t in native.ball_query(
            x["p1"], x["p2"], x["lengths1"], x["lengths2"], K=p["K"], radius=p["radius"]))
        held = np.ones(out["idx"].shape[:2], bool)
        if not p["grid"]:
            # A query is held where no candidate lies within TOL of r^2.
            diff = x["p1"][:, :, None].astype(np.float64) - x["p2"][:, None]
            d2 = (diff * diff).sum(-1)
            valid = np.arange(x["p2"].shape[1])[None, None] < x["lengths2"][:, None, None]
            r2 = p["radius"] ** 2
            held = ~np.any(valid & (np.abs(d2 - r2) <= TOL * r2), axis=-1)
        if np.any((out["idx"] != i)[held]) or not np.all(_near(out["dists"], d)[held]):
            _fail(case, "native: ball query")
        gp1, gp2 = native.knn_backward(x["p1"], x["p2"], out["idx"], x["g"],
                                       x["lengths1"], x["lengths2"], norm=2)
        if held.all():
            compare(case, {"grad_p1": out["grad_p1"], "grad_p2": out["grad_p2"]},
                    {"grad_p1": gp1.numpy(), "grad_p2": gp2.numpy()},
                    "native: ball query backward")
        return True
    if case.family == "fps":
        idx = out["idx"]
        # A cloud's start is its first index (none where it samples nothing).
        starts = np.maximum(idx[:, 0], 0) if idx.shape[1] else np.zeros(len(idx), np.int64)
        ref = native.sample_farthest_points(x["points"], x["lengths"], x["K"],
                                            starts).numpy()
        held = np.ones(idx.shape, bool)
        if not p["grid"]:
            held = _fps_unambiguous(x["points"], x["lengths"], idx)
        if np.any((idx != ref) & held):
            _fail(case, "native: fps idx")
        return True
    if case.family == "gather":
        pad = native.packed_to_padded(x["packed"], x["first_idxs"], int(x["max_size"]))
        back = native.padded_to_packed(out["padded"], x["first_idxs"], x["packed"].shape[0])
        compare(case, {"padded": out["padded"], "repacked": out["repacked"]},
                {"padded": pad.numpy(), "repacked": back.numpy()}, "native: packed/padded")
        return True
    if case.family == "sample_pdf" and p["det"]:
        u = np.broadcast_to(np.linspace(0.0, 1.0, p["S"], dtype=np.float32),
                            (p["B"], p["S"]))
        ref = native.sample_pdf(x["bins"], x["weights"], u).numpy()
        compare(case, {"samples": out["samples"]}, {"samples": ref}, "native: sample_pdf")
        return True
    return False


def _fps_unambiguous(points, lengths, idx) -> np.ndarray:
    """Where a library with other rounding must pick the same index: each
    cloud's selections up to the first round whose farthest point stands
    within ``TOL`` (relative) of the runner-up, distances in float64 along
    ``idx``'s own selections."""
    held = np.zeros(idx.shape, bool)
    for n in range(idx.shape[0]):
        L = int(lengths[n])
        k_n = int((idx[n] >= 0).sum())
        if k_n == 0:
            continue
        pts = points[n, :L].astype(np.float64)
        held[n, 0] = True
        min_d = np.full(L, np.inf)
        for k in range(1, k_n):
            min_d = np.minimum(min_d, ((pts - pts[idx[n, k - 1]]) ** 2).sum(-1))
            best = min_d.max()
            rest = min_d[min_d < best]  # duplicates of the farthest point tie exactly
            if rest.size and best - rest.max() <= TOL * max(best, 1.0):
                break
            held[n, k] = True
        held[n, k_n:] = True  # the -1 pads are held in full
    return held
