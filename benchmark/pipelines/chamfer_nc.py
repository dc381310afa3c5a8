"""``chamfer_nc``: a training loop on the chamfer loss with normal and colour
terms (BASELINE config 3; the reference's ``examples/chamfer_loss.py``).

A step: ``Pointclouds.update_padded(points)``, ``chamfer_distance`` with
``feature_names=["normals", "colors"]`` and the configuration's options,
``(loss + lf["normals"] + lf["colors"]).backward()``, ``points -= lr *
grad``, and the loss read to the host. The points being fitted start from
the source cloud; step j fits them to target ``j % entries`` of a pool of
distinct targets, and every pass over the pool starts again from the
source, so a long window cannot walk the points onto the targets (the
kernels' early exits would then do less work late than early) and every
pass repeats the first bit for bit.

The check follows the contract's training rule: the reference follows the
first pass (set-up) from the same inputs, and each step's three loss terms,
the norm of the first gradient (from the points after one step) and the
norm of the points' change after three steps are compared; every window
step's loss must equal its pass position's in the first pass.

Traffic keys: ``pool``, ``lr_per_point`` (lr = it x N x P, as the mean over
points and clouds scales the gradient by 1 / (N x length)), ``source``
and ``target`` (cloud specs of ``clouds.py``), ``features`` (name: kind).
"""

from __future__ import annotations

import torch

from benchmark import clouds, faults, work


def make_inputs(traffic: dict, dev, host, device) -> dict:
    m, feats = traffic["pool"], traffic["features"]
    src_spec, tgt_spec = traffic["source"], traffic["target"]
    n, p = src_spec["batch"], src_spec["points"]
    src, src_len = clouds.cloud(src_spec, dev, device)
    source = {"points": src, "lengths": src_len,
              "features": clouds.features(feats, n, p, src_len, dev, device)}
    targets = []
    for _ in range(m):
        pts, lens = clouds.cloud(tgt_spec, dev, device)
        targets.append({"points": pts, "lengths": lens, "features": clouds.features(
            feats, n, pts.shape[1], lens, dev, device)})
    return {"source": source, "targets": targets, "feature_names": list(feats),
            "lr": traffic["lr_per_point"] * n * p}


def _pointclouds(port, cloud: dict):
    lengths = torch.tensor(cloud["lengths"], device=cloud["points"].device)
    return port.Pointclouds(points=cloud["points"], lengths=lengths,
                            features=cloud["features"])


class Step:
    def __init__(self, port, inputs: dict, options: dict):
        self.port, self.options = port, options
        self.names, self.lr = inputs["feature_names"], inputs["lr"]
        self.source = _pointclouds(port, inputs["source"])
        self.targets = [_pointclouds(port, t) for t in inputs["targets"]]
        self.entries = len(self.targets)
        self.p0 = inputs["source"]["points"]
        self.p = self.p0.clone().requires_grad_(True)
        self.first = {"losses": []}  # what the first pass leaves for the check

    def __call__(self, j: int, span) -> float:
        i = j % self.entries
        if i == 0:
            with torch.no_grad():
                self.p.copy_(self.p0)
        with span("port.fwd"):
            src = self.source.update_padded(self.p)
            loss, lf = self.port.chamfer_distance(
                src, self.targets[i], feature_names=self.names, **self.options)
        with span("user.loss"):
            total = loss
            for name in self.names:
                total = total + lf[name]
        with span("port.bwd"):
            total.backward()
        with span("user.update"):
            with torch.no_grad():
                self.p -= self.lr * self.p.grad
            self.p.grad = None
        with span("read"):
            value = total.item()
        if j < self.entries:
            self.first["losses"].append([loss.item(), *(lf[n].item() for n in self.names)])
            if j in (0, 2):
                self.first[f"p{j + 1}"] = self.p.detach().clone()
        return value


def work_counts(inputs: dict, options: dict) -> dict:
    """Work of the forward and backward spans, for the roofline metrics."""
    del options
    src = inputs["source"]
    t = inputs["targets"][0]
    channels = sum(f.shape[-1] for f in src["features"].values())
    return {
        "chamfer_fwd": {"span": "port.fwd", **work.chamfer_forward(
            src["lengths"], t["lengths"], src["points"].shape[-1], channels)},
        "bwd": {"span": "port.bwd", **work.chamfer_backward(
            src["lengths"], t["lengths"], src["points"].shape[-1])},
    }


def readings(p0, lr: float, losses, p1, p3) -> dict:
    """What is compared of a run of the loop: the loss terms of each step,
    the first gradient worked out from the points after one step, and the
    change of the points after three."""
    p0 = p0.double()
    return {"losses": losses, "grad0": (p0 - p1.double()) / lr, "delta3": p3.double() - p0}


def _norm_gap(a, b) -> float:
    na, nb = float(a.norm()), float(b.norm())
    return abs(na - nb) / nb


def compare(got: dict, ref: dict) -> dict:
    loss_gap = max(abs(g - r) / abs(r)
                   for gs, rs in zip(got["losses"], ref["losses"], strict=True)
                   for g, r in zip(gs, rs, strict=True))
    return {"loss_gap": loss_gap,
            "grad_norm_gap": _norm_gap(got["grad0"], ref["grad0"]),
            "change_norm_gap": _norm_gap(got["delta3"], ref["delta3"])}


def reference_readings(ref, inputs: dict, steps: int, tf32: bool = False) -> dict:
    out = ref.follow(inputs, steps, tf32)
    p0 = inputs["source"]["points"]
    if tf32:  # the control stands in the program's place
        return readings(p0, inputs["lr"], out["losses"], out["p1"], out["p3"])
    return {"losses": out["losses"], "grad0": out["grad0"].double(),
            "delta3": out["p3"].double() - p0.double()}


def check(step: Step, inputs: dict, ref, first_losses, host) -> dict:
    del first_losses, host  # every pass repeats the first; the harness holds the window to it
    got = readings(step.p0, step.lr, step.first["losses"], step.first["p1"],
                   step.first["p3"])
    return compare(got, reference_readings(ref, inputs, step.entries))



def control(inputs: dict, ref, host) -> dict:
    """The numbers the control reads: the reference in TF32 in the
    program's place."""
    del host
    steps = len(inputs["targets"])
    return compare(reference_readings(ref, inputs, steps, tf32=True),
                   reference_readings(ref, inputs, steps))


FAULTS = ("stale_state", "half_batch", "altered_answer")


def plant(name: str, port):
    """Break the timed path with fault ``name`` (``faults.py``):
    ``stale_state`` zeroes the chamfer backward's gradient, so SGD leaves
    the points where they were; ``half_batch`` scores the first half of the
    clouds alone; ``altered_answer`` adds 1 to one nearest distance where
    the chamfer kernel returns it."""
    if name == "stale_state":
        def zero(p1, p2, *_args):
            return torch.zeros_like(p1), torch.zeros_like(p2)
        return faults.patched(faults.module(port, "ops.chamfer"), "_k1_backward", zero)
    if name == "half_batch":
        real = port.chamfer_distance

        def chamfer_distance(x, y, **kw):
            h = len(x) // 2
            return real(x.points_padded()[:h], y.points_padded()[:h],
                        x_lengths=x.num_points_per_cloud()[:h],
                        y_lengths=y.num_points_per_cloud()[:h],
                        x_features={k: v[:h] for k, v in x.features_padded().items()},
                        y_features={k: v[:h] for k, v in y.features_padded().items()}, **kw)
        return faults.patched(port, "chamfer_distance", chamfer_distance)
    if name == "altered_answer":
        kernels = faults.module(port, "kernels.chamfer")
        real = kernels.chamfer_nn_bidirectional

        def chamfer_nn_bidirectional(*args):
            d1, i1, d2, i2 = real(*args)
            d1 = d1.clone()
            d1[0, 0] += 1.0
            return d1, i1, d2, i2
        return faults.patched(kernels, "chamfer_nn_bidirectional", chamfer_nn_bidirectional)
    raise ValueError(f"chamfer_nc cells cannot have fault {name!r}")
