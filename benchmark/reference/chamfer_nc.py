"""Plain reference of the ``chamfer_nc`` pipeline: a chamfer loss with
normal and colour terms, and the SGD steps of a training loop on it.

Plain ``torch`` only; it imports nothing of the port. Both directions,
``point_reduction="mean"``, ``batch_reduction="mean"``, squared L2,
``abs_cosine``: for each valid point of x its nearest valid point of y (on
equal distances the lowest index), the squared distance summed axis by axis
as ``(dx*dx + dy*dy) + dz*dz``, and ``1 - |cos|`` between the two points'
features (the product of the norms clamped at 1e-6); each cloud's terms
averaged over its length, the clouds averaged, the two directions added.

``follow`` runs the loop from the benchmark's inputs: step k takes target
``k``, its loss ``cham + normals + colors``, its gradient by autograd, and
``p -= lr * grad``. TF32 is off. With ``tf32=True`` it is the control: the
nearest points are chosen, and their distances taken, from
``|x|^2 + |y|^2 - 2 x.y`` with x and y rounded to TF32 (10-bit mantissa,
round to nearest even), the step a tensor-core distance matrix would take;
the gradient keeps the plain formula 2 (x - y).
"""

from __future__ import annotations

import torch

from benchmark.plain import key_of, sq_dist, tf32_dist

BLOCK = 2048  # query rows a block


def nearest(x: torch.Tensor, y: torch.Tensor, tf32: bool = False):
    """For each row of x (Px, D), the index of its nearest row of y (Py, D)
    and, with ``tf32``, that distance as the control computes it."""
    idx, dist = [], []
    iy = torch.arange(y.shape[0], device=x.device, dtype=torch.int64)
    for s in range(0, x.shape[0], BLOCK):
        xb = x[s:s + BLOCK]
        if tf32:
            d = tf32_dist(xb, y)
            v, i = d.min(dim=1)
            idx.append(i)
            dist.append(v)
        else:
            key = key_of(sq_dist(xb[:, None, :], y[None, :, :]), iy[None, :])
            idx.append(key.min(dim=1).values & 0xFFFFFFFF)
    return torch.cat(idx), (torch.cat(dist) if tf32 else None)


def _cos(a, b, eps=1e-6):
    dot = (a * b).sum(-1)
    return dot / torch.clamp(torch.sqrt((a * a).sum(-1)) * torch.sqrt((b * b).sum(-1)),
                             min=eps)


def _direction(x, y, fx, fy, names, tf32):
    """Mean distance term and mean feature terms of one cloud's x -> y."""
    with torch.no_grad():
        i, d_ctl = nearest(x.detach(), y.detach(), tf32)
    yn = y[i]
    d = sq_dist(x, yn)
    if tf32:
        d = d_ctl + (d - d.detach())
    feats = {n: (1.0 - _cos(fx[n], fy[n][i]).abs()).mean() for n in names}
    return d.mean(), feats


def chamfer(x, lx, fx, y, ly, fy, names, tf32=False):
    """(loss, {name: loss}) for padded x (N, P, D) against y, lengths as
    host ints, features as dicts of padded tensors."""
    if min(lx) < 1 or min(ly) < 1:
        raise ValueError("the reference needs every cloud non-empty")
    n = len(lx)
    loss, feat = 0.0, {name: 0.0 for name in names}
    for c in range(n):
        xc, yc = x[c, :lx[c]], y[c, :ly[c]]
        fxc = {name: fx[name][c, :lx[c]] for name in names}
        fyc = {name: fy[name][c, :ly[c]] for name in names}
        dx, fxy = _direction(xc, yc, fxc, fyc, names, tf32)
        dy, fyx = _direction(yc, xc, fyc, fxc, names, tf32)
        loss = loss + dx + dy
        for name in names:
            feat[name] = feat[name] + fxy[name] + fyx[name]
    return loss / n, {name: v / n for name, v in feat.items()}


def follow(inputs: dict, steps: int, tf32: bool = False) -> dict:
    """The first ``steps`` steps of the loop: each step's [loss, *feature
    losses], the first gradient, and the points after one and after three
    steps."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        src, names, lr = inputs["source"], inputs["feature_names"], inputs["lr"]
        p = src["points"].detach().clone()
        out = {"losses": []}
        for k in range(steps):
            tgt = inputs["targets"][k % len(inputs["targets"])]
            x = p.clone().requires_grad_(True)
            loss, feats = chamfer(x, src["lengths"], src["features"], tgt["points"],
                                  tgt["lengths"], tgt["features"], names, tf32)
            total = loss
            for name in names:
                total = total + feats[name]
            total.backward()
            out["losses"].append([loss.item(), *(feats[n].item() for n in names)])
            if k == 0:
                out["grad0"] = x.grad.detach().clone()
            p = (x - lr * x.grad).detach()
            if k == 0:
                out["p1"] = p.clone()
            if k == 2:
                out["p3"] = p.clone()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
