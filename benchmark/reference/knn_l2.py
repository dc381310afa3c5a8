"""Plain reference of the ``knn_l2`` pipeline: K nearest neighbours in
squared L2, sorted, and the gradients of a weighted sum of their distances.

Plain ``torch`` only; it imports nothing of the port. For each valid query
its K nearest valid points in ascending (distance, index) order, so on
equal distances the lowest index wins; the squared distance summed axis by
axis as ``(dx*dx + dy*dy) + dz*dz``. Slots past a cloud's length, and rows
past the queries' length, hold distance 0 and index 0, as the port pads.
The selection runs in blocks of query rows on an int64 key (the distance's
float32 bits, then the index), so ties are exact; the distances of the
chosen pairs are then taken again by autograd-visible gathers, and
``answers`` returns both gradients of ``sum(w * dists)``. TF32 is off.

With ``tf32=True`` it is the control: neighbours are chosen, and their
distances taken, from ``|x|^2 + |y|^2 - 2 x.y`` with x and y rounded to TF32
(10-bit mantissa, round to nearest even), the step a tensor-core distance
matrix would take; the gradients keep the plain formula.
"""

from __future__ import annotations

import torch

from benchmark.plain import key_of, sq_dist, tf32_dist

BLOCK = 1024  # query rows a block


def topk(q: torch.Tensor, p: torch.Tensor, k: int, tf32: bool = False):
    """(idx (Q, k), control distances (Q, k) or None) of the k nearest rows
    of p (P, D) to each row of q (Q, D), k <= P."""
    idx, dist = [], []
    ip = torch.arange(p.shape[0], device=q.device, dtype=torch.int64)
    for s in range(0, q.shape[0], BLOCK):
        qb = q[s:s + BLOCK]
        if tf32:
            v, i = torch.topk(tf32_dist(qb, p), k, dim=1, largest=False, sorted=True)
            idx.append(i)
            dist.append(v)
        else:
            key = key_of(sq_dist(qb[:, None, :], p[None, :, :]), ip[None, :])
            v = torch.topk(key, k, dim=1, largest=False, sorted=True).values
            idx.append(v & 0xFFFFFFFF)
    return torch.cat(idx), (torch.cat(dist) if tf32 else None)


def answers(p1, p2, lengths1, lengths2, w, K: int, tf32: bool = False) -> dict:
    """idx (N, P1, K), dists, the gradients of ``sum(w * dists)`` with
    respect to p1 and p2, and that loss, for padded clouds with host-int
    lengths."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        N, P1, D = p1.shape
        x = p1.detach().clone().requires_grad_(True)
        y = p2.detach().clone().requires_grad_(True)
        idx = torch.zeros((N, P1, K), dtype=torch.int64, device=p1.device)
        rows = []
        for n in range(N):
            l1, l2 = lengths1[n], lengths2[n]
            k = min(K, l2)
            if l1 == 0 or k == 0:
                rows.append(p1.new_zeros((P1, K)))
                continue
            with torch.no_grad():
                i, d_ctl = topk(x[n, :l1].detach(), y[n, :l2].detach(), k, tf32)
            d = sq_dist(x[n, :l1, None, :], y[n][i])
            if tf32:
                d = d_ctl + (d - d.detach())
            idx[n, :l1, :k] = i
            rows.append(torch.nn.functional.pad(d, (0, K - k, 0, P1 - l1)))
        dists = torch.stack(rows)
        loss = (w * dists).sum()
        loss.backward()
        return {"idx": idx, "dists": dists.detach(), "grad1": x.grad, "grad2": y.grad,
                "loss": loss.item()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
