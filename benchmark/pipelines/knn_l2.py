"""``knn_l2``: ``knn_points`` forward and backward in squared L2, sorted,
without ``return_nn`` (the project's north star, BASELINE's "KNN
query-points/s/chip (N=100k, K=16)"; the reference's
``examples/knn_on_pointclouds.py``).

A step: ``knn_points(p1, p2, K=K)`` with the configuration's options (and
the lengths, where a cloud is shorter than its padding), the loss
``sum(w * dists)`` with seeded weights w in [0, 1) so both gradients are
dense, its backward, and the loss read to the host. Step j takes entry
``j % entries`` of a pool of distinct (p1, p2, w); its outputs are kept
until that entry's next step.

The check compares answers one by one: for entries drawn from the seed
(``check_entries`` of them), the kept outputs of the entry's last window
step against the plain reference: indices equal, and the largest gaps of
the distances and of both gradients, each over the reference's largest
magnitude; and the entry's loss. Every window step's loss must equal its
entry's first one.

Traffic keys: ``pool``, ``K``, ``queries`` and ``points`` (cloud specs of
``clouds.py``), ``check_entries``.
"""

from __future__ import annotations

import torch

from benchmark import clouds, faults, work


def make_inputs(traffic: dict, dev, host, device) -> dict:
    K, entries = traffic["K"], []
    for _ in range(traffic["pool"]):
        p1, l1 = clouds.cloud(traffic["queries"], dev, device)
        p2, l2 = clouds.cloud(traffic["points"], dev, device)
        w = torch.rand((p1.shape[0], p1.shape[1], K), generator=dev, device=device)
        entries.append({"p1": p1, "p2": p2, "lengths1": l1, "lengths2": l2, "w": w})
    return {"entries": entries, "K": K, "check_entries": traffic["check_entries"]}


def _lengths(lengths: list, padded: int, device):
    if all(n == padded for n in lengths):
        return None
    return torch.tensor(lengths, device=device)


class Step:
    def __init__(self, port, inputs: dict, options: dict):
        self.port, self.options, self.K = port, options, inputs["K"]
        self.leaves = []
        for e in inputs["entries"]:
            dev = e["p1"].device
            self.leaves.append((
                e["p1"].clone().requires_grad_(True), e["p2"].clone().requires_grad_(True),
                e["w"], _lengths(e["lengths1"], e["p1"].shape[1], dev),
                _lengths(e["lengths2"], e["p2"].shape[1], dev)))
        self.entries = len(self.leaves)
        self.kept = [None] * self.entries  # (idx, dists, grad p1, grad p2) of each entry's last step

    def __call__(self, j: int, span) -> float:
        i = j % self.entries
        p1, p2, w, l1, l2 = self.leaves[i]
        with span("port.fwd"):
            out = self.port.knn_points(p1, p2, lengths1=l1, lengths2=l2, K=self.K,
                                       **self.options)
        with span("user.loss"):
            loss = (w * out.dists).sum()
        with span("port.bwd"):
            loss.backward()
        with span("read"):
            value = loss.item()
        self.kept[i] = (out.idx, out.dists.detach(), p1.grad, p2.grad)
        p1.grad = p2.grad = None
        return value


def work_counts(inputs: dict, options: dict) -> dict:
    """Work of the forward and backward spans, for the roofline metrics
    (every entry has the same lengths)."""
    del options
    e, K = inputs["entries"][0], inputs["K"]
    dim = e["p1"].shape[-1]
    return {"knn_fwd": {"span": "port.fwd",
                        **work.knn_forward(e["lengths1"], e["lengths2"], dim, K)},
            "bwd": {"span": "port.bwd",
                    **work.knn_backward(e["lengths1"], e["lengths2"], dim, K)}}


def _gap(got, ref) -> float:
    scale = float(ref.abs().max())
    return float((got.double() - ref.double()).abs().max()) / scale if scale else float(
        (got != ref).any())


def compare(got: dict, ref: dict) -> dict:
    """Numbers of one entry: ``got`` and ``ref`` hold idx, dists, grad1,
    grad2 and loss."""
    return {"idx_mismatch": int((got["idx"] != ref["idx"]).sum()),
            "dists_gap": _gap(got["dists"], ref["dists"]),
            "grad1_gap": _gap(got["grad1"], ref["grad1"]),
            "grad2_gap": _gap(got["grad2"], ref["grad2"]),
            "loss_gap": abs(got["loss"] - ref["loss"]) / abs(ref["loss"])}


def worst(per_entry: list) -> dict:
    return {k: (sum if k == "idx_mismatch" else max)(d[k] for d in per_entry)
            for k in per_entry[0]}


def chosen_entries(inputs: dict, host) -> list:
    n = len(inputs["entries"])
    return torch.randperm(n, generator=host)[:inputs["check_entries"]].tolist()


def reference_answers(ref, inputs: dict, i: int, tf32: bool = False) -> dict:
    e = inputs["entries"][i]
    return ref.answers(e["p1"], e["p2"], e["lengths1"], e["lengths2"], e["w"],
                       inputs["K"], tf32)


def check(step: Step, inputs: dict, ref, first_losses, host) -> dict:
    per_entry = []
    for i in chosen_entries(inputs, host):
        idx, dists, g1, g2 = step.kept[i]
        got = {"idx": idx, "dists": dists, "grad1": g1, "grad2": g2,
               "loss": first_losses[i]}
        per_entry.append(compare(got, reference_answers(ref, inputs, i)))
    return worst(per_entry)


def control(inputs: dict, ref, host) -> dict:
    """The numbers the control reads: the reference in TF32 in the
    program's place, on the entries the check would draw."""
    return worst([compare(reference_answers(ref, inputs, i, tf32=True),
                          reference_answers(ref, inputs, i))
                  for i in chosen_entries(inputs, host)])


FAULTS = ("half_batch", "altered_answer")  # a query step keeps no state


def plant(name: str, port):
    """Break the timed path with fault ``name`` (``faults.py``):
    ``half_batch`` answers the first half of the queries (the batch is one
    cloud) and leaves the rest as pads; ``altered_answer`` moves one
    neighbour index to the next point where the KNN kernel returns it."""
    if name == "half_batch":
        real = port.knn_points

        def knn_points(p1, p2, lengths1=None, lengths2=None, K=1, **kw):
            P1 = p1.shape[1]
            h = P1 // 2
            l1 = None if lengths1 is None else lengths1.clamp(max=h)
            out = real(p1[:, :h], p2, lengths1=l1, lengths2=lengths2, K=K, **kw)
            pad = (0, 0, 0, P1 - h)
            return out._replace(dists=torch.nn.functional.pad(out.dists, pad),
                                idx=torch.nn.functional.pad(out.idx, pad))
        return faults.patched(port, "knn_points", knn_points)
    if name == "altered_answer":
        kernels = faults.module(port, "kernels.knn")
        real = kernels.knn_topk

        def knn_topk(p1, p2, lengths2, K, norm, **kw):
            vals, idx = real(p1, p2, lengths2, K, norm, **kw)
            idx = idx.clone()
            idx[0, 0, 0] = (idx[0, 0, 0] + 1) % p2.shape[1]
            return vals, idx
        return faults.patched(kernels, "knn_topk", knn_topk)
    raise ValueError(f"knn_l2 cells cannot have fault {name!r}")
