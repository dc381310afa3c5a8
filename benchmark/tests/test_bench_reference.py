"""The plain references against brute force at tiny sizes."""

import importlib.util
import os

import pytest
import torch

from benchmark import clouds, harness, plain


def ref(name):
    return harness.load_module(harness.BENCH_DIR, "reference", name)


def brute_knn(p1, p2, l1, l2, w, K):
    """Float64 brute force: every pair, a stable sort by distance (lowest
    index first on ties), then the gradients by their formulas."""
    N, P1, _ = p1.shape
    idx = torch.zeros((N, P1, K), dtype=torch.int64)
    dists = torch.zeros((N, P1, K), dtype=torch.float64)
    g1, g2 = torch.zeros(p1.shape, dtype=torch.float64), torch.zeros(p2.shape, dtype=torch.float64)
    for n in range(N):
        x, y = p1[n, :l1[n]].double(), p2[n, :l2[n]].double()
        d = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
        k = min(K, l2[n])
        order = torch.sort(d, dim=1, stable=True).indices[:, :k]
        idx[n, :l1[n], :k] = order
        dists[n, :l1[n], :k] = torch.gather(d, 1, order)
        for q in range(l1[n]):
            for j in range(k):
                diff = 2 * w[n, q, j].double() * (x[q] - y[order[q, j]])
                g1[n, q] += diff
                g2[n, order[q, j]] -= diff
    return idx, dists, g1, g2


@pytest.mark.parametrize("K", [1, 4, 9])
def test_knn_reference_matches_brute_force(K):
    dev, host = clouds.generators(11, "cpu")
    p1, l1 = clouds.cloud({"batch": 2, "points": 30, "lengths": [30, 17]}, dev, "cpu")
    p2, l2 = clouds.cloud({"batch": 2, "points": 40, "lengths": [40, 7]}, dev, "cpu")
    p2[0, 5] = p2[0, 2]  # a duplicated point: the lower index comes first
    w = torch.rand((2, 30, K), generator=dev)
    got = ref("knn_l2").answers(p1, p2, l1, l2, w, K)
    idx, dists, g1, g2 = brute_knn(p1, p2, l1, l2, w, K)
    assert torch.equal(got["idx"], idx)
    assert torch.allclose(got["dists"].double(), dists, rtol=1e-5, atol=1e-6)
    assert torch.allclose(got["grad1"].double(), g1, rtol=1e-5, atol=1e-5)
    assert torch.allclose(got["grad2"].double(), g2, rtol=1e-5, atol=1e-5)
    assert got["loss"] == pytest.approx(float((w.double() * dists).sum()), rel=1e-5)


def brute_chamfer(x, lx, fx, y, ly, fy, names):
    """Float64 loops: (loss, {name: loss}) of the mean/mean bidirectional
    chamfer with 1 - |cos| feature terms."""
    loss, feats = 0.0, {n: 0.0 for n in names}
    for c in range(len(lx)):
        for a, la, fa, b, lb, fb in ((x, lx, fx, y, ly, fy), (y, ly, fy, x, lx, fx)):
            s, fs = 0.0, {n: 0.0 for n in names}
            for i in range(la[c]):
                d = ((a[c, i].double() - b[c, :lb[c]].double()) ** 2).sum(-1)
                j = int(torch.argmin(d))
                s += float(d[j])
                for n in names:
                    u, v = fa[n][c, i].double(), fb[n][c, j].double()
                    cos = float((u * v).sum() / max(float(u.norm() * v.norm()), 1e-6))
                    fs[n] += 1 - abs(cos)
            loss += s / la[c]
            for n in names:
                feats[n] += fs[n] / la[c]
    N = len(lx)
    return loss / N, {n: v / N for n, v in feats.items()}


def chamfer_inputs(seed):
    dev, host = clouds.generators(seed, "cpu")
    pipe = harness.load_module(harness.BENCH_DIR, "pipelines", "chamfer_nc")
    src = {"batch": 2, "points": 25, "lengths": [25, 19], "scale": 1.5}
    tgt = {"batch": 2, "points": 25, "lengths": [22, 25]}
    return pipe.make_inputs({"pool": 4, "lr_per_point": 0.2, "source": src, "target": tgt,
                             "features": {"normals": "unit_gaussian", "colors": "uniform"}},
                            dev, host, "cpu")


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_chamfer_reference_matches_brute_force(seed):
    inputs = chamfer_inputs(seed)
    s, names = inputs["source"], inputs["feature_names"]
    out = ref("chamfer_nc").follow(inputs, 2)
    p = s["points"]
    for k, p_k in enumerate((p, out["p1"])):
        t = inputs["targets"][k]
        loss, feats = brute_chamfer(p_k, s["lengths"], s["features"], t["points"],
                                    t["lengths"], t["features"], names)
        assert out["losses"][k] == pytest.approx([loss, *(feats[n] for n in names)], rel=1e-5)
    # the first gradient, by autograd of a float64 chamfer on the same pairs
    x = p.double().clone().requires_grad_(True)
    t = inputs["targets"][0]
    total = 0.0
    for c in range(2):
        a, b = x[c, :s["lengths"][c]], t["points"][c, :t["lengths"][c]].double()
        d = ((a[:, None] - b[None]) ** 2).sum(-1)
        total = total + (d.min(1).values.mean() + d.min(0).values.mean()) / 2
    total.backward()
    assert torch.allclose(out["grad0"].double(), x.grad, rtol=1e-5, atol=1e-8)
    assert torch.allclose(out["p1"], p - inputs["lr"] * out["grad0"])


def test_tf32_rounding():
    exact = torch.tensor([1.0, -1.5, 1 + 2**-10, 0.0])
    assert torch.equal(plain.tf32_round(exact), exact)
    # 1 + 2^-11 is halfway: to even (1); 1 + 3 * 2^-11 is halfway: up to 1 + 2^-9
    tie = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11 + 2**-20)])
    assert torch.equal(plain.tf32_round(tie), torch.tensor([1.0, 1 + 2**-9, -(1 + 2**-10)]))


def test_references_import_nothing_of_the_port():
    for name in ("knn_l2", "chamfer_nc"):
        path = os.path.join(harness.BENCH_DIR, "reference", f"{name}.py")
        src = open(path).read()
        assert "pytorch3d_pointops_tpu" not in src and "jax" not in src
        spec = importlib.util.spec_from_file_location("r", path)
        assert spec is not None
    assert "pytorch3d_pointops_tpu" not in open(plain.__file__).read()
