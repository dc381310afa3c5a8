"""The ``point_transformer_v2_seg`` configuration at a size a test run holds:
a tiny cell of its own (the network at a small preset, two rooms of 3,000
and 2,100 points at a low density, a pool of 2) reads ``correct``, the TF32
control fails a limit, each planted fault reads incorrect, the configuration
holds Pointcept's published sizes (the pipeline's, the reference's ``Arch``
and the port's defaults), the generated scenes keep to their traffic, the
counts are the network's, and ``grid_pool_roofline`` reads the segment
kernels alone."""

import inspect
import json
import os
import time

import pytest
import torch

from benchmark import clouds, harness, trace

CELL = "point_transformer_v2_seg.tiny"
TINY = {"config": "point_transformer_v2_seg", "chips": 1, "why": "tiny", "traffic": {
    "pool": 2, "lr": 0.005, "weight_decay": 0.02, "classes": 20,
    "clouds": {"batch": 2, "points": 3000, "lengths": [3000, 2100]},
    "rooms": {"size": [[2.0, 3.0], [2.0, 3.0], [1.5, 2.0]], "boxes": [2, 4],
              "box_extent": [0.3, 1.0], "jitter": 0.01},
    "density": 400, "grid_sample": 0.05}}
# The network of the tiny cell, written over the configuration of the copy.
SMALL = {"patch_embed_channels": 16, "patch_embed_groups": 2, "patch_embed_neighbours": 4,
         "enc_channels": [16, 32, 32, 64], "enc_groups": [2, 4, 4, 8],
         "enc_neighbours": [8, 8, 8, 8], "dec_channels": [16, 16, 32, 32],
         "dec_groups": [2, 2, 4, 4], "dec_neighbours": [8, 8, 8, 8],
         "grid_sizes": [0.1, 0.2, 0.3, 0.5]}
# Pointcept's PT-v2m2 as its ScanNet configuration builds it.
POINTCEPT = {"in_channels": 9, "classes": 20, "patch_embed_depth": 1,
             "patch_embed_channels": 48, "patch_embed_groups": 6, "patch_embed_neighbours": 8,
             "enc_depths": [2, 2, 6, 2], "enc_channels": [96, 192, 384, 512],
             "enc_groups": [12, 24, 48, 64], "enc_neighbours": [16, 16, 16, 16],
             "dec_depths": [1, 1, 1, 1], "dec_channels": [48, 96, 192, 384],
             "dec_groups": [6, 12, 24, 48], "dec_neighbours": [16, 16, 16, 16],
             "grid_sizes": [0.06, 0.12, 0.24, 0.48], "drop_path_rate": 0.3,
             "pe_multiplier": False}


@pytest.fixture
def bench(tiny_bench):
    with open(os.path.join(tiny_bench, "workloads", f"{CELL}.json"), "w") as f:
        json.dump(TINY, f)
    path = os.path.join(tiny_bench, "configs", "point_transformer_v2_seg.json")
    with open(path) as f:
        config = json.load(f)
    with open(path, "w") as f:
        json.dump({**config, **SMALL}, f)
    return tiny_bench


def modules(bench):
    cell = harness.find_cell(CELL, bench)
    pipe = harness.load_module(bench, "pipelines", cell.config["pipeline"])
    ref = harness.load_module(bench, "reference", cell.config["reference"])
    return cell, pipe, ref


def run(cell, bench, seed=2**31 + 11):
    return harness.run_cell(cell, seed, 0.2, False, device="cpu", t_start=time.perf_counter(),
                            bench_dir=bench, log=lambda s: None)


def pipeline():
    return harness.load_module(harness.BENCH_DIR, "pipelines", "point_transformer_v2_seg")


def test_one_network_everywhere():
    """The configuration's sizes are Pointcept's, the pipeline's, the
    reference's ``Arch`` and the port's defaults; nothing is reduced."""
    from pytorch3d_pointops_tpu_torch.models import PointTransformerV2Seg

    pipe = pipeline()
    ref = harness.load_module(harness.BENCH_DIR, "reference", "point_transformer_v2_seg")
    with open(os.path.join(harness.BENCH_DIR, "configs", "point_transformer_v2_seg.json")) as f:
        config = json.load(f)
    defaults = {k: p.default for k, p in
                inspect.signature(PointTransformerV2Seg.__init__).parameters.items()
                if k != "self"}

    def as_lists(arch):
        return {k: list(v) if isinstance(v, tuple) else v for k, v in arch.items()}

    want = {k: config[k] for k in pipe.ARCH_KEYS}
    assert want == POINTCEPT and config["reduced"] == []
    assert as_lists(pipe.PUBLISHED) == want
    assert as_lists(ref.Arch()._asdict()) == want
    assert as_lists(defaults) == want


def test_the_tiny_cell_reads_correct(bench):
    cell, pipe, _ = modules(bench)
    assert {k: pipe.PUBLISHED[k] for k in SMALL} == SMALL
    r = run(cell, bench)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert set(r["checks"]) == set(cell.config["limits"])
    assert r["checks"]["plan_mismatch"]["value"] == 0
    assert set(r["metrics"]) == {"step_ms", "setup_s"}


def test_the_control_fails_a_limit(bench):
    cell, pipe, ref = modules(bench)
    dev, host = clouds.generators(3_000_000_011, "cpu")
    numbers = pipe.control(pipe.make_inputs(cell.spec["traffic"], dev, host, "cpu"), ref, host)
    limits = cell.config["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("fault", ["stale_state", "altered_answer", "half_batch"])
def test_a_planted_fault_reads_incorrect(bench, fault):
    import pytorch3d_pointops_tpu_torch as port

    cell, pipe, _ = modules(bench)
    assert fault in pipe.FAULTS
    with pipe.plant(fault, port):
        broken = run(cell, bench)
    assert not broken["correct"], broken["checks"]


def test_the_generated_scenes(bench):
    """Each scene lies in the first octant from 0; rgb in [-1, 1); each
    normal a signed axis; labels in [0, 20); padding 0; each level smaller
    than the one above; a drop mask a dropping block, of its level's size."""
    cell, pipe, ref = modules(bench)
    dev, host = clouds.generators(3_000_000_013, "cpu")
    inputs = pipe.make_inputs(cell.spec["traffic"], dev, host, "cpu")
    arch = ref.Arch(**inputs["arch"])
    levels = {name: lv for name, lv, _, _, _ in ref.blocks(arch)}
    assert len(inputs["clouds"]) == 2
    for c in inputs["clouds"]:
        assert c["lengths_host"] == [3000, 2100] and c["labels"].shape == (5100,)
        for n, L in enumerate(c["lengths_host"]):
            xyz, feats = c["xyz"][n], c["feats"][n]
            assert torch.equal(xyz[:L].amin(0), torch.zeros(3))
            rgb, normal = feats[:L, :3], feats[:L, 3:]
            assert bool((rgb >= -1).all()) and bool((rgb < 1).all())
            assert torch.equal(normal.abs().sum(1), torch.ones(L))
            assert not xyz[L:].any() and not feats[L:].any()
        assert 0 <= int(c["labels"].min()) and int(c["labels"].max()) < 20
        sizes = c["level_sizes"]
        assert sizes[0] == 5100 and all(a > b for a, b in zip(sizes, sizes[1:]))
        assert set(c["drop_masks"]) == set(ref.drop_path_rates(arch))
        for name, mask in c["drop_masks"].items():
            assert mask.shape == (sizes[levels[name]],)


def test_the_dense_and_gather_counts():
    """By hand at level sizes T0-T4 of the published network: a block at
    width C, groups G, over T points and K neighbours has 5 T C^2
    multiply-adds on its points (fc1, q, k, v, fc3) and T K (3 C + C^2 + C G
    + G^2) on its pairs; a pooling T_i C_i C_(i+1); an unpooling T_(i+1)
    C_(i+1)' C_i' + T_i C_i C_i'; the patch embedding 9 x 48 a point; the
    head 48 x 48 + 48 x 20. A step counts each forward product again for the
    weights' gradient and again for the input's, less the input gradients of
    the first layer and of each position encoding's first layer."""
    pipe = pipeline()
    arch = dict(pipe.PUBLISHED)
    T = [276_480, 40_000, 11_000, 3_000, 800]
    enc, dec = [48, 96, 192, 384, 512], [48, 96, 192, 384, 512]
    blocks = [(0, 48, 6, 8)] + [(i + 1, enc[i + 1], g, 16) for i, (d, g) in
                                enumerate(zip((2, 2, 6, 2), (12, 24, 48, 64))) for _ in range(d)]
    blocks += [(i, dec[i], g, 16) for i, g in enumerate((6, 12, 24, 48))]
    fwd = no_input_grad = 0
    for lv, C, G, K in blocks:
        t = T[lv]
        fwd += 5 * t * C * C + t * K * (3 * C + C * C + C * G + G * G)
        no_input_grad += t * K * 3 * C
    fwd += T[0] * 9 * 48
    no_input_grad += T[0] * 9 * 48
    fwd += sum(T[i] * enc[i] * enc[i + 1] for i in range(4))
    fwd += sum(T[i + 1] * dec[i + 1] * dec[i] + T[i] * enc[i] * dec[i] for i in range(4))
    fwd += T[0] * (48 * 48 + 48 * 20)
    assert pipe.dense_flops(T, arch) == 2 * (3 * fwd - no_input_grad)
    g = pipe.gathers(T, arch)
    assert len(g) == 17 + 4
    assert (T[0] * 8, 96, T[0]) in g and (T[0] * 16, 96, T[0]) in g
    assert (T[0], 48, T[1]) in g and (T[3], 384, T[4]) in g
    counts = pipe.work_counts({"clouds": [{"lengths_host": [1, 2, 3], "level_sizes": T}],
                               "arch": arch}, {})
    assert counts["gather_bwd"] == {"span": "port.bwd", "ops": sum(e * c for e, c, _ in g),
                                    "bytes": sum(4 * c * (e + r) + 8 * e for e, c, r in g)}
    seg = counts["grid_pool"]
    # The features' maximum and its backward alone: read and write T x C
    # values twice over, M x C values and rows twice over.
    floor = sum(4 * 2 * C * t + 8 * 2 * C * m
                for C, t, m in zip(enc[1:], T, T[1:]))
    assert floor < seg["bytes"] < 2 * floor and seg["span"] == "step"


def test_the_grid_pool_reader():
    """``grid_pool_roofline`` reads the segment kernels wherever they ran
    and nothing else; None without them or without the count."""
    acts = [trace.Activity("void (anonymous namespace)::segment_max_kernel(float const*)", 0,
                           30, "port.fwd"),
            trace.Activity("segment_keys_kernel", 30, 10, "port.plan"),
            trace.Activity("segment_max_bwd_kernel", 40, 20, "port.bwd"),
            trace.Activity("void at::native::radix_sort_kernel<long>", 60, 50, "port.plan"),
            trace.Activity("bucket_sum_kernel<false, 8>", 110, 50, "port.bwd")]
    reader = harness.load_module(harness.BENCH_DIR, "metrics", "grid_pool_roofline")
    work = {"grid_pool": {"span": "step", "ops": 1e6, "bytes": 3.35e6}}
    ctx = harness.Ctx(trace=trace.Trace(activities=acts), profiled_steps=2, work=work,
                      peak=(67e12, 3.35e12))
    # 1e-6 s of bytes over (60 us / 2) a step.
    assert reader.read(ctx) == pytest.approx(100 * 1e-6 / 30e-6)
    ctx.trace = trace.Trace(activities=acts[3:])
    assert reader.read(ctx) is None
    assert reader.read(harness.Ctx(trace=trace.Trace(activities=acts), profiled_steps=2,
                                   peak=(67e12, 3.35e12))) is None


def test_the_reference_imports_nothing_of_the_port():
    path = os.path.join(harness.BENCH_DIR, "reference", "point_transformer_v2_seg.py")
    src = open(path).read()
    assert "pytorch3d_pointops_tpu" not in src and "jax" not in src
    imports = {line for line in src.splitlines() if line.startswith(("import ", "from "))}
    assert imports == {
        "from __future__ import annotations", "from typing import NamedTuple", "import torch",
        "import torch.nn.functional as F",
        "from benchmark.reference.point_transformer_seg import EPS, MOMENTUM, STATS, "
        "_TF32MatMul, knn"}
