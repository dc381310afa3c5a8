"""The ``point_transformer_seg`` configuration at a size a test run holds: a
tiny cell of its own (the network at a small preset, two rooms of 300 and
271 points, a pool of 2) reads ``correct``, the TF32 control fails a limit,
each planted fault reads incorrect, the comparison catches a state left
unchanged or moved the wrong way, the reference imports nothing of the
port, ``mfu``'s count is the published network's, and the plan's readers
read the plan's device time and its FPS kernels alone."""

import json
import os
import time

import pytest
import torch

from conftest import ROOT

from benchmark import clouds, harness, trace

CELL = "point_transformer_seg.tiny"
TINY = {"config": "point_transformer_seg", "chips": 1, "why": "tiny", "traffic": {
    "pool": 2, "lr": 0.5, "momentum": 0.9, "weight_decay": 1e-4, "classes": 13,
    "clouds": {"batch": 2, "points": 300, "lengths": [300, 271]},
    "rooms": {"size": [[4.0, 10.0], [4.0, 10.0], [2.5, 3.5]], "boxes": [8, 16],
              "box_extent": [0.3, 2.0], "jitter": 0.01}}}
# The network of the tiny cell, written over the configuration of the copy.
SMALL = {"planes": [16, 16, 32, 32, 64], "nsample": [4, 8, 8, 8, 8], "strides": [1, 2, 2, 2, 2]}


@pytest.fixture
def bench(tiny_bench):
    with open(os.path.join(tiny_bench, "workloads", f"{CELL}.json"), "w") as f:
        json.dump(TINY, f)
    path = os.path.join(tiny_bench, "configs", "point_transformer_seg.json")
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


def run(cell, bench, seed=2**31 + 9):
    return harness.run_cell(cell, seed, 0.2, False, device="cpu", t_start=time.perf_counter(),
                            bench_dir=bench, log=lambda s: None)


def pipeline():
    return harness.load_module(harness.BENCH_DIR, "pipelines", "point_transformer_seg")


def test_one_network_everywhere():
    """The configuration's sizes are the pipeline's, the reference's
    ``Arch`` and the port's defaults."""
    import inspect

    from pytorch3d_pointops_tpu_torch.models import PointTransformerSeg

    pipe = pipeline()
    ref = harness.load_module(harness.BENCH_DIR, "reference", "point_transformer_seg")
    with open(os.path.join(harness.BENCH_DIR, "configs", "point_transformer_seg.json")) as f:
        config = json.load(f)
    defaults = {k: p.default for k, p in
                inspect.signature(PointTransformerSeg.__init__).parameters.items()
                if k != "self"}

    def as_lists(arch):
        return {k: list(v) if isinstance(v, tuple) else v for k, v in arch.items()}

    want = {k: config[k] for k in pipe.ARCH_KEYS}
    assert as_lists(pipe.PUBLISHED) == want
    assert as_lists(ref.Arch()._asdict()) == want
    assert as_lists(defaults) == want


def test_the_tiny_cell_reads_correct(bench):
    cell, pipe, _ = modules(bench)
    assert {k: list(pipe.PUBLISHED[k]) for k in SMALL} == SMALL
    r = run(cell, bench)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert set(r["checks"]) == set(cell.config["limits"])
    assert r["checks"]["plan_mismatch"]["value"] == 0
    assert set(r["metrics"]) == {"step_ms", "setup_s"}


def test_the_control_fails_a_limit(bench):
    cell, pipe, ref = modules(bench)
    dev, host = clouds.generators(3_000_000_001, "cpu")
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


def test_a_state_left_unchanged_or_reversed_reads_over_its_limit(bench):
    """Held against the reference's own first step: one small parameter
    left where it was (the head's last bias, 13 entries), every update
    reversed, and one batch norm's running statistics left unchanged each
    fail a limit; the reference against itself reads 0."""
    cell, pipe, ref = modules(bench)
    dev, host = clouds.generators(3_000_000_003, "cpu")
    inputs = pipe.make_inputs(cell.spec["traffic"], dev, host, "cpu")
    want = ref.first_step(inputs)
    exact = ref.exact_gradient(inputs, want["levels"])
    limits = cell.config["limits"]

    def read(**change):
        got = dict(want, grad=want["grads"], change=dict(want["change"], **change))
        return pipe.compare(got, want, exact)

    same = read()
    assert all(v == 0 for v in same.values()), same
    frozen = read(**{"cls.3.bias": 0 * want["change"]["cls.3.bias"]})
    assert frozen["update_gap"] == 1.0 > limits["update_gap"]
    reversed_ = read(**{n: -c for n, c in want["change"].items() if n in exact})
    assert reversed_["update_gap"] == 2.0
    name = "enc3.2.transformer2.linear_w.0.running_var"
    stale = read(**{name: 0 * want["change"][name]})
    assert stale["stats_gap"] == 1.0 > limits["stats_gap"]


def test_the_generated_rooms():
    """Each room lies in the first octant from 0, within its size plus the
    jitter; labels lie in [0, 13) and colours in [0, 1); padding is 0."""
    pipe = pipeline()
    dev, host = clouds.generators(3_000_000_005, "cpu")
    inputs = pipe.make_inputs(TINY["traffic"], dev, host, "cpu")
    assert len(inputs["clouds"]) == 2 and inputs["arch"] == pipe.PUBLISHED
    for c in inputs["clouds"]:
        for n, L in enumerate(c["lengths_host"]):
            xyz, rgb = c["xyz"][n], c["feats"][n]
            assert torch.equal(xyz[:L].amin(0), torch.zeros(3))
            assert bool((xyz[:L].amax(0) <= torch.tensor([10.1, 10.1, 3.6])).all())
            assert bool((rgb[:L] >= 0).all()) and bool((rgb[:L] < 1).all())
            assert not xyz[L:].any() and not rgb[L:].any()
        assert c["labels"].shape == (571,) and 0 <= int(c["labels"].min())
        assert int(c["labels"].max()) < 13


def test_the_reference_imports_nothing_of_the_port():
    path = os.path.join(harness.BENCH_DIR, "reference", "point_transformer_seg.py")
    src = open(path).read()
    assert "pytorch3d_pointops_tpu" not in src and "jax" not in src
    imports = {line for line in src.splitlines() if line.startswith(("import ", "from "))}
    assert imports == {"from __future__ import annotations", "from typing import NamedTuple",
                       "import torch", "import torch.nn.functional as F",
                       "from benchmark.plain import key_of, sq_dist, tf32_round"}


def test_mfu_counts_the_published_network():
    """By hand at the cell's lengths: 296,070 / 74,017 / 18,504 / 4,625 /
    1,154 points by level. A block at width C over T points and K
    neighbours has 5 T C^2 multiply-adds on its points (linear1, q, k, v,
    linear3) and T K (9 + 3 C + C^2 / 8 + C^2 / 64) on its pairs; a
    stride-4 TransitionDown T K (3 + C_in) C; a TransitionUp T C^2 + T_c
    C_c C; the coarsest 2 T C^2 + N C^2; the head T (32^2 + 32 x 13). A
    step counts each forward product again for the weights' gradient and
    again for the input's, less the input gradients of the first layer and
    of each position encoding's first layer (3 x 3 a pair)."""
    pipe = pipeline()
    with open(os.path.join(ROOT, "benchmark", "workloads", "point_transformer_seg.b4x80k.json")) as f:
        traffic = json.load(f)["traffic"]
    lengths = traffic["clouds"]["lengths"]
    assert lengths == [80000, 80000, 74213, 61857]
    T = [296_070, 74_017, 18_504, 4_625, 1_154]
    assert pipe.level_counts(lengths, pipe.PUBLISHED) == T
    C, K, blocks = (32, 64, 128, 256, 512), (8, 16, 16, 16, 16), (1, 2, 3, 5, 2)

    def block(t, c, k):
        return 5 * t * c * c + t * k * (9 + 3 * c + c * c // 8 + c * c // 64)

    fwd = no_input_grad = 0
    for i in range(5):
        fwd += (blocks[i] + 1) * block(T[i], C[i], K[i])
        no_input_grad += (blocks[i] + 1) * T[i] * K[i] * 9
    fwd += T[0] * 6 * 32
    no_input_grad += T[0] * 6 * 32
    fwd += sum(T[i] * K[i] * (3 + C[i - 1]) * C[i] for i in range(1, 5))
    fwd += sum(T[i] * C[i] ** 2 + T[i + 1] * C[i + 1] * C[i] for i in range(4))
    fwd += 2 * T[4] * 512 ** 2 + 4 * 512 ** 2
    fwd += T[0] * (32 * 32 + 32 * 13)
    flops = pipe.dense_flops(lengths, {**pipe.PUBLISHED, "classes": 13})
    assert flops == 2 * (3 * fwd - no_input_grad)
    assert round(fwd / 1e9, 1) == 54.0 and round(flops / 1e9, 1) == 323.7
    mfu = harness.load_module(harness.BENCH_DIR, "metrics", "mfu")
    ctx = harness.Ctx(work={"dense": {"span": "step", "ops": flops, "bytes": 0}},
                      peak=(67e12, 3.35e12), step_s=[0.3, 0.31, 0.29])
    assert mfu.read(ctx) == pytest.approx(100 * flops / (67e12 * 0.3))


def test_the_gathers_backward_count():
    """26 gathers at the cell's lengths: an attention layer's k and v (2C
    channels, T K entries into T rows; 18 layers), a TransitionDown's
    features of the level above (4), a TransitionUp's coarser features (4)."""
    pipe = pipeline()
    g = pipe.gathers([80000, 80000, 74213, 61857], pipe.PUBLISHED)
    assert len(g) == 18 + 4 + 4
    assert (296_070 * 8, 64, 296_070) in g and (74_017 * 16, 32, 296_070) in g
    assert (296_070 * 3, 32, 74_017) in g
    counts = pipe.work_counts({"clouds": [{"lengths_host": [80000, 80000, 74213, 61857]}],
                               "arch": {**pipe.PUBLISHED, "classes": 13}}, {})["gather_bwd"]
    assert counts["span"] == "port.bwd"
    assert counts["ops"] == sum(e * c for e, c, _ in g)
    assert counts["bytes"] == sum(4 * c * (e + r) + 8 * e for e, c, r in g)


def test_the_plan_readers():
    """``point_transformer.plan_ms`` reads all of ``port.plan``'s device time,
    ``point_transformer.fps_ms`` its FPS kernels alone; both None without
    their spans or kernels."""
    acts = [trace.Activity("void fps_grid_kernel<3, 8, 256>(float const*)", 0, 100, "port.plan"),
            trace.Activity("fps_block_kernel<3, 16, 512>", 100, 10, "port.plan"),
            trace.Activity("knn_topk_kernel<16>", 110, 30, "port.plan"),
            trace.Activity("fps_block_kernel<3, 16, 512>", 140, 7, "port.fwd")]
    ctx = harness.Ctx(trace=trace.Trace(activities=acts), profiled_steps=2)
    plan_ms = harness.load_module(harness.BENCH_DIR, "metrics", "point_transformer.plan_ms")
    fps_ms = harness.load_module(harness.BENCH_DIR, "metrics", "point_transformer.fps_ms")
    assert plan_ms.read(ctx) == pytest.approx(140 / 1e3 / 2)
    assert fps_ms.read(ctx) == pytest.approx(110 / 1e3 / 2)
    ctx.trace = trace.Trace(activities=acts[2:])
    assert fps_ms.read(ctx) is None
    for reader in (plan_ms, fps_ms):
        assert reader.read(harness.Ctx()) is None
