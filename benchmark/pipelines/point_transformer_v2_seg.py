"""``point_transformer_v2_seg``: training Point Transformer V2 semantic
segmentation (Wu et al. 2022, Pointcept's ``PT-v2m2``, ScanNet
configuration) on the port's model,
``pytorch3d_pointops_tpu_torch.models.PointTransformerV2Seg``, at its
published widths, float32, TF32 off, with the configuration's optimiser
(AdamW, lr 0.005, weight decay 0.02; a fixed lr in place of its OneCycle
schedule) and drop path 0.3.

A step: ``model.plan(xyz, lengths)`` (the grid pooling of the coordinates
at four levels and every level's KNN, ``port.plan``), ``model(xyz, feats,
lengths, plan, drop_masks)`` (``port.fwd``), cross-entropy over every valid
point (``user.loss``), the backward (``port.bwd``), AdamW (torch's fused
kernel, ``user.opt``), and the loss read to the host (``read``), as the
Point Transformer's pipeline reads it. Step j takes input set ``j %
entries`` of the pool, with that entry's drop path masks (drawn once from
the seed at set-up: one keep-or-drop a row a block, scaled by 1 / keep).
Every pass over the pool starts from the set-up's weights and batch norm
buffers, copied back in place, and from AdamW's state zeroed
(``user.reset``), so every pass repeats the first bit for bit.

The check holds the first step to the plain reference
(``reference/point_transformer_v2_seg.py``), which runs it on its own from
the inputs: every pool entry's plan (each pooling's clusters, sorted order,
counts by cloud and mean coordinates, and every level's KNN; exact), the
first step's logits, loss and whole gradient, AdamW's first update of each
parameter, and each batch norm's running statistics after the step
(``point_transformer_seg.compare``). Later steps are held to the first pass
bit for bit (the harness).

Traffic keys: ``pool``, ``lr``, ``weight_decay``, ``classes``, ``clouds``
(``batch``, ``points``, ``lengths``: the cropped length of each cloud),
``rooms`` (the Point Transformer pipeline's room parameters: ``size``,
``boxes``, ``box_extent``, ``jitter``), ``density`` (points sampled a
square metre of surface) and ``grid_sample`` (metres). Each cloud is a
room as that pipeline draws it (its helpers), with points on its faces in
proportion to area at ``density``, jittered, shifted to a least coordinate
of 0 on each axis, grid-sampled (one point a cell of ``grid_sample``, the
first in a seeded order), and cropped to its length by the points nearest
a seeded one of them (Pointcept's ``SphereCrop``, nearest first), then
shifted again to a least coordinate of 0. Features: rgb uniform in [-1,
1) and each face's outward normal; a label uniform in [0, ``classes``) a
surface. Padding stays 0. The network's sizes (``PUBLISHED``) are the
configuration's, ``configs/point_transformer_v2_seg.json``.
"""

from __future__ import annotations

import importlib
import json
import os

import torch
import torch.nn.functional as F

from benchmark import clouds, faults, work
from benchmark.pipelines.point_transformer_seg import _box_faces, _uniform, compare
from benchmark.reference import point_transformer_v2_seg as reference

ARCH_KEYS = tuple(reference.Arch._fields)
AXIS = 1 << 20  # a grid-sample key's room for a cell index on an axis


def _published() -> dict:
    """The network of ``configs/point_transformer_v2_seg.json`` beside this
    file's directory, as run (the port's defaults, the reference's
    ``Arch``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "point_transformer_v2_seg.json")
    with open(path) as f:
        config = json.load(f)
    return {k: config[k] for k in ARCH_KEYS}


PUBLISHED = _published()


def make_scene(traffic: dict, length: int, dev, host, device):
    """One room cropped to ``length`` points: (xyz (length, 3), feats
    (length, 6): rgb and normal, labels (length,))."""
    rooms, classes = traffic["rooms"], traffic["classes"]
    size = torch.stack([_uniform(r, (), dev, device) for r in rooms["size"]])
    boxes = int(torch.randint(rooms["boxes"][0], rooms["boxes"][1] + 1, (), generator=host))
    extent = torch.minimum(_uniform(rooms["box_extent"], (boxes, 3), dev, device), size)
    corner = torch.rand((boxes, 3), generator=dev, device=device) * (size - extent)
    corner[:, 2] = 0.0  # standing on the floor
    o, u, v, area = _box_faces(torch.cat([torch.zeros(1, 3, device=device), corner]),
                               torch.cat([size[None], extent]))
    labels = torch.randint(0, classes, (6 + boxes,), generator=host).to(device)
    count = int(round(float(area.sum()) * traffic["density"]))
    face = torch.multinomial(area.reshape(-1), count, replacement=True, generator=dev)
    a, b = torch.rand((2, count, 1), generator=dev, device=device)
    o, u, v = (t.reshape(-1, 3) for t in (o, u, v))
    xyz = o[face] + a * u[face] + b * v[face]
    xyz = xyz + torch.randn(xyz.shape, generator=dev, device=device) * rooms["jitter"]
    xyz = xyz - xyz.min(dim=0).values
    # Face k of a box spans axes other than k // 2; its side k % 2 gives
    # the normal's sign.
    side = (face % 6) % 2 * 2 - 1
    normal = torch.eye(3, device=device)[(face % 6) // 2] * side[:, None]
    # Grid sampling: the first point of each cell in a seeded order.
    cell = (xyz / traffic["grid_sample"]).to(torch.int64)
    key = (cell[:, 2] * AXIS + cell[:, 1]) * AXIS + cell[:, 0]
    perm = torch.randperm(count, generator=dev, device=device)
    sorted_key, order = torch.sort(key[perm], stable=True)
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    keep = perm[order[first]]
    if keep.numel() < length:
        raise ValueError(f"a room keeps {keep.numel()} points after grid sampling, "
                         f"fewer than its length {length}")
    # The crop: the length points nearest a seeded one, nearest first.
    centre = xyz[keep[torch.randint(0, keep.numel(), (), generator=dev, device=device)]]
    near = torch.argsort(((xyz[keep] - centre) ** 2).sum(1), stable=True)[:length]
    keep = keep[near]
    surface = torch.cat([torch.arange(6, device=device),
                         6 + torch.arange(boxes, device=device).repeat_interleave(6)])
    rgb = torch.rand((length, 3), generator=dev, device=device) * 2 - 1
    pts = xyz[keep]
    return (pts - pts.min(dim=0).values, torch.cat([rgb, normal[keep]], 1),
            labels[surface[face[keep]]])


def level_sizes(xyz: torch.Tensor, lengths: list, arch: dict) -> list:
    """Each level's points over the batch: the input's, then each grid
    pooling's clusters (the reference's pooling)."""
    pos = torch.cat([xyz[n, :L] for n, L in enumerate(lengths)])
    lens, out = list(lengths), [sum(lengths)]
    for g in arch["grid_sizes"]:
        pool = reference.grid_pool(pos, lens, g)
        pos, lens = pool["pos"], pool["lengths"]
        out.append(sum(lens))
    return out


def drop_masks(sizes: list, arch: dict, dev, device) -> dict:
    """Drop path's factors of one step, by block name: each row of the
    block's level kept with probability 1 - rate and then 1 / (1 - rate),
    else 0."""
    spec = reference.Arch(**arch)
    level = {name: lv for name, lv, _, _, _ in reference.blocks(spec)}
    out = {}
    for name, rate in reference.drop_path_rates(spec).items():
        keep = 1.0 - rate
        draw = torch.rand(sizes[level[name]], generator=dev, device=device)
        out[name] = (draw < keep).to(torch.float32) / keep
    return out


def make_inputs(traffic: dict, dev, host, device) -> dict:
    spec, classes = traffic["clouds"], traffic["classes"]
    arch = dict(PUBLISHED)
    if classes != arch["classes"]:
        raise ValueError(f"the traffic's {classes} classes are not the network's "
                         f"{arch['classes']}")
    lengths = clouds.lengths_of(spec)
    sets = []
    for _ in range(traffic["pool"]):
        xyz = torch.zeros((spec["batch"], spec["points"], 3), device=device)
        feats = torch.zeros((spec["batch"], spec["points"], arch["in_channels"] - 3),
                            device=device)
        labels = []
        for n, L in enumerate(lengths):
            xyz[n, :L], feats[n, :L], lab = make_scene(traffic, L, dev, host, device)
            labels.append(lab)
        sizes = level_sizes(xyz, lengths, arch)
        sets.append({"xyz": xyz, "feats": feats, "lengths_host": lengths,
                     "labels": torch.cat(labels), "level_sizes": sizes,
                     "drop_masks": drop_masks(sizes, arch, dev, device)})
    return {"clouds": sets, "weights": make_weights(arch, dev, device), "arch": arch,
            "lr": traffic["lr"], "weight_decay": traffic["weight_decay"]}


def linears(sizes: list, arch: dict):
    """Every ``Linear`` of the network at these level sizes: (state name,
    fan_in, fan_out, bias, rows a forward, whether the backward computes
    its input's gradient). Rows of grouped tensors count every (point,
    neighbour) pair; no gradient is asked of the input features or of the
    coordinate offsets."""
    spec = reference.Arch(**arch)
    out = [("patch_embed.proj.0", spec.in_channels, spec.patch_embed_channels, False, sizes[0],
            False)]
    for name, level, C, G, K in reference.blocks(spec):
        t, a = sizes[level], name + ".attn"
        out += [(name + ".fc1", C, C, False, t, True),
                (a + ".linear_q.0", C, C, True, t, True),
                (a + ".linear_k.0", C, C, True, t, True),
                (a + ".linear_v", C, C, True, t, True)]
        for pe in ("linear_p_multiplier", "linear_p_bias")[0 if spec.pe_multiplier else 1:]:
            out += [(f"{a}.{pe}.0", 3, C, True, t * K, False),
                    (f"{a}.{pe}.3", C, C, True, t * K, True)]
        out += [(a + ".weight_encoding.0", C, G, True, t * K, True),
                (a + ".weight_encoding.3", G, G, True, t * K, True),
                (name + ".fc3", C, C, False, t, True)]
    enc = [spec.patch_embed_channels, *spec.enc_channels]
    dec = [*spec.dec_channels, enc[-1]]
    for i in range(len(spec.enc_depths)):
        out.append((f"enc_stages.{i}.down.fc", enc[i], enc[i + 1], False, sizes[i], True))
        out += [(f"dec_stages.{i}.up.proj.0", dec[i + 1], dec[i], True, sizes[i + 1], True),
                (f"dec_stages.{i}.up.proj_skip.0", enc[i], dec[i], True, sizes[i], True)]
    out += [("seg_head.0", dec[0], dec[0], True, sizes[0], True),
            ("seg_head.3", dec[0], spec.classes, True, sizes[0], True)]
    return out


def norms(arch: dict) -> list:
    """Every batch norm: (state name of its ``nn.BatchNorm1d``, width)."""
    spec = reference.Arch(**arch)
    pes = ("linear_p_multiplier", "linear_p_bias")[0 if spec.pe_multiplier else 1:]
    out = [("patch_embed.proj.1.norm", spec.patch_embed_channels)]
    for name, _, C, G, _ in reference.blocks(spec):
        a = name + ".attn"
        out += [(f"{name}.norm{k}.norm", C) for k in (1, 2, 3)]
        out += [(f"{a}.{m}.1.norm", C) for m in ("linear_q", "linear_k", *pes)]
        out.append((a + ".weight_encoding.1.norm", G))
    enc = [spec.patch_embed_channels, *spec.enc_channels]
    for i, C in enumerate(spec.dec_channels):
        out += [(f"enc_stages.{i}.down.norm.norm", enc[i + 1]),
                (f"dec_stages.{i}.up.proj.1.norm", C), (f"dec_stages.{i}.up.proj_skip.1.norm", C)]
    return out + [("seg_head.1.norm", spec.dec_channels[0])]


def make_weights(arch: dict, dev: torch.Generator, device) -> dict:
    """Weights under the model's ``state_dict`` names: each Linear's weight
    and bias uniform in +-1/sqrt(fan_in) (torch's default bound), each
    batch norm's scale 1, shift 0, running mean 0 and variance 1."""
    w = {}
    for name, fan_in, fan_out, bias, _, _ in linears([0] * (len(arch["grid_sizes"]) + 1), arch):
        bound = fan_in ** -0.5
        shapes = (("weight", (fan_out, fan_in)),) + ((("bias", (fan_out,)),) if bias else ())
        for key, shape in shapes:
            w[f"{name}.{key}"] = (torch.rand(shape, generator=dev, device=device) * 2 - 1) * bound
    for name, width in norms(arch):
        w[f"{name}.weight"] = torch.ones(width, device=device)
        w[f"{name}.bias"] = torch.zeros(width, device=device)
        w[f"{name}.running_mean"] = torch.zeros(width, device=device)
        w[f"{name}.running_var"] = torch.ones(width, device=device)
        w[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
    return w


def plan_indices(plan) -> list:
    """A port plan in the reference's order (``plan_indices``)."""
    out = []
    for level in plan:
        p = level.pool
        if p is not None:
            out += [p.cluster, p.order, torch.tensor(p.lengths), p.pos]
        out += [level.neighbours[k][0] for k in sorted(level.neighbours)]
    return out


class Step:
    def __init__(self, port, inputs: dict, options: dict):
        del options  # the model has its published sizes alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        models = importlib.import_module(port.__name__ + ".models")
        device = inputs["clouds"][0]["xyz"].device
        self.model = models.PointTransformerV2Seg(**inputs["arch"]).to(device).train()
        self.model.load_state_dict(inputs["weights"])
        # The weights and buffers themselves, by dtype, and their set-up copies.
        live = {}
        for t in self.model.state_dict().values():
            live.setdefault(t.dtype, []).append(t)
        self.live = list(live.values())
        self.saved = [[t.clone() for t in group] for group in self.live]
        self.opt = torch.optim.AdamW(self.model.parameters(), lr=inputs["lr"],
                                     weight_decay=inputs["weight_decay"], fused=True)
        self.ready = torch.cuda.Event() if device.type == "cuda" else None
        self.loss_host = torch.empty((), pin_memory=self.ready is not None)
        self.sets = inputs["clouds"]
        self.entries = len(self.sets)
        # What the first pass leaves for the check: each step's plan; the
        # first step's logits, loss, gradient and the state after it.
        self.first = {"plans": []}

    def _reset(self):
        with torch.no_grad():
            for live, saved in zip(self.live, self.saved):
                torch._foreach_copy_(live, saved)
            state = [t for s in self.opt.state.values() for t in s.values()
                     if isinstance(t, torch.Tensor)]
            if state:
                torch._foreach_zero_(state)

    def __call__(self, j: int, span) -> float:
        i = j % self.entries
        if i == 0:
            with span("user.reset"):
                self._reset()
        c = self.sets[i]
        with span("port.plan"):
            plan = self.model.plan(c["xyz"], c["lengths_host"])
        with span("port.fwd"):
            logits = self.model(c["xyz"], c["feats"], c["lengths_host"], plan, c["drop_masks"])
        with span("user.loss"):
            loss = F.cross_entropy(logits, c["labels"])
            self.loss_host.copy_(loss.detach(), non_blocking=True)
            if self.ready is not None:
                self.ready.record()
        with span("port.bwd"):
            loss.backward()
        if j == 0:
            self.first["grad"] = {n: p.grad.clone() for n, p in self.model.named_parameters()}
        with span("user.opt"):
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
        with span("read"):
            if self.ready is not None:
                self.ready.synchronize()
            value = self.loss_host.item()
        if j < self.entries:
            self.first["plans"].append([t.clone() for t in plan_indices(plan)])
        if j == 0:
            self.first["logits"] = logits.detach().clone()
            self.first["loss"] = value
            self.first["after"] = {n: t.clone() for n, t in self.model.state_dict().items()}
        return value


def dense_flops(sizes: list, arch: dict) -> int:
    """Float32 operations (2 a multiply-add) of a training step's Linear
    layers at these level sizes: each one's forward and weight gradient,
    and its input gradient where the backward asks for one."""
    return sum(2 * rows * fan_in * fan_out * (3 if grad_in else 2)
               for _, fan_in, fan_out, _, rows, grad_in in linears(sizes, arch))


def gathers(sizes: list, arch: dict) -> list:
    """Every gather whose backward (the scatter) runs in ``port.bwd``:
    (entries, channels, target rows). A block's attention gathers its k and
    v together (2C channels) by its level's KNN; an unpooling its coarser
    level's projection (at its own width) by each point's cluster."""
    spec = reference.Arch(**arch)
    out = [(sizes[lv] * K, 2 * C, sizes[lv]) for _, lv, C, _, K in reference.blocks(spec)]
    out += [(sizes[i], C, sizes[i + 1]) for i, C in enumerate(spec.dec_channels)]
    return out


def segment_work(sizes: list, batch: int, arch: dict) -> dict:
    """The segment kernels' work a step (``csrc/segment.cu``), from the
    level sizes alone: at each pooling of T rows into M clusters of C
    channels, the voxel keys (T x 3 read, T int64 written), the bounds
    (the heads' scan and the order read, the offsets and each row's cluster
    written), the coordinates' means (T x 3 and the order read, M x 3
    written), the features' maximum (T x C and the order read, M x C values
    and int32 rows written) and its backward (M x C gradients and rows and T
    clusters read, T x C written); the clouds' few starts, ends and counts
    besides. A float32 operation a compare or an add."""
    ops = nbytes = 0
    N, F32, I64 = batch, work.F32, work.I64
    for i, C in enumerate(arch["enc_channels"]):
        T, M = sizes[i], sizes[i + 1]
        nbytes += F32 * 3 * T + F32 * 3 * N + I64 * N + I64 * T  # segment_keys
        nbytes += 3 * I64 * T + I64 * (M + 1) + 2 * I64 * N  # segment_bounds
        nbytes += F32 * 3 * T + I64 * T + I64 * (M + 1) + F32 * 3 * M  # segment_sum
        nbytes += F32 * C * T + I64 * T + I64 * (M + 1) + (F32 + 4) * C * M  # segment_max
        nbytes += (F32 + 4) * C * M + I64 * T + F32 * C * T  # segment_max_bwd
        ops += 6 * T + 3 * T + 2 * C * T
    return {"ops": ops, "bytes": nbytes}


def work_counts(inputs: dict, options: dict) -> dict:
    """Per step, averaged over the pool's entries (the profiled steps cycle
    through them evenly): the Linear layers' work, for ``mfu``; the gathers'
    backward, for ``gather_bwd_roofline`` (a float32 add an entry and
    channel, each entry's contribution and int64 index read once, each
    target row written once); the segment kernels' work, for
    ``grid_pool_roofline``."""
    del options
    arch, sets = inputs["arch"], inputs["clouds"]
    batch = len(sets[0]["lengths_host"])

    def mean(f):
        return sum(f(c["level_sizes"]) for c in sets) / len(sets)

    def gather_bytes(sizes):
        return sum(work.F32 * c * (e + r) + work.I64 * e for e, c, r in gathers(sizes, arch))

    return {"dense": {"span": "step", "ops": mean(lambda s: dense_flops(s, arch)), "bytes": 0},
            "gather_bwd": {"span": "port.bwd",
                           "ops": mean(lambda s: sum(e * c for e, c, _ in gathers(s, arch))),
                           "bytes": mean(gather_bytes)},
            "grid_pool": {"span": "step",
                          "ops": mean(lambda s: segment_work(s, batch, arch)["ops"]),
                          "bytes": mean(lambda s: segment_work(s, batch, arch)["bytes"])}}


def check(step: Step, inputs: dict, ref, first_losses, host) -> dict:
    del first_losses, host  # every pass repeats the first; the harness holds the window to it
    got = dict(step.first)
    start = inputs["weights"]
    got["change"] = {n: got["after"][n].double() - start[n].double() for n in got["after"]}
    want = ref.first_step(inputs)
    return compare(got, want, ref.exact_gradient(inputs, want["levels"]))


def control(inputs: dict, ref, host) -> dict:
    """The numbers the control reads: the reference with its matrix
    products in TF32 in the program's place."""
    del host
    want = ref.first_step(inputs)
    ctl = ref.first_step(inputs, tf32=True)
    return compare(dict(ctl, grad=ctl["grads"]), want,
                   ref.exact_gradient(inputs, want["levels"]))


FAULTS = ("stale_state", "altered_answer", "half_batch")


def _channel_mod_groups(v, w):
    """PTv1's grouping in GVA's place: channel c takes weight group c mod G."""
    T, K, C = v.shape
    G = w.shape[-1]
    return (v.reshape(T, K, C // G, G) * w[:, :, None, :]).sum(1).reshape(T, C)


def plant(name: str, port):
    """Break the timed path with fault ``name`` (``faults.py``):
    ``stale_state`` zeroes the gathers' backward (``masked_gather``'s
    scatter), so every layer ahead of a gather gets a wrong gradient and
    the k and v maps none; ``altered_answer`` groups each attention's
    channels as ``c mod G`` (the first Point Transformer's mapping) in place
    of contiguous blocks; ``half_batch`` runs the first half of the clouds
    alone and gives the other clouds' points its logits."""
    model = faults.module(port, "models.point_transformer_v2")
    if name == "stale_state":
        def zero(idx, contrib, P2):
            return contrib.new_zeros((contrib.shape[0], P2, contrib.shape[2]))
        return faults.patched(faults.module(port, "ops.knn"), "_scatter_rows", zero)
    if name == "altered_answer":
        return faults.patched(model, "_grouped_sum", _channel_mod_groups)
    if name == "half_batch":
        cls = model.PointTransformerV2Seg
        real = cls.forward

        def forward(self, xyz, feats, lengths_host, plan=None, drop_masks=None):
            h = max(1, xyz.shape[0] // 2)
            half = real(self, xyz[:h], feats[:h], list(lengths_host)[:h], None, {})
            total = sum(int(n) for n in lengths_host)
            return half[torch.arange(total, device=xyz.device) % half.shape[0]]
        return faults.patched(cls, "forward", forward)
    raise ValueError(f"point_transformer_v2_seg cells cannot have fault {name!r}")
