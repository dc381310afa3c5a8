"""``point_transformer_seg``: training Point Transformer semantic
segmentation (Zhao et al. 2021, ``pointtransformer_seg_repro``) on the port's
model, ``pytorch3d_pointops_tpu_torch.models.PointTransformerSeg``, at its
published widths, float32, TF32 off, with the source's S3DIS optimiser
(SGD, lr 0.5, momentum 0.9, weight decay 1e-4).

A step: ``model.plan(xyz, lengths)`` (FPS and every KNN of the five levels,
``port.plan``), ``model(xyz, feats, lengths, plan)`` (``port.fwd``),
cross-entropy over every valid point (``user.loss``), the backward
(``port.bwd``), SGD (``user.opt``), and the loss read to the host
(``read``). On a card the loss is copied to pinned host memory as soon as
it is computed, and the read waits for that copy alone, as a loop that logs
its loss without draining the card's queue does. Step j takes input set
``j % entries`` of the pool. Every pass over the pool starts from the
set-up's weights and batch norm buffers, copied back in place, and from
SGD's momentum buffers zeroed (``user.reset``; a zeroed buffer takes the
first gradient exactly as a fresh one does), so every pass repeats the
first bit for bit.

The check holds the first step to the plain reference
(``reference/point_transformer_seg.py``), which runs it on its own from the
inputs: every pool entry's plan indices (FPS, and the KNN of every level:
self, down and up; exact), the first step's logits, loss and whole
gradient, SGD's first update of each parameter, and each batch norm's
running statistics after the step. Later steps are held to the first pass
bit for bit (the harness).

Traffic keys: ``pool``, ``lr``, ``momentum``, ``weight_decay``,
``classes``, ``clouds`` (a cloud spec of ``clouds.py``: ``batch``,
``points``, ``lengths``), ``rooms``: each cloud a room, a box of size
uniform in ``size`` (per axis [lo, hi], metres) with ``boxes`` [lo, hi]
(inclusive) axis-aligned boxes inside it standing on its floor, each of
extent uniform in ``box_extent`` per axis (at most the room's); a cloud's
points lie on the room's six faces and the boxes' faces in proportion to
area, jittered by N(0, ``jitter``^2) per axis, then shifted so that the
cloud's least coordinate on each axis is 0; colours uniform in [0, 1);
each room face and each box a surface with a label uniform in [0,
``classes``). Padding stays 0. The network's sizes (``PUBLISHED``) are
the configuration's, ``configs/point_transformer_seg.json``, whose
``classes`` the traffic's must equal.
"""

from __future__ import annotations

import importlib
import json
import os

import torch
import torch.nn.functional as F

from benchmark import clouds, faults, work

ARCH_KEYS = ("in_channels", "classes", "planes", "strides", "nsample", "blocks", "share_planes")
UP_K = 3


def _published() -> dict:
    """The network of ``configs/point_transformer_seg.json`` beside this
    file's directory, as run (the port's defaults, the reference's ``Arch``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "point_transformer_seg.json")
    with open(path) as f:
        config = json.load(f)
    return {k: config[k] for k in ARCH_KEYS}


PUBLISHED = _published()


def level_counts(lengths: list, arch: dict) -> list:
    """Each level's points over the batch: FPS keeps L // stride of L."""
    lens, out = list(lengths), []
    for s in arch["strides"]:
        lens = [n // s for n in lens]
        out.append(sum(lens))
    return out


def linears(lengths: list, arch: dict):
    """Every ``Linear`` of the network at these input lengths: (state name,
    fan_in, fan_out, bias, rows a forward, whether the backward computes
    its input's gradient). Rows of grouped tensors count every (point,
    neighbour) pair; no gradient is asked of the input features or of the
    coordinate offsets."""
    T, N = level_counts(lengths, arch), len(lengths)
    planes, nsample, share = arch["planes"], arch["nsample"], arch["share_planes"]
    out = []

    def block(name, C, K, t):
        a = name + ".transformer2"
        out.extend([(name + ".linear1", C, C, False, t, True),
                    (a + ".linear_q", C, C, True, t, True),
                    (a + ".linear_k", C, C, True, t, True),
                    (a + ".linear_v", C, C, True, t, True),
                    (a + ".linear_p.0", 3, 3, True, t * K, False),
                    (a + ".linear_p.3", 3, C, True, t * K, True),
                    (a + ".linear_w.2", C, C // share, True, t * K, True),
                    (a + ".linear_w.5", C // share, C // share, True, t * K, True),
                    (name + ".linear3", C, C, False, t, True)])

    width = arch["in_channels"]
    for i, (C, K) in enumerate(zip(planes, nsample)):
        if arch["strides"][i] == 1:
            out.append((f"enc{i + 1}.0.linear", width, C, False, T[i], i > 0))
        else:
            out.append((f"enc{i + 1}.0.linear", 3 + width, C, False, T[i] * K, True))
        for b in range(arch["blocks"][i]):
            block(f"enc{i + 1}.{b + 1}", C, K, T[i])
        width = C
    last = len(planes) - 1
    for i in reversed(range(len(planes))):
        C, d = planes[i], f"dec{i + 1}.0"
        if i == last:
            out.extend([(d + ".linear1.0", 2 * C, C, True, T[i], True),
                        (d + ".linear2.0", C, C, True, N, True)])
        else:
            out.extend([(d + ".linear1.0", C, C, True, T[i], True),
                        (d + ".linear2.0", planes[i + 1], C, True, T[i + 1], True)])
        block(f"dec{i + 1}.1", C, nsample[i], T[i])
    out.extend([("cls.0", planes[0], planes[0], True, T[0], True),
                ("cls.3", planes[0], arch["classes"], True, T[0], True)])
    return out


def norms(arch: dict) -> list:
    """Every batch norm: (state name, width)."""
    planes, share = arch["planes"], arch["share_planes"]
    out = []

    def block(name, C):
        a = name + ".transformer2"
        out.extend([(name + ".bn1", C), (a + ".linear_p.1", 3), (a + ".linear_w.0", C),
                    (a + ".linear_w.3", C // share), (name + ".bn2", C), (name + ".bn3", C)])

    for i, C in enumerate(planes):
        out.append((f"enc{i + 1}.0.bn", C))
        for b in range(arch["blocks"][i]):
            block(f"enc{i + 1}.{b + 1}", C)
    for i in reversed(range(len(planes))):
        out.append((f"dec{i + 1}.0.linear1.1", planes[i]))
        if i < len(planes) - 1:
            out.append((f"dec{i + 1}.0.linear2.1", planes[i]))
        block(f"dec{i + 1}.1", planes[i])
    out.append(("cls.1", planes[0]))
    return out


def make_weights(arch: dict, dev: torch.Generator, device) -> dict:
    """Weights under the model's ``state_dict`` names: each Linear's weight
    and bias uniform in +-1/sqrt(fan_in) (torch's default bound), each
    batch norm's scale 1, shift 0, running mean 0 and variance 1."""
    w = {}
    for name, fan_in, fan_out, bias, _, _ in linears([], arch):
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


def _uniform(lo_hi, shape, dev, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(shape, generator=dev, device=device)


def _box_faces(corner: torch.Tensor, extent: torch.Tensor):
    """The six faces of axis-aligned boxes (B, 3): origins, spanning
    vectors u and v (each (B, 6, 3)) and areas (B, 6)."""
    eye = torch.eye(3, device=corner.device)
    origin, u, v = [], [], []
    for a in range(3):
        b, c = (a + 1) % 3, (a + 2) % 3
        for side in (0.0, 1.0):
            origin.append(corner + side * extent[:, a:a + 1] * eye[a])
            u.append(extent[:, b:b + 1] * eye[b])
            v.append(extent[:, c:c + 1] * eye[c])
    origin, u, v = (torch.stack(t, 1) for t in (origin, u, v))
    return origin, u, v, u.norm(dim=-1) * v.norm(dim=-1)


def make_room(rooms: dict, length: int, classes: int, dev, host, device):
    """One room of ``length`` points: (xyz (length, 3), rgb (length, 3),
    labels (length,))."""
    size = torch.stack([_uniform(r, (), dev, device) for r in rooms["size"]])
    boxes = int(torch.randint(rooms["boxes"][0], rooms["boxes"][1] + 1, (), generator=host))
    extent = torch.minimum(_uniform(rooms["box_extent"], (boxes, 3), dev, device), size)
    corner = torch.rand((boxes, 3), generator=dev, device=device) * (size - extent)
    corner[:, 2] = 0.0  # standing on the floor
    o, u, v, area = _box_faces(torch.cat([torch.zeros(1, 3, device=device), corner]),
                               torch.cat([size[None], extent]))
    labels = torch.randint(0, classes, (6 + boxes,), generator=host).to(device)
    surface = torch.cat([torch.arange(6, device=device),
                         6 + torch.arange(boxes, device=device).repeat_interleave(6)])
    face = torch.multinomial(area.reshape(-1), length, replacement=True, generator=dev)
    a, b = torch.rand((2, length, 1), generator=dev, device=device)
    o, u, v = (t.reshape(-1, 3) for t in (o, u, v))
    xyz = o[face] + a * u[face] + b * v[face]
    xyz = xyz + torch.randn(xyz.shape, generator=dev, device=device) * rooms["jitter"]
    xyz = xyz - xyz.min(dim=0).values
    rgb = torch.rand((length, 3), generator=dev, device=device)
    return xyz, rgb, labels[surface[face]]


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
        rgb = torch.zeros_like(xyz)
        labels = []
        for n, L in enumerate(lengths):
            xyz[n, :L], rgb[n, :L], lab = make_room(traffic["rooms"], L, classes, dev, host,
                                                    device)
            labels.append(lab)
        sets.append({"xyz": xyz, "feats": rgb, "lengths_host": lengths,
                     "labels": torch.cat(labels)})
    return {"clouds": sets, "weights": make_weights(arch, dev, device), "arch": arch,
            "lr": traffic["lr"], "momentum": traffic["momentum"],
            "weight_decay": traffic["weight_decay"]}


def plan_indices(plan) -> list:
    """A port plan's indices in the reference's order (``plan_indices``)."""
    return [t for level in plan for t in (level.fps_idx, level.down_idx, level.nbr_idx,
                                          level.up_idx) if t is not None]


class Step:
    def __init__(self, port, inputs: dict, options: dict):
        del options  # the model has its published sizes alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        models = importlib.import_module(port.__name__ + ".models")
        device = inputs["clouds"][0]["xyz"].device
        self.model = models.PointTransformerSeg(**inputs["arch"]).to(device).train()
        self.model.load_state_dict(inputs["weights"])
        # The weights and buffers themselves, by dtype, and their set-up copies.
        live = {}
        for t in self.model.state_dict().values():
            live.setdefault(t.dtype, []).append(t)
        self.live = list(live.values())
        self.saved = [[t.clone() for t in group] for group in self.live]
        self.opt = torch.optim.SGD(self.model.parameters(), lr=inputs["lr"],
                                   momentum=inputs["momentum"],
                                   weight_decay=inputs["weight_decay"])
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
            logits = self.model(c["xyz"], c["feats"], c["lengths_host"], plan)
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


def dense_flops(lengths: list, arch: dict) -> int:
    """Float32 operations (2 a multiply-add) of a training step's Linear
    layers, from the widths and lengths alone: each one's forward and weight
    gradient, and its input gradient where the backward asks for one."""
    return sum(2 * rows * fan_in * fan_out * (3 if grad_in else 2)
               for _, fan_in, fan_out, _, rows, grad_in in linears(lengths, arch))


def gathers(lengths: list, arch: dict) -> list:
    """Every gather whose backward (the scatter) runs in ``port.bwd``:
    (entries, channels, target rows). An attention layer gathers its k and v
    together (2C channels) by its level's self-KNN; a ``TransitionDown`` the
    level above's features by its KNN there; a ``TransitionUp`` the coarser
    level's features (at this level's width) by the 3 nearest."""
    T = level_counts(lengths, arch)
    planes = arch["planes"]
    out = []
    for i, (C, K) in enumerate(zip(planes, arch["nsample"])):
        out += [(T[i] * K, 2 * C, T[i])] * (arch["blocks"][i] + 1)
        if arch["strides"][i] > 1:
            out.append((T[i] * K, planes[i - 1], T[i - 1]))
        if i < len(planes) - 1:
            out.append((T[i] * UP_K, C, T[i + 1]))
    return out


def work_counts(inputs: dict, options: dict) -> dict:
    """The Linear layers' work a step, for ``mfu``; the gathers' backward,
    for ``gather_bwd_roofline``: a float32 add an entry and channel, each
    entry's contribution and int64 index read once, each target row
    written once."""
    del options
    lengths, arch = inputs["clouds"][0]["lengths_host"], inputs["arch"]
    g = gathers(lengths, arch)
    return {"dense": {"span": "step", "ops": dense_flops(lengths, arch),
                      "bytes": 0},
            "gather_bwd": {"span": "port.bwd", "ops": sum(e * c for e, c, _ in g),
                           "bytes": sum(work.F32 * c * (e + r) + work.I64 * e for e, c, r in g)}}


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def _weighted_gap(got: torch.Tensor, ref: torch.Tensor, weight: torch.Tensor) -> float:
    return float(((got - ref) * weight).norm() / (ref * weight).norm())


def _norm(tensors: dict) -> torch.Tensor:
    return torch.cat([t.double().flatten() for t in tensors.values()]).norm()


def compare(got: dict, ref: dict, exact: dict) -> dict:
    """A run's first step against the reference's (``first_step``): the
    plan indices that differ over every pool entry; the largest logit gap
    over the largest logit; the loss gap over the loss; the gradient gap
    over its norm; ``update_gap``, the worst parameter's gap of SGD's first
    update; ``stats_gap``, the worst running statistic's gap of its change
    over the step, over the reference's change. A state left as it was
    reads 1 in the last two, an update of the wrong sign 2.

    Many parameters have a gradient that is zero in exact arithmetic: every
    bias ahead of a batch norm, and the last bias of each attention's
    weight encoding, which the softmax over the neighbours takes away. Their
    float32 gradient is rounding alone, so SGD moves them by lr times that
    rounding beside the weight decay's lr x 1e-4 x p. ``update_gap`` leaves
    out the parameters whose float64 gradient is zero (below 1e-9 of the
    whole gradient's root mean square) and weighs each entry of the others
    by the size of its float64 gradient."""
    mismatch = 0
    for g_step, r_step in zip(got["plans"], ref["plans"], strict=True):
        for a, b in zip(g_step, r_step, strict=True):
            mismatch += int((a != b).sum()) if a.shape == b.shape else b.numel()
    g, r = got["grad"], ref["grads"]
    grad_gap = float(_norm({n: g[n].double() - r[n].double() for n in r}) / _norm(r))
    scale = float(_norm(exact)) / sum(t.numel() for t in exact.values()) ** 0.5
    update = [_weighted_gap(got["change"][n], ref["change"][n], exact[n].abs())
              for n, e in exact.items() if float(e.norm()) > 1e-9 * scale * e.numel() ** 0.5]
    stats = [float((got["change"][n] - c).norm() / c.norm())
             for n, c in ref["change"].items() if n not in exact and float(c.norm()) > 0]
    return {
        "plan_mismatch": mismatch,
        "logits_gap": _gap(got["logits"], ref["logits"]),
        "loss_gap": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        "grad_gap": grad_gap,
        "update_gap": max(update),
        "stats_gap": max(stats),
    }


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


class _ChannelSoftmax:
    """``torch.nn.functional`` with its softmax taken over the last axis
    (the channels) whatever axis is asked for."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def softmax(x, dim=None, **kwargs):
        return F.softmax(x, dim=-1, **kwargs)


def plant(name: str, port):
    """Break the timed path with fault ``name`` (``faults.py``):
    ``stale_state`` zeroes the gathers' backward (``masked_gather``'s
    scatter), so every layer ahead of a gather gets a wrong gradient and
    its k and v maps none; ``altered_answer`` takes each attention's softmax
    over the channels in place of the neighbours; ``half_batch`` runs the
    first half of the clouds alone and gives the other clouds' points its
    logits."""
    model = faults.module(port, "models.point_transformer")
    if name == "stale_state":
        def zero(idx, contrib, P2):
            return contrib.new_zeros((contrib.shape[0], P2, contrib.shape[2]))
        return faults.patched(faults.module(port, "ops.knn"), "_scatter_rows", zero)
    if name == "altered_answer":
        return faults.patched(model, "F", _ChannelSoftmax())
    if name == "half_batch":
        cls = model.PointTransformerSeg
        real = cls.forward

        def forward(self, xyz, feats, lengths_host, plan=None):
            h = xyz.shape[0] // 2
            half = real(self, xyz[:h], feats[:h], list(lengths_host)[:h])
            total = sum(int(n) for n in lengths_host)
            return half[torch.arange(total, device=xyz.device) % half.shape[0]]
        return faults.patched(cls, "forward", forward)
    raise ValueError(f"point_transformer_seg cells cannot have fault {name!r}")
