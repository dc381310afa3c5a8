"""``pointnet2_ssg``: training PointNet++ SSG classification (Qi et al. 2017,
``models/pointnet2_cls_ssg.py``) on the port's model,
``pytorch3d_pointops_tpu_torch.models.PointNet2ClsSSG``, float32, TF32 off.

A step: ``model.plan(xyz, lengths)`` (FPS and ball query of SA1 and SA2,
``port.plan``), ``model(xyz, lengths, plan, generator)`` (``port.fwd``),
cross-entropy (``user.loss``), the backward (``port.bwd``), Adam (torch's
fused kernel, ``user.update``), and the loss read to the host (``read``). On a
card the loss is copied to pinned host memory as soon as it is computed, and
the read waits for that copy alone, not for the backward and the update queued
behind it: a loop that logs its loss each step without draining the card's
queue. (Read by ``loss.item()`` after the update, every step would open on
an idle card while the host issues the next plan, 1.6-2.3 ms on an H100, and
the step's time would follow the host's speed.) Step j takes input set ``j % entries`` of the
pool. Every pass over the pool starts from
the set-up's weights, batch norm buffers and Adam state, copied back in
place, and from the dropout generator seeded again (``user.reset``), so
every pass repeats the first bit for bit.

The check holds the first step to the plain reference
(``reference/pointnet2_ssg.py``), which runs it on its own from the inputs:
every pool entry's plan indices (FPS and ball query of both levels; exact),
the first step's logits, loss and whole gradient, Adam's first update of
each parameter, and each batch norm's running statistics after the step.
Later steps are held to the first pass bit for bit (the harness), not to
the reference: from the second step on two float32 runs of this network
part (``compare``).

Traffic keys: ``pool``, ``lr``, ``clouds`` (a cloud spec of ``clouds.py``:
its Gaussians are made unit length, jittered by N(0, sigma^2) clipped at
``jitter["clip"]`` as PointNet++'s ``jitter_point_cloud``, then centred and
scaled to unit radius as its ``pc_normalize``; padding stays 0).
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

from benchmark import clouds, faults, work

CLASSES = 40  # ModelNet40
# The published network: (level, input feature channels, shared MLP widths).
LEVELS = (("sa1", 0, (64, 64, 128)), ("sa2", 128, (128, 128, 256)),
          ("sa3", 256, (256, 512, 1024)))
HEAD = (1024, 512, 256)
NPOINTS, NSAMPLES = (512, 128), (32, 64)  # FPS centres and group sizes of SA1 and SA2


def make_weights(dev: torch.Generator, device) -> dict:
    """Weights under the model's ``state_dict`` names: each Linear's weight
    and bias uniform in +-1/sqrt(fan_in) (torch's default bound), each
    batch norm's scale 1, shift 0, running mean 0 and variance 1."""
    w = {}

    def linear(name, fan_in, fan_out):
        bound = fan_in ** -0.5
        for key, shape in (("weight", (fan_out, fan_in)), ("bias", (fan_out,))):
            w[f"{name}.{key}"] = (torch.rand(shape, generator=dev, device=device) * 2 - 1) * bound

    def norm(name, width):
        w[f"{name}.weight"] = torch.ones(width, device=device)
        w[f"{name}.bias"] = torch.zeros(width, device=device)
        w[f"{name}.running_mean"] = torch.zeros(width, device=device)
        w[f"{name}.running_var"] = torch.ones(width, device=device)
        w[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)

    for level, features, widths in LEVELS:
        fan_in = 3 + features
        for i, width in enumerate(widths):
            linear(f"{level}.linears.{i}", fan_in, width)
            norm(f"{level}.norms.{i}", width)
            fan_in = width
    for k, (fan_in, width) in enumerate(zip(HEAD, HEAD[1:]), start=1):
        linear(f"fc{k}", fan_in, width)
        norm(f"bn{k}", width)
    linear("fc3", HEAD[-1], CLASSES)
    return w


def make_clouds(spec: dict, jitter: dict, dev: torch.Generator, device):
    """Padded (N, P, 3) clouds on the unit sphere, jittered and normalised
    over each cloud's valid points, and their host lengths."""
    pts, lengths = clouds.cloud(spec, dev, device)
    mask = clouds.pad_mask(lengths, spec["points"], device)
    norm = pts.norm(dim=-1, keepdim=True)
    pts = pts / torch.where(norm > 0, norm, 1.0)
    noise = torch.randn(pts.shape, generator=dev, device=device) * jitter["sigma"]
    pts = (pts + noise.clamp(-jitter["clip"], jitter["clip"])) * mask
    count = torch.tensor(lengths, device=device, dtype=torch.float32)[:, None, None]
    pts = (pts - pts.sum(dim=1, keepdim=True) / count) * mask
    return pts / pts.norm(dim=-1).amax(dim=1)[:, None, None], lengths


def make_inputs(traffic: dict, dev, host, device) -> dict:
    spec = traffic["clouds"]
    sets = []
    for _ in range(traffic["pool"]):
        xyz, lengths = make_clouds(spec, traffic["jitter"], dev, device)
        labels = torch.randint(0, CLASSES, (spec["batch"],), generator=host)
        sets.append({"xyz": xyz, "lengths": torch.tensor(lengths, device=device),
                     "lengths_host": lengths, "labels": labels.to(device)})
    return {"clouds": sets, "weights": make_weights(dev, device), "lr": traffic["lr"],
            "dropout_seed": int(torch.randint(0, 2**62, (1,), generator=host))}


class Step:
    def __init__(self, port, inputs: dict, options: dict):
        del options  # the model has its published sizes alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        models = importlib.import_module(port.__name__ + ".models")
        device = inputs["clouds"][0]["xyz"].device
        self.model = models.PointNet2ClsSSG().to(device).train()
        self.model.load_state_dict(inputs["weights"])
        # The weights and buffers themselves, by dtype, and their set-up copies.
        live = {}
        for t in self.model.state_dict().values():
            live.setdefault(t.dtype, []).append(t)
        self.live = list(live.values())
        self.saved = [[t.clone() for t in group] for group in self.live]
        self.opt = torch.optim.Adam(self.model.parameters(), lr=inputs["lr"], fused=True)
        self.gen = torch.Generator(device=device)
        self.ready = torch.cuda.Event() if device.type == "cuda" else None
        self.loss_host = torch.empty((), pin_memory=self.ready is not None)
        self.seed = inputs["dropout_seed"]
        self.sets = inputs["clouds"]
        self.entries = len(self.sets)
        # What the first pass leaves for the check: each step's plan; the
        # first step's logits, loss, gradient and the state after it.
        self.first = {"plans": []}

    def _reset(self):
        with torch.no_grad():
            for live, saved in zip(self.live, self.saved):
                torch._foreach_copy_(live, saved)
            state = [t for s in self.opt.state.values() for t in s.values()]
            if state:
                torch._foreach_zero_(state)
        self.gen.manual_seed(self.seed)

    def __call__(self, j: int, span) -> float:
        i = j % self.entries
        if i == 0:
            with span("user.reset"):
                self._reset()
        c = self.sets[i]
        with span("port.plan"):
            plan = self.model.plan(c["xyz"], c["lengths"])
        with span("port.fwd"):
            logits = self.model(c["xyz"], c["lengths"], plan, self.gen)
        with span("user.loss"):
            loss = F.cross_entropy(logits, c["labels"])
            self.loss_host.copy_(loss.detach(), non_blocking=True)
            if self.ready is not None:
                self.ready.record()
        with span("port.bwd"):
            loss.backward()
        if j == 0:
            self.first["grad"] = {n: p.grad.clone() for n, p in self.model.named_parameters()}
        with span("user.update"):
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
        with span("read"):
            if self.ready is not None:
                self.ready.synchronize()
            value = self.loss_host.item()
        if j < self.entries:
            self.first["plans"].append([t.clone() for level in plan
                                        for t in (level.fps_idx, level.group_idx)])
        if j == 0:
            self.first["logits"] = logits.detach().clone()
            self.first["loss"] = value
            self.first["after"] = {n: t.clone() for n, t in self.model.state_dict().items()}
        return value


def dense_flops(batch: int) -> int:
    """Float32 operations (2 a multiply-add) of a training step's shared MLP
    and FC layers, from the widths and shapes alone: the forward, then the
    backward's weight and input gradients, less SA1's first layer's input
    gradient (nothing asks for the xyz's)."""
    positions = (NPOINTS[0] * NSAMPLES[0], NPOINTS[1] * NSAMPLES[1], NPOINTS[1])
    macs = 0
    for (_, features, widths), rows in zip(LEVELS, positions):
        chans = (3 + features, *widths)
        macs += rows * sum(a * b for a, b in zip(chans, chans[1:]))
    head = (*HEAD, CLASSES)
    macs += sum(a * b for a, b in zip(head, head[1:]))
    xyz_grad = positions[0] * 3 * LEVELS[0][2][0]
    return 2 * batch * (3 * macs - xyz_grad)


def work_counts(inputs: dict, options: dict) -> dict:
    """The dense layers' work a step, for ``mfu``; the gather's backward
    (SA2's grouping of SA1's features: the scatter of every grouped
    feature row into its point's row), for ``gather_bwd_roofline``: a
    float32 add an entry and channel; the contributions and their int64
    indices read once, the gradient of SA1's features written once."""
    del options
    batch = inputs["clouds"][0]["xyz"].shape[0]
    entries, rows, channels = batch * NPOINTS[1] * NSAMPLES[1], batch * NPOINTS[0], LEVELS[1][1]
    return {"dense": {"span": "step", "ops": dense_flops(batch), "bytes": 0},
            "gather_bwd": {"span": "port.bwd", "ops": entries * channels,
                           "bytes": work.F32 * channels * (entries + rows) + work.I64 * entries}}


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def _weighted_gap(got: torch.Tensor, ref: torch.Tensor, weight: torch.Tensor) -> float:
    return float(((got - ref) * weight).norm() / (ref * weight).norm())


def compare(got: dict, ref: dict, exact: dict) -> dict:
    """A run's first step against the reference's (``first_step``): the
    plan indices that differ over every pool entry; the largest logit gap
    over the largest logit; the loss gap over the loss; the gradient gap
    over its norm; ``update_gap``, the worst parameter's gap of Adam's
    first update; ``stats_gap``, the worst running statistic's gap of its
    change over the step, over the reference's change. A state left as it
    was reads 1 in the last two, an update of the wrong sign 2.

    Adam's first update moves an entry by lr times the sign of its
    gradient, whatever its size. So an entry whose gradient is zero up to
    rounding moves either way, and a float32 gradient reads zero only up to
    a tenth of the rest (``exact_gradient``). ``update_gap`` therefore
    leaves out the parameters whose float64 gradient is zero (below 1e-9 of
    the whole gradient's root mean square: the biases ahead of a batch norm,
    and SA3's last batch norm shift, whose every output the head's batch
    norm takes away), and weighs each entry of the others by the size of its float64
    gradient, so an entry near zero, or near a tie of a group's maximum,
    counts as little as it moves the loss.

    The logits and the loss are continuous in the parameters and read to
    rounding. The gradient is not: a max over a group sends a channel's
    gradient to its largest point, and where two points tie to within
    rounding either may take it, so its limit catches a wrong backward, not
    a lower precision (``PERF.md`` §2). Later steps are not compared: two
    float32 runs of this network in two summation orders, equal to 3e-6 at
    the first step, are 1e-3 apart in the logits at the second and 0.1 or
    more by the fourth (the float32 rounding of the parameters left out
    above is not taken away, and Adam moves those by lr either way)."""
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
             for n, c in ref["change"].items() if n not in exact]
    return {
        "plan_mismatch": mismatch,
        "logits_gap": _gap(got["logits"], ref["logits"]),
        "loss_gap": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        "grad_gap": grad_gap,
        "update_gap": max(update),
        "stats_gap": max(stats),
    }


def _norm(tensors: dict) -> torch.Tensor:
    return torch.cat([t.double().flatten() for t in tensors.values()]).norm()


def check(step: Step, inputs: dict, ref, first_losses, host) -> dict:
    del first_losses, host  # every pass repeats the first; the harness holds the window to it
    got = dict(step.first)
    start = inputs["weights"]
    got["change"] = {n: got["after"][n].double() - start[n].double() for n in got["after"]}
    return compare(got, ref.first_step(inputs), ref.exact_gradient(inputs))


def control(inputs: dict, ref, host) -> dict:
    """The numbers the control reads: the reference with its matrix
    products in TF32 in the program's place."""
    del host
    ctl = ref.first_step(inputs, tf32=True)
    return compare(dict(ctl, grad=ctl["grads"]), ref.first_step(inputs),
                   ref.exact_gradient(inputs))


FAULTS = ("stale_state", "altered_answer", "half_batch")


def plant(name: str, port):
    """Break the timed path with fault ``name`` (``faults.py``):
    ``stale_state`` zeroes the gather's backward (``masked_gather``'s
    scatter), so SA1 gets no gradient and Adam leaves it where it was;
    ``altered_answer`` leaves the empty ball slots at -1, so their grouped
    points are zero rows and not the group's first neighbour;
    ``half_batch`` runs the first half of the clouds alone and gives the
    others its logits."""
    if name == "stale_state":
        def zero(idx, contrib, P2):
            return contrib.new_zeros((contrib.shape[0], P2, contrib.shape[2]))
        return faults.patched(faults.module(port, "ops.knn"), "_scatter_rows", zero)
    if name == "altered_answer":
        return faults.patched(faults.module(port, "models.pointnet2"), "fill_empty_slots",
                              lambda idx: idx)
    if name == "half_batch":
        cls = faults.module(port, "models.pointnet2").PointNet2ClsSSG
        real = cls.forward

        def forward(self, xyz, lengths=None, plan=None, generator=None):
            h = xyz.shape[0] // 2
            half = real(self, xyz[:h], None if lengths is None else lengths[:h], None, generator)
            return half[torch.arange(xyz.shape[0], device=xyz.device) % h]
        return faults.patched(cls, "forward", forward)
    raise ValueError(f"pointnet2_ssg cells cannot have fault {name!r}")
