"""ops.issue_ms: host time from a step's start until its last call into the
port returns (the end of its last ``port.*`` span), before the loss is
read; the mean over the traced run's unprofiled window steps, in ms. The
time the entry points, ``Pointclouds`` and the autograd Functions keep the
host, launches and their syncs included."""


def read(ctx):
    ends = [max(e for name, _, e in spans if name.startswith("port."))
            for spans in ctx.spans if any(n.startswith("port.") for n, _, _ in spans)]
    return 1e3 * sum(ends) / len(ends) if ends else None
