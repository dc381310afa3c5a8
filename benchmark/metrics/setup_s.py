"""setup_s: process start to the first timed step, in s (host clock):
imports, the CUDA context, loading (and in a fresh checkout building) the
port's kernels, inputs made on the device, the first pass that the check
reads, and warm-up over every shape the cell uses."""


def read(ctx):
    return ctx.setup_s
