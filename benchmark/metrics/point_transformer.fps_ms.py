"""point_transformer.fps_ms: device time a step, in ms, of the FPS kernels
(``csrc/fps.cu``: ``fps_grid_kernel``, which the resident and streaming
entry points launch, and ``fps_block_kernel``) launched inside the
``port.plan`` span, over the profiled steps of a ``--trace 1`` run. None
where no FPS kernel ran there."""

import re

FPS = re.compile(r"\b(fps_grid_kernel|fps_block_kernel)\b")


def read(ctx):
    if ctx.trace is None or not ctx.profiled_steps:
        return None
    us = sum(a.dur_us for a in ctx.trace.activities
             if a.span == "port.plan" and FPS.search(a.name))
    return us / 1e3 / ctx.profiled_steps if us > 0 else None
