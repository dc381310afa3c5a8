"""step_ms: the measured window's wall time over the steps completed in it,
in ms (host clock). The window runs from the first timed step's start to
the end of the step that crossed ``--seconds``; each step ends with its
loss on the host."""


def read(ctx):
    return 1e3 * ctx.window_s / len(ctx.step_s) if ctx.step_s else None
