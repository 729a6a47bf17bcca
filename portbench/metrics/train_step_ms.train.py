"""Device ms per train step (every kernel of the captured step: the packed
forward and backward on torch ops, the clip and Adam), over the traced
steps."""

from portbench import trace


def read(ctx):
    tr = ctx["trace"]
    steps = ctx["window"].get("traced_steps", 0)
    if not tr or not steps:
        return None
    return 1e3 * sum(trace.seconds_by_name(tr["kernels"]).values()) / steps
