"""Device ms per walk step of the dual encoder's walk (every kernel), over
the traced walks."""

from portbench import layers, trace


def read(ctx):
    tr = ctx["trace"]
    steps = layers.walk_steps(ctx["window"]["traced"])
    if not tr or not steps:
        return None
    return 1e3 * sum(trace.seconds_by_name(tr["kernels"]).values()) / steps
