"""Device ms per walk step of the condensed network with DimeNet++ (every
kernel of the step: the bases, the triplet passes, the pair-grid products,
the head and the walk's own), over the traced walks."""

from portbench import layers, trace


def read(ctx):
    tr = ctx["trace"]
    steps = layers.walk_steps(ctx["window"]["traced"])
    if not tr or not steps:
        return None
    return 1e3 * sum(trace.seconds_by_name(tr["kernels"]).values()) / steps
