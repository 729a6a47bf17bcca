"""Device ms per walk step of every kernel but B1 (the packed distances and
masks, the member mean, the chain rule, the update), over the traced walks."""

from portbench import layers, trace


def read(ctx):
    tr = ctx["trace"]
    steps = layers.walk_steps(ctx["window"]["traced"])
    if not tr or not steps:
        return None
    glue = trace.seconds_by_name(tr["kernels"], lambda n: not layers.is_b1(n))
    return 1e3 * sum(glue.values()) / steps
