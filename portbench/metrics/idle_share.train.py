"""The device's idle share of the traced train steps, in percent: 1 - the
union of the kernels' intervals over the traced stretch's time."""

from portbench import trace


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["kernels"]:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(tr["kernels"]) / tr["window_s"])
