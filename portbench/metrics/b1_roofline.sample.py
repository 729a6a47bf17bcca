"""B1's share of its roofline over the traced walks, in percent: the least
time the real graphs' work needs (``costs/condensed.py``: the larger of its
flops at 989 TFLOP/s and its bytes at 3.35 TB/s, per step, summed over the
steps walked) over B1's device time in the trace."""

from portbench import common, layers, trace
from portbench.costs import condensed


def read(ctx):
    tr = ctx["trace"]
    walks = ctx["window"]["traced"]
    if not tr or not walks:
        return None
    b1 = sum(trace.seconds_by_name(tr["kernels"], layers.is_b1).values())
    if b1 <= 0:
        return None
    need = sum(w.steps * condensed.least_seconds(layers.walk_cost(ctx, w),
                                                 common.PEAK_BF16_FLOPS, common.PEAK_BYTES)
               for w in walks)
    return 100.0 * need / b1
