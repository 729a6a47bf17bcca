"""The whole walk step's share of the card's bf16 peak, in percent: the
network's flops on the real graphs (``costs/condensed.py``) summed over
every step of the traced walks, over the traced stretch's time and 989
TFLOP/s.  (The window of a traced run also holds the profiler's stop, so
the traced stretch is the time the walks took.)"""

from portbench import common, layers


def read(ctx):
    tr = ctx["trace"]
    walks = ctx["window"]["traced"]
    if not tr or not walks:
        return None
    flops = sum(w.steps * layers.walk_cost(ctx, w)["flops"] for w in walks)
    return 100.0 * flops / tr["window_s"] / common.PEAK_BF16_FLOPS
