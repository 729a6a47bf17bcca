"""The whole walk step's share of the card's bf16 peak, in percent, in the
DimeNet++ cell: the network's flops on the real atoms, pairs and triplets
(``costs/dimenetpp.py``, from the counters the program's ensemble kept for
each traced walk's batch) summed over every step of the traced walks, over
the traced stretch's time and 989 TFLOP/s.  Nothing where the program kept
no counters."""

from portbench import common
from portbench.costs import dimenetpp


def read(ctx):
    tr = ctx["trace"]
    walks = ctx["window"]["traced"]
    if not tr or not walks or not all(getattr(w, "counts", None) for w in walks):
        return None
    w = dimenetpp.widths(ctx["spec"]["config"])
    flops = sum(x.steps * dimenetpp.step_flops(x.counts[0], x.counts[2], x.counts[4], w)
                for x in walks)
    return 100.0 * flops / tr["window_s"] / common.PEAK_BF16_FLOPS
