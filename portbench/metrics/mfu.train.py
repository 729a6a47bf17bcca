"""The whole train step's share of the card's bf16 peak, in percent: the
network's flops on the real graphs (``costs/condensed.py``, one member,
forward and backward counted as three forwards) summed over the traced
steps, over the traced stretch's time and 989 TFLOP/s.  A step's graphs
are counted at the mean flops of a graph of its bucket in the corpus: exact
over whole epochs, in which every graph is trained once."""

from portbench import common
from portbench.costs import condensed


def read(ctx):
    cell, tr = ctx["cell"], ctx["trace"]
    steps = cell.window_steps[: ctx["window"].get("traced_steps", 0)]
    if not tr or not steps:
        return None
    cfg = ctx["spec"]["config"]
    H, L = cfg["hidden_dim"], cfg["num_convs"]
    per_graph = {b: condensed.batch_cost(sizes, H, L, 1)["flops"] / len(sizes)
                 for b, sizes in cell.sizes_by_bucket.items()}
    flops = 3 * sum(real * per_graph[b] for b, real in steps)
    return 100.0 * flops / tr["window_s"] / common.PEAK_BF16_FLOPS
