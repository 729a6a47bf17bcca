"""Device ms per walk step in NCCL's kernels (by kernel name) on rank 0's
trace of the four-card campaign: the member sum's all-reduce captured in
each step, and each walk's NaN flag and gathered answers.  Nothing where the trace holds
no NCCL kernel."""

from portbench import layers, trace


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def read(ctx):
    tr = ctx["trace"]
    steps = layers.walk_steps(ctx["window"]["traced"])
    if not tr or not steps:
        return None
    nccl = trace.seconds_by_name(tr["kernels"], is_nccl)
    return 1e3 * sum(nccl.values()) / steps if nccl else None
