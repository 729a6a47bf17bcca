"""Helpers of the per-layer readers (``metrics/``): which kernels are B1,
the steps a traced stretch walked, and the work of a walk's batch."""

from __future__ import annotations

from portbench.costs import condensed


def is_b1(name: str) -> bool:
    """B1, the packed score kernel (bf16 ``wgmma`` or f32), by kernel name."""
    return "packed_score" in name and "int8" not in name and "selftest" not in name


def walk_steps(walks: list) -> int:
    """Steps walked by ``walks`` (a retried walk walks twice)."""
    return sum(w.steps for w in walks)


def walk_cost(ctx: dict, w) -> dict:
    """One step's work on the real graphs of walk ``w`` (all members)."""
    cfg = ctx["spec"]["config"]
    sizes = [len(g["atom_type"]) for g in w.rows[: w.real]]
    return condensed.batch_cost(sizes, cfg["hidden_dim"], cfg["num_convs"],
                                ctx["cell"].n_members, 2 if cfg["dtype"] == "bfloat16" else 4)
