"""The work counts of ``costs/condensed.py``: one small reaction by hand,
and never above the port's own count of B1 at the padded shape."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.costs import condensed  # noqa: E402


def test_one_small_reaction_by_hand():
    # 3 atoms, H = 4, L = 1, one member: 3 pairs, 3 atoms
    # per pair: 2H + 2H^2 (distance MLP) + 2 (4H^2 + 2H^2) (edge_cat twice)
    #   + L (4H^2 + 4H) (filter, messages) + 4H^2 + H^2 + H (head)
    #   = 8 + 32 + 192 + 80 + 64 + 16 + 4 = 396
    # per atom: L 6 H^2 = 96
    assert condensed.pair_flops(4, 1) == 396
    assert condensed.atom_flops(4, 1) == 96
    cost = condensed.batch_cost([3], 4, 1, members=1, elem_bytes=2)
    assert cost["flops"] == 3 * 396 + 3 * 96
    weights = (4 + 4 + 16 + 4) + 100 * 4 + (32 + 4 + 16 + 4) + (5 * 16 + 4 * 4) \
        + (32 + 4 + 8 + 2 + 2 + 1)
    assert condensed.weight_count(4, 1) == weights
    assert cost["bytes"] == weights * 2 + 3 * 24 + 3 * 4 + 3 * 4 * 2


@pytest.mark.parametrize("n_bucket", [8, 16, 24])
@pytest.mark.parametrize("sizes", [lambda N: [N] * 4, lambda N: [N - 5, N - 1, 6, N]])
def test_never_above_the_ports_count_at_the_padded_shape(n_bucket, sizes):
    from tsdiff_tpu_torch.ops.packed_score import packed_score_cost

    H, L, M = 256, 7, 8
    sizes = [max(2, min(n, n_bucket)) for n in sizes(n_bucket)]
    ours = condensed.batch_cost(sizes, H, L, M)
    z = torch.empty(M, len(sizes), n_bucket, H, dtype=torch.bfloat16, device="meta")
    weights = {"w": torch.empty(M * condensed.weight_count(H, L), dtype=torch.bfloat16,
                                device="meta")}
    theirs = packed_score_cost(weights, z, L)
    assert ours["flops"] <= theirs["flops"]
    assert ours["bytes"] <= theirs["bytes"]
