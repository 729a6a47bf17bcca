"""The work the condensed encoder needs, counted from a batch's own atoms
and pairs and the configuration's widths, not from the padded shape the
program launches.

A member's score on one graph of n atoms is, per unordered pair i < j
(there are n (n - 1) / 2), the distance MLP (1 -> H -> H), the encoder
order's edge_cat (2H -> H -> H), each of the L interactions' filter (H -> H
-> H) and its message into both ends (2 x 2H), the output order's edge_cat,
and the head (2H -> H -> H/2 -> 1); and per atom, each interaction's three
node products (H -> H -> H -> H).  A multiply-add is two flops.  Bytes: the
members' weights read once per launch in the served type, and per pair its
distance, cutoff mask and four edge types (4 bytes each) and each member's
score (4 bytes), per atom each member's node state in the served type.

This is what one launch of the packed score kernel B1 computes for all the
members on a batch (a walk step's whole network); a train step's forward
is the same network for one member, and its forward and backward are
counted as three forwards.
"""

from __future__ import annotations

from collections.abc import Iterable


def pair_flops(H: int, L: int) -> int:
    """Flops of one member on one unordered pair."""
    return (2 * H + 2 * H * H            # distance MLP
            + 2 * (4 * H * H + 2 * H * H)  # edge_cat at both edge orders
            + L * (4 * H * H + 4 * H)      # filters and messages
            + 4 * H * H + H * H + H)       # head


def atom_flops(H: int, L: int) -> int:
    """Flops of one member on one atom: the interactions' node products."""
    return L * 6 * H * H


def weight_count(H: int, L: int, vocab: int = 100) -> int:
    """Parameters of one member that the score reads."""
    return (H + H + H * H + H                      # distance MLP
            + vocab * H                            # bond-type table
            + 2 * H * H + H + H * H + H            # edge_cat
            + L * (5 * H * H + 4 * H)              # interactions
            + 2 * H * H + H + H * (H // 2) + H // 2 + H // 2 + 1)   # head


def batch_cost(sizes: Iterable[int], H: int, L: int, members: int,
               elem_bytes: int = 2) -> dict:
    """``{"flops", "bytes"}`` of one launch over graphs of ``sizes`` atoms."""
    sizes = list(sizes)
    pairs = sum(n * (n - 1) // 2 for n in sizes)
    atoms = sum(sizes)
    flops = members * (pairs * pair_flops(H, L) + atoms * atom_flops(H, L))
    nbytes = (members * weight_count(H, L) * elem_bytes
              + pairs * 6 * 4 + members * pairs * 4
              + members * atoms * H * elem_bytes)
    return {"flops": flops, "bytes": nbytes}


def least_seconds(cost: dict, peak_flops: float, peak_bytes: float) -> float:
    """The least time the work needs: the larger of its flops at the peak
    rate and its bytes at the peak bandwidth."""
    return max(cost["flops"] / peak_flops, cost["bytes"] / peak_bytes)
