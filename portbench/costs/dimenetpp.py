"""The work the condensed network with DimeNet++ needs on a batch, counted
from its real atoms, pairs and triplets (the program's counters,
``DenseStatics.counts``) and the configuration's widths, not from the padded
grid the program computes.

Products only, a multiply-add two flops:

* per unordered pair of atoms: the distance MLP (1 -> H -> H), ``edge_cat``
  at both edge orders (2H -> H -> H) and the head (2H -> H -> H/2 -> 1);
* per directed edge (an ordered pair): the embedding block (``rbf`` -> H,
  3H -> H, ``rbf`` -> H); per interaction block ``lin_ji`` and ``lin_kj``
  (H -> H), the radial projection (nr -> basis_emb -> H), down and up (H
  <-> int_emb), the residual layers (2 H -> H each), ``lin`` (H -> H), the
  output block's radial projection (nr -> H), and the block's ``lin_sbf1``
  folded into the edge's radial factor (ns nr -> basis_emb);
* per triplet k -> j -> i and block: the angular sum into the folded
  factor (ns -> basis_emb), ``lin_sbf2`` (basis_emb -> int_emb) and the
  product summed over k (int_emb);
* per atom and output block (one before the blocks, one after each): up
  to ``out_emb``, the output layers, down to H.
"""

from __future__ import annotations


def widths(config: dict) -> dict:
    enc = config["model"]["encoder"]
    return dict(H=config["model"]["hidden_dim"], L=enc["num_convs"],
                I=enc.get("int_emb_size", 64), Bb=enc.get("basis_emb_size", 8),
                O=enc.get("out_emb_channels", 256), ns=enc["num_spherical"],
                nr=enc["num_radial"], before=enc["num_before_skip"],
                after=enc["num_after_skip"], out_layers=enc.get("num_output_layers", 3))


def step_flops(atoms: int, pairs: int, triplets: int, w: dict) -> int:
    """Flops of one member's walk step on ``atoms`` atoms, ``pairs`` ordered
    pairs and ``triplets`` ordered triplets."""
    H, L, I, Bb, O, ns, nr = (w[k] for k in ("H", "L", "I", "Bb", "O", "ns", "nr"))
    per_unordered = (H + H * H) + 2 * (3 * H * H) + (2 * H * H + H * H // 2 + H // 2)
    per_block_edge = (2 * H * H + nr * Bb + Bb * H + 2 * H * I + 2 * H * H * w["before"]
                      + H * H + 2 * H * H * w["after"] + nr * H + ns * nr * Bb)
    per_edge = 2 * nr * H + 3 * H * H + L * per_block_edge
    per_triplet = L * (ns * Bb + Bb * I + I)
    per_atom = (L + 1) * (2 * H * O + w["out_layers"] * O * O)
    return 2 * (pairs // 2 * per_unordered + pairs * per_edge + triplets * per_triplet
                + atoms * per_atom)
