"""Symmetric-pair packing in OFFSET layout.

Every per-pair tensor of the condensed TS model is symmetric in (i, j), so a
dense (B, N, N) pair grid does every pair MLP twice.  Packed row (k, i) for
k = 1..K (K = N // 2) stands for the unordered pair {i, (i+k) mod N}.  Each
unordered pair appears once, except at offset k = K (N even), where rows
(K, i) and (K, i+K) are duplicates; sum-aggregations scale that slab by 0.5
(``half_last_slab_mask``).

Sum-aggregations over pairs become circular rolls along the node axis::

    agg = sum_k  roll(w_k * xh, +k)  +  w_k * roll(xh, -k)

Layout everywhere: packed arrays are (B, K, N, ...) with
``packed[b, k-1, i] = dense[b, i, (i+k) % N]``.
"""

from __future__ import annotations

import dataclasses

import torch


def packed_index_arrays(n: int, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) index arrays of shape (K, N): packed (k, i) <-> dense
    (rows[k,i], cols[k,i]) = (i, (i+k+1) % n)."""
    if n % 2:
        raise ValueError(f"offset packing requires even N, got {n}")
    k = n // 2
    rows = torch.arange(n, device=device).expand(k, n)
    cols = (rows + torch.arange(1, k + 1, device=device)[:, None]) % n
    return rows, cols


def pack_pairs(dense: torch.Tensor) -> torch.Tensor:
    """(B, N, N, ...) -> (B, K, N, ...) offset-packed."""
    rows, cols = packed_index_arrays(dense.shape[1], dense.device)
    return dense[:, rows, cols]


def unpack_pairs(packed: torch.Tensor, fill=0) -> torch.Tensor:
    """(B, K, N, ...) -> symmetric (B, N, N, ...); the diagonal gets ``fill``."""
    b, k, n = packed.shape[:3]
    rows, cols = packed_index_arrays(n, packed.device)
    out = torch.full((b, n, n, *packed.shape[3:]), fill, dtype=packed.dtype, device=packed.device)
    out[:, rows, cols] = packed
    out[:, cols, rows] = packed
    return out


def half_last_slab_mask(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(K, 1) multiplier: 1 everywhere, 0.5 on the k = N/2 slab."""
    m = torch.ones((n // 2, 1), dtype=dtype, device=device)
    m[-1] = 0.5
    return m


def packed_diff(pos: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, K, N, 3): diff[k-1, i] = pos[i] - pos[(i+k) % N]."""
    n = pos.shape[1]
    return torch.stack(
        [pos - torch.roll(pos, -k, dims=1) for k in range(1, n // 2 + 1)], dim=1
    )


def packed_valid_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B, K, N) bool: both endpoints are real atoms."""
    n = node_mask.shape[1]
    return torch.stack(
        [node_mask & torch.roll(node_mask, -k, dims=1) for k in range(1, n // 2 + 1)],
        dim=1,
    )


def packed_distance(pos: torch.Tensor, pmask: torch.Tensor) -> torch.Tensor:
    """Masked packed pair distances; entries outside ``pmask`` are 1.0."""
    diff = packed_diff(pos)
    sq = (diff * diff).sum(dim=-1)
    one = torch.ones_like(sq)
    safe = torch.clamp(torch.where(pmask, sq, one), min=1e-24)
    return torch.where(pmask, torch.sqrt(safe), one)


@dataclasses.dataclass(frozen=True)
class PackedPairs:
    """Offset-packed, position-independent typed pair structures; computed
    once per batch."""

    mask_local_in: torch.Tensor   # (B, K, N) bool
    type_r_in: torch.Tensor       # (B, K, N) int32
    type_p_in: torch.Tensor
    mask_local_out: torch.Tensor
    type_r_out: torch.Tensor
    type_p_out: torch.Tensor


def pack_static_pairs(sp) -> PackedPairs:
    """core.graph_ops.StaticPairs (dense) -> PackedPairs (offset layout);
    the type tensors become contiguous int32, as the score kernel reads them."""

    def types(t):
        return pack_pairs(t).to(torch.int32).contiguous()

    return PackedPairs(
        mask_local_in=pack_pairs(sp.mask_local_in),
        type_r_in=types(sp.type_r_in),
        type_p_in=types(sp.type_p_in),
        mask_local_out=pack_pairs(sp.mask_local_out),
        type_r_out=types(sp.type_r_out),
        type_p_out=types(sp.type_p_out),
    )


def eq_transform_packed(
    score_p: torch.Tensor,   # (B, K, N) packed per-pair distance scores
    pos: torch.Tensor,       # (B, N, 3)
    m_eq: torch.Tensor,      # (B, K, N) float edge mask WITH the 0.5 K-slab factor
    d_safe: torch.Tensor,    # (B, K, N) masked packed distances
) -> torch.Tensor:
    """Distance scores -> per-atom score vectors.  For symmetric scores,
    ``score_pos[i] = sum_j 2 m_ij s_ij (r_i - r_j) / d_ij``; packed row (k, i)
    contributes +2ws*diff at node i and -2ws*diff at node (i+k) % N."""
    w = 2.0 * m_eq * score_p / d_safe
    out = torch.zeros_like(pos)
    n = pos.shape[1]
    for k in range(1, n // 2 + 1):
        diff = pos - torch.roll(pos, -k, dims=1)
        c = w[:, k - 1, :, None] * diff
        out = out + c - torch.roll(c, k, dims=1)
    return out
