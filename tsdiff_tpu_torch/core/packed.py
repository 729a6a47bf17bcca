"""Symmetric-pair packing in OFFSET layout.

Every per-pair tensor of the condensed TS model is symmetric in (i, j), so a
dense (B, N, N) pair grid does every pair MLP twice.  Packed row (k, i) for
k = 1..K (K = N // 2) stands for the unordered pair {i, (i+k) mod N}.  Each
unordered pair appears once, except at offset k = K (N even), where rows
(K, i) and (K, i+K) are duplicates; sum-aggregations scale that slab by 0.5
(``half_last_slab_mask``).

Sum-aggregations over pairs become circular rolls along the node axis::

    agg = sum_k  roll(w_k * xh, +k)  +  w_k * roll(xh, -k)

Here the rolls of all K offsets are taken at once, each direction one
gather through the index tables of ``offset_index_tables``.

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


_TABLES: dict[tuple[int, torch.device], tuple[torch.Tensor, ...]] = {}


def offset_index_tables(n: int, device="cpu") -> tuple[torch.Tensor, ...]:
    """``(minus, plus, unroll)``, flattened (K * N,) int64 gather indices for
    the offsets k = 1..K: ``minus[(k-1) * N + i] = (k-1) * N + (i - k) mod N``
    indexes the flattened (K, N) axis of a packed tensor, giving
    ``roll(x_k, k)`` for every k; ``unroll``, its inverse permutation, gives
    ``roll(x_k, -k)``; ``plus[(k-1) * N + i] = (i + k) mod N`` indexes the
    node axis, giving ``roll(x, -k)``.  Made once per (N, device)."""
    key = (n, torch.device(device))
    if key not in _TABLES:
        k = torch.arange(1, n // 2 + 1)[:, None]
        i = torch.arange(n)[None, :]
        plus = (i + k) % n
        tables = ((k - 1) * n + (i - k) % n, plus, (k - 1) * n + plus)
        _TABLES[key] = tuple(t.reshape(-1).to(device) for t in tables)
    return _TABLES[key]


def roll_offsets(x: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) -> (B, K, N, ...): ``out[:, k-1] = roll(x, -k)``, so that
    ``out[:, k-1, i] = x[:, (i+k) % N]``, the other end of packed row (k, i)."""
    b, n = x.shape[:2]
    plus = offset_index_tables(n, x.device)[1]
    return x.index_select(1, plus).reshape(b, n // 2, n, *x.shape[2:])


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
    return pos[:, None] - roll_offsets(pos)


def packed_valid_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B, K, N) bool: both endpoints are real atoms."""
    return node_mask[:, None] & roll_offsets(node_mask)


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
    c = w[..., None] * packed_diff(pos)        # (B, K, N, 3)
    b, k, n = c.shape[:3]
    minus = offset_index_tables(n, pos.device)[0]
    # + c_k at node i, - c_k at node (i+k) % N: the second is roll(c_k, k)
    return c.sum(1) - c.reshape(b, k * n, 3).index_select(1, minus).reshape(b, k, n, 3).sum(1)
