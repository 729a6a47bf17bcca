"""Dense geometry: pairwise distances, the distance-score chain rule, the
per-atom helpers of the sampling loop, and bond and dihedral angles.

A dense entry (b, i, j) is the directed edge i -> j; every edge set is
symmetric, so both directions are present.
"""

from __future__ import annotations

import torch


def pairwise_diff(pos: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, N, N, 3) with diff[b, i, j] = pos[b, i] - pos[b, j]."""
    return pos[:, :, None, :] - pos[:, None, :, :]


def pairwise_distance(pos: torch.Tensor, emask: torch.Tensor) -> torch.Tensor:
    """Masked pairwise distances (B, N, N).  Entries outside ``emask``
    (the diagonal included) are 1.0, a dummy that keeps ``1/d`` finite; the
    squared distance is floored at 1e-24 so autograd stays NaN-free."""
    diff = pairwise_diff(pos)
    sq = torch.sum(diff * diff, dim=-1)
    one = torch.ones_like(sq)
    safe_sq = torch.clamp(torch.where(emask, sq, one), min=1e-24)
    return torch.where(emask, torch.sqrt(safe_sq), one)


def eq_transform(
    score_d: torch.Tensor,
    pos: torch.Tensor,
    emask: torch.Tensor,
    edge_length: torch.Tensor | None = None,
) -> torch.Tensor:
    """Distance scores -> per-atom score vectors (B, N, 3):

        score_pos[i] = sum_j m_ij (r_i - r_j)/d_ij s_ij + sum_j m_ji (r_i - r_j)/d_ji s_ji

    ``score_d`` is (B, N, N) or (B, N, N, 1); padded atoms get exactly 0."""
    if score_d.dim() == 4:
        score_d = score_d[..., 0]
    if edge_length is None:
        edge_length = pairwise_distance(pos, emask)
    dd_dr = pairwise_diff(pos) / edge_length[..., None]
    w = emask.to(score_d.dtype) * score_d
    return torch.sum(dd_dr * (w + w.transpose(1, 2))[..., None], dim=2)


def center_pos(pos: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Zero the center of mass of each graph over its real atoms; padded rows
    are forced to zero."""
    m = node_mask[..., None].to(pos.dtype)
    count = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    mean = (pos * m).sum(dim=1, keepdim=True) / count
    return (pos - mean) * m


def clip_norm(vec: torch.Tensor, limit: float) -> torch.Tensor:
    """Clip per-atom vector L2 norms to ``limit``."""
    norm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    denom = torch.where(
        norm > limit, limit / torch.clamp(norm, min=1e-30), torch.ones_like(norm)
    )
    return vec * denom


def get_angle(pos: torch.Tensor, angle_index: torch.Tensor) -> torch.Tensor:
    """Angles (A, 1) in radians at the centres of (3, A) index triples
    (left, centre, right) into ``pos`` (n, 3)."""
    n1, ctr, n2 = angle_index
    v1 = pos[n1] - pos[ctr]
    v2 = pos[n2] - pos[ctr]
    inner = torch.sum(v1 * v2, dim=-1, keepdim=True)
    lp = (torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
          * torch.linalg.vector_norm(v2, dim=-1, keepdim=True))
    return torch.arccos(inner / lp)


def get_dihedral(pos: torch.Tensor, dihedral_index: torch.Tensor) -> torch.Tensor:
    """Unsigned dihedral angles (A, 1) in radians of (4, A) index quadruples
    (n1, c1, c2, n2) into ``pos`` (n, 3)."""
    n1, c1, c2, n2 = dihedral_index
    v_ctr = pos[c2] - pos[c1]
    v1 = pos[n1] - pos[c1]
    v2 = pos[n2] - pos[c2]
    m1 = torch.linalg.cross(v_ctr, v1)
    m2 = torch.linalg.cross(v_ctr, v2)
    inner = torch.sum(m1 * m2, dim=-1, keepdim=True)
    lp = (torch.linalg.vector_norm(m1, dim=-1, keepdim=True)
          * torch.linalg.vector_norm(m2, dim=-1, keepdim=True))
    return torch.arccos(inner / lp)
