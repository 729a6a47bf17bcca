"""Per-atom geometry helpers of the sampling loop."""

from __future__ import annotations

import torch


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
