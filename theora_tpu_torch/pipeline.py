"""UMV border replication.

Port of `fill_borders` in theora_tpu/pipeline.py (state.c:770-835).
"""
from __future__ import annotations

import torch


def fill_borders(plane: torch.Tensor, h: int, w: int, vpad: int,
                 hpad: int) -> torch.Tensor:
    """Replicate the picture edges of a padded [h+2*vpad, w+2*hpad] plane
    (or of each of a [G, h+2*vpad, w+2*hpad] stack) into its border, in
    place (saves a plane copy per frame); returns the plane."""
    lead = plane.shape[:-2]
    wp = plane.shape[-1]
    rows = slice(vpad, vpad + h)
    plane[..., rows, :hpad] = plane[..., rows, hpad:hpad + 1].expand(
        *lead, h, hpad)
    plane[..., rows, hpad + w:] = plane[..., rows, hpad + w - 1:hpad + w
                                        ].expand(*lead, h, hpad)
    plane[..., :vpad, :] = plane[..., vpad:vpad + 1, :].expand(
        *lead, vpad, wp)
    plane[..., vpad + h:, :] = plane[..., vpad + h - 1:vpad + h, :].expand(
        *lead, vpad, wp)
    return plane
