"""Motion compensation by direct gathers from the UMV-padded planes.

Counterpart of theora_tpu/ops/mc_jax.py. The JAX package reformulates MC
as per-fragment neighborhoods and masked shifts because element gathers
are slow on a TPU (mc_jax.py:1-24); a GPU gathers natively, so the port
reads ``ref[pad_y + 8r + i + oy, pad_x + 8c + j + ox]`` straight from the
reference plane (state.c:959-1000, fragment.c:20-80).
"""
from __future__ import annotations

import torch


def block_index_grid(nv: int, nh: int, pad_y: int, pad_x: int, wp: int,
                     device) -> torch.Tensor:
    """[nv*nh, 8, 8] int64 flat indices into a padded [Hp, wp] plane of
    each fragment's pixels at zero motion. Built once per plane
    geometry (gathers need int64 indices)."""
    i = torch.arange(8, device=device)
    y = pad_y + 8 * torch.arange(nv, device=device)[:, None, None, None] \
        + i[None, None, :, None]
    x = pad_x + 8 * torch.arange(nh, device=device)[None, :, None, None] \
        + i[None, None, None, :]
    return (y * wp + x).reshape(nv * nh, 8, 8)


def mc_predict(prev, gold, grid, refsel, o1y, o1x, o2y, o2x, use2):
    """Per-fragment 8x8 predictions [n, 8, 8] int32.

    prev, gold: [Hp, Wp] uint8 padded reference planes; grid: from
    block_index_grid; refsel: [n] 0 intra (predicts 128), 1 PREV,
    2 GOLD; (o1y, o1x), (o2y, o2x): [n] full-pel offsets; use2: [n]
    bool, half-pel average (p1 + p2) >> 1 of the two offsets.
    """
    hw = prev.shape[0] * prev.shape[1]
    wp = prev.shape[1]
    refs = torch.stack((prev, gold)).reshape(-1)
    base = grid + ((refsel == 2).long() * hw)[:, None, None]
    off1 = (o1y.long() * wp + o1x.long())[:, None, None]
    off2 = (o2y.long() * wp + o2x.long())[:, None, None]
    p1 = refs[base + off1].to(torch.int32)
    p2 = refs[base + off2].to(torch.int32)
    sel = torch.where(use2[:, None, None], (p1 + p2) >> 1, p1)
    return torch.where((refsel == 0)[:, None, None], 128, sel)


def blocks_to_plane(blocks, nv: int, nh: int, pad_y: int, pad_x: int):
    """[nv*nh, 8, 8] block grid -> [Hp, Wp] plane with zeroed padding."""
    plane = blocks.new_zeros((nv * 8 + 2 * pad_y, nh * 8 + 2 * pad_x))
    plane[pad_y:pad_y + nv * 8, pad_x:pad_x + nh * 8] = (
        blocks.reshape(nv, nh, 8, 8).permute(0, 2, 1, 3)
        .reshape(nv * 8, nh * 8)
    )
    return plane
