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
                     device, planes: int = 1, hp: int = 0) -> torch.Tensor:
    """[planes*nv*nh, 8, 8] int64 flat indices into `planes` padded [hp,
    wp] planes stacked as [planes, hp, wp] of each fragment's pixels at
    zero motion (plane g's fragments follow plane g - 1's; hp is needed
    for more than one plane). Built once per plane geometry (gathers need
    int64 indices)."""
    i = torch.arange(8, device=device)
    y = pad_y + 8 * torch.arange(nv, device=device)[:, None, None, None] \
        + i[None, None, :, None]
    x = pad_x + 8 * torch.arange(nh, device=device)[None, :, None, None] \
        + i[None, None, None, :]
    grid = (y * wp + x).reshape(nv * nh, 8, 8)
    if planes == 1:
        return grid
    base = hp * wp * torch.arange(planes, device=device)
    return (base[:, None, None, None] + grid).reshape(planes * nv * nh, 8, 8)


def mc_predict(prev, gold, grid, refsel, o1y, o1x, o2y, o2x, use2):
    """Per-fragment 8x8 predictions [n, 8, 8] int32.

    prev, gold: [Hp, Wp] uint8 padded reference planes, or [G, Hp, Wp]
    (G planes, the mesh encoder's GOPs); grid: from block_index_grid for
    as many planes; refsel: [n] 0 intra (predicts 128), 1 PREV, 2 GOLD;
    (o1y, o1x), (o2y, o2x): [n] full-pel offsets; use2: [n] bool, half-pel
    average (p1 + p2) >> 1 of the two offsets.
    """
    hw = prev.numel()
    wp = prev.shape[-1]
    refs = torch.stack((prev, gold)).reshape(-1)
    base = grid + ((refsel == 2).long() * hw)[:, None, None]
    off1 = (o1y.long() * wp + o1x.long())[:, None, None]
    off2 = (o2y.long() * wp + o2x.long())[:, None, None]
    p1 = refs[base + off1].to(torch.int32)
    p2 = refs[base + off2].to(torch.int32)
    sel = torch.where(use2[:, None, None], (p1 + p2) >> 1, p1)
    return torch.where((refsel == 0)[:, None, None], 128, sel)


def blocks_to_plane(blocks, nv: int, nh: int, pad_y: int, pad_x: int,
                    planes: int = 0):
    """[nv*nh, 8, 8] block grid -> [Hp, Wp] plane with zeroed padding; with
    planes = G > 0, [G*nv*nh, 8, 8] -> [G, Hp, Wp]."""
    g = max(planes, 1)
    plane = blocks.new_zeros((g, nv * 8 + 2 * pad_y, nh * 8 + 2 * pad_x))
    plane[:, pad_y:pad_y + nv * 8, pad_x:pad_x + nh * 8] = (
        blocks.reshape(g, nv, nh, 8, 8).permute(0, 1, 3, 2, 4)
        .reshape(g, nv * 8, nh * 8)
    )
    return plane if planes else plane[0]
