"""Motion compensation by direct gathers from the UMV-padded planes.

Counterpart of theora_tpu/ops/mc_jax.py. The JAX package reformulates MC
as per-fragment neighborhoods and masked shifts because element gathers
are slow on a TPU (mc_jax.py:1-24); a GPU gathers natively, so the port
reads ``ref[pad_y + 8r + i + oy, pad_x + 8c + j + ox]`` straight from the
reference plane (state.c:959-1000, fragment.c:20-80).

`mc_residual`, `skip_place` (with its split form `skip_rows` /
`place_rows`) and `mc_recon` are the plain versions of kernel KS's entries
(csrc/mc.cu, ops/mc_cuda.py), composed of `mc_predict`, `blocks_to_plane`
and `fill_borders`: the encode scan's MC and residual, its R/D skip test
and the plane's assembly, and the decode step's reconstruction. Their
per-fragment side rows are one [6, N] int8 tensor, rows SIDE_ROWS.
"""
from __future__ import annotations

import torch

from theora_tpu_torch.ops.loopfilter import fill_borders

# The rows of the side tensor the KS entries take: the reference (0 intra,
# 1 prev, 2 gold), the two full-pel offsets and the half-pel flag.
SIDE_ROWS = ("rs", "y1", "x1", "y2", "x2", "u2")


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


def _grid(prev, nv: int, nh: int, pad_y: int, pad_x: int, fid=None):
    """block_index_grid over prev's G planes, cut to the fragments fid
    of each plane when given: [G * nl, 8, 8]."""
    G, hp, wp = prev.shape
    grid = block_index_grid(nv, nh, pad_y, pad_x, wp, prev.device, G, hp)
    if fid is None:
        return grid
    return grid.view(G, nv * nh, 8, 8)[:, fid.long()].reshape(-1, 8, 8)


def _predict(prev, gold, grid, side):
    return mc_predict(prev, gold, grid, side[0], side[1], side[2], side[3],
                      side[4], side[5].bool())


def mc_residual(prev, gold, cur, side, nv: int, nh: int, pad_y: int,
                pad_x: int, fid=None):
    """The encode scan's MC step over N = G nl blocks of one plane at one
    frame step. prev, gold: [G, Hp, Wp] uint8 reference planes (gold may
    be prev); cur: [N, 64] uint8 source blocks; side: [6, N] int8 rows
    SIDE_ROWS; fid: None (nl = nv nh) or the [nl] int32 fragment ids of
    each plane's blocks (a frag group's share). Block b is fragment fid[b
    % nl] (or b % nl) of plane b // nl. Returns (pred [N, 64] int32 as
    mc_predict, res = cur - pred [N, 64] int16, ssd_unc [N] int32: the SSD
    of prev's block at zero motion against cur)."""
    grid = _grid(prev, nv, nh, pad_y, pad_x, fid)
    n = grid.shape[0]
    pred = _predict(prev, gold, grid, side).reshape(n, 64)
    unc = prev.reshape(-1)[grid].reshape(n, 64)
    curi = cur.to(torch.int32)
    du = unc - curi
    return (pred, (curi - pred).to(torch.int16),
            (du * du).sum(dim=1, dtype=torch.int32))


def skip_rows(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam, intra: bool,
              qout, coded, nv: int, nh: int, pad_y: int, pad_x: int,
              fid=None):
    """The encode scan's R/D skip test (JAX tpu_gop.py:286-293) on K1's
    outputs for mc_residual's N = G nl blocks: coded = intra or not (ms
    and 16 ssd_unc <= 16 ssd_rec + lamterm), lamterm = int32(lam[g] * (6
    cnt + 2)) in float32 for the block's plane g. recon [N, 64] uint8, q16
    [N, 64] int16, ssd_rec, ssd_unc, cnt [N] int32, ms [N] bool, lam [G]
    float32. Writes qout [N, 64] int16 (q16 where coded, else 0) and coded
    [N] bool in place; returns the [N, 65] uint8 rows of the kept blocks
    (recon where coded, else prev's block at zero motion) and the coded
    flag (the frag group's all-gather input)."""
    G = prev.shape[0]
    n = recon.shape[0]
    if intra:
        cd = torch.ones_like(ms)
    else:
        lamterm = (lam[:, None] * (6.0 * cnt.view(G, n // G).to(
            torch.float32) + 2.0)).to(torch.int32).view(n)
        cd = ~(ms & (16 * ssd_unc <= 16 * ssd_rec + lamterm))
    unc = prev.reshape(-1)[_grid(prev, nv, nh, pad_y, pad_x, fid)].reshape(
        n, 64)
    qout.copy_(torch.where(cd[:, None], q16, 0))
    coded.copy_(cd)
    return torch.cat((torch.where(cd[:, None], recon, unc),
                      cd[:, None].to(torch.uint8)), 1)


def place_rows(rows, G: int, nv: int, nh: int, pad_y: int, pad_x: int,
               borders: bool):
    """[G nv nh, 65] uint8 rows (every fragment of G planes in order, its
    64 pixels and the coded flag) -> (a new [G, Hp, Wp] plane, its padding
    the UMV borders when borders, else zeros; coded [G nv nh] bool)."""
    plane = blocks_to_plane(rows[:, :64].reshape(-1, 8, 8), nv, nh, pad_y,
                            pad_x, planes=G)
    if borders:
        fill_borders(plane, 8 * nv, 8 * nh, pad_y, pad_x)
    return plane, rows[:, 64].bool()


def skip_place(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam,
               intra: bool, qout, coded, nv: int, nh: int, pad_y: int,
               pad_x: int, borders: bool):
    """skip_rows over every fragment of prev's G planes, then place_rows:
    writes qout and coded in place and returns the new [G, Hp, Wp]
    plane."""
    rows = skip_rows(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam,
                     intra, qout, coded, nv, nh, pad_y, pad_x)
    return place_rows(rows, prev.shape[0], nv, nh, pad_y, pad_x,
                      borders)[0]


def mc_recon(prev, gold, resid, side, nv: int, nh: int, pad_y: int,
             pad_x: int, borders: bool, pic=None):
    """The decode step of one plane of a frame (JAX tpu_batch.py:114-128):
    prev, gold [Hp, Wp] uint8; resid [nv nh, 64] int16 (K1's residual);
    side [6, nv nh] int8 rows SIDE_ROWS. Returns the new [Hp, Wp] plane of
    clamp(resid + prediction, 0, 255), its padding the UMV borders when
    borders, else zeros; with pic, an [8 nv, 8 nh] uint8 tensor, also
    copies the picture region into it."""
    grid = _grid(prev[None], nv, nh, pad_y, pad_x)
    pred = _predict(prev, gold, grid, side)
    blocks = torch.clamp(resid.view(-1, 8, 8).to(torch.int32) + pred, 0, 255)
    plane = blocks_to_plane(blocks.to(torch.uint8), nv, nh, pad_y, pad_x)
    if borders:
        fill_borders(plane, 8 * nv, 8 * nh, pad_y, pad_x)
    if pic is not None:
        pic.copy_(plane[pad_y:pad_y + 8 * nv, pad_x:pad_x + 8 * nh])
    return plane
