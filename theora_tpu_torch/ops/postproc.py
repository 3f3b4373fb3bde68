"""The out-of-loop postprocessor (deblock + dering), plain PyTorch.

Port of theora_tpu/ops/postproc_np.py (the reference's optional
postprocessor, decode.c:1610-1957) on tensors: the CPU path of kernel KP
(ops/postproc_cuda.py, csrc/postproc.cu) and its oracle on the card.

* Deblock: phase H filters every horizontal block boundary at once (each
  reads the unfiltered source and writes a separate destination); phase V
  walks the vertical boundaries left to right, in place (boundary x reads
  column x-5, which boundary x-8 wrote). The boundary smoother is the
  7-tap [1,1,1,2,1,1,1] over the edge-replicated 10-sample window. Each
  boundary adds its clamped activity sums to the blocks on its two sides.
* Dering: a weighted 4-neighbour IIR smoother inside each selected block,
  whose weights come from the block's pre-pass gradients. A block reads
  the final pixels of its north and west neighbours and the pre-dering
  pixels of its south and east ones, so blocks run in waves of
  independent blocks (the longest chain of filtered blocks above or left
  of each), and inside a block along its 15 pixel anti-diagonals.

Planes are in bitstream orientation (row 0 = display bottom), h and w
multiples of 8. Results equal the numpy oracle's byte for byte.
"""
from __future__ import annotations

import numpy as np
import torch

# Dering block-selection thresholds on the deblock variance sums
# (decode.c:1966-1977).
T1 = 384
T2 = 4 * T1
T3 = 5 * T1
T4 = 10 * T1


def _tap7(window: torch.Tensor) -> torch.Tensor:
    """[..., 10] boundary windows -> [..., 8] smoothed samples."""
    p = torch.cat([window[..., :1], window[..., :1], window,
                   window[..., -1:], window[..., -1:]], dim=-1)
    acc = 2 * p[..., 3:11]
    for t in (0, 1, 2, 4, 5, 6):
        acc = acc + p[..., t:t + 8]
    return (acc + 4) >> 3


def _edge_stats(window: torch.Tensor):
    """Outer and inner activity of [..., 10] windows: the sums of the
    first four and the last four absolute neighbour differences."""
    d = (window[..., 1:] - window[..., :-1]).abs()
    return d[..., 0:4].sum(dim=-1), d[..., 5:9].sum(dim=-1)


def deblock_plane(src: torch.Tensor, dc_qis: torch.Tensor,
                  dc_scale: torch.Tensor):
    """Deblock one plane: src [h, w] uint8, dc_qis [nv, nh] uint8 (the
    last DC qi per block), dc_scale [64] int32. Returns (dst [h, w] uint8,
    variances [nv, nh] int32, the activity sums dering selects with)."""
    h, w = src.shape
    nv, nh = h >> 3, w >> 3
    dev = src.device
    s32 = src.to(torch.int32)
    dst = s32.clone()
    variances = torch.zeros((nv, nh), dtype=torch.int32, device=dev)
    qstep_b = dc_scale[dc_qis.long()].to(torch.int32)  # [nv, nh]

    # Phase H: all horizontal boundaries, src -> dst.
    if nv > 1:
        k = torch.arange(nv - 1, device=dev)
        rows = (k << 3)[:, None] + 3 + torch.arange(10, device=dev)[None, :]
        win = s32[rows].transpose(1, 2)  # [nv-1, w, 10]
        outer, inner = _edge_stats(win)  # [nv-1, w]
        variances[:-1] += outer.clamp(max=255).reshape(
            nv - 1, nh, 8).sum(2).to(torch.int32)
        variances[1:] += inner.clamp(max=255).reshape(
            nv - 1, nh, 8).sum(2).to(torch.int32)
        q = qstep_b[:-1].repeat_interleave(8, dim=1)  # block above
        lim = (q * 3) >> 2
        ok = ((outer < lim) & (inner < lim)
              & ((win[..., 5] - win[..., 4]).abs() < q))
        body = torch.where(ok[..., None], _tap7(win), win[..., 1:9])
        wrows = (k << 3)[:, None] + 4 + torch.arange(8, device=dev)[None, :]
        dst[wrows] = body.transpose(1, 2)

    # Phase V: vertical boundaries, in place, left to right.
    for bx in range(1, nh):
        x = bx << 3
        win = dst[:, x - 5:x + 5]  # [h, 10]
        outer, inner = _edge_stats(win)
        variances[:, bx - 1] += outer.clamp(max=255).reshape(
            nv, 8).sum(1).to(torch.int32)
        variances[:, bx] += inner.clamp(max=255).reshape(
            nv, 8).sum(1).to(torch.int32)
        q = qstep_b[:, bx].repeat_interleave(8)  # block right of it
        lim = (q * 3) >> 2
        ok = ((outer < lim) & (inner < lim)
              & ((win[:, 5] - win[:, 4]).abs() < q))
        dst[:, x - 4:x + 4] = torch.where(ok[:, None], _tap7(win),
                                          win[:, 1:9])
    return dst.to(torch.uint8), variances


def dering_plan(variances: torch.Tensor, strong_level: bool, pli: int):
    """Per-block passes (0, 1 or 3) and strength from the deblock
    variances: ([nv, nh] int32 passes, [nv, nh] bool strong)."""
    var = variances
    npass = torch.zeros_like(var)
    strong = torch.zeros(var.shape, dtype=torch.bool, device=var.device)
    if strong_level:
        hit = var > (T4 if pli else T3)
        if pli:
            ring = torch.ones_like(strong)
        else:
            ring = torch.zeros_like(strong)
            ring[:, 1:] |= var[:, :-1] > T4
            ring[:, :-1] |= var[:, 1:] > T4
            ring[1:, :] |= var[:-1, :] > T4
            ring[:-1, :] |= var[1:, :] > T4
        npass = torch.where(hit, torch.where(ring, 3, 1), npass)
        strong |= hit
        rest = ~hit
    else:
        rest = torch.ones_like(strong)
    m = rest & (var > T2)
    npass = torch.where(m, 1, npass)
    strong |= m
    m = rest & ~m & (var > T1)
    npass = torch.where(m, 1, npass)
    return npass.to(torch.int32), strong


def dering_waves(npass: np.ndarray) -> np.ndarray:
    """[nv, nh] wave index of each filtered block (-1 where unfiltered):
    one more than the larger of its north and west neighbours' (the
    longest chain of filtered blocks above or left of it)."""
    nv, nh = npass.shape
    wave = np.full((nv, nh), -1, dtype=np.int32)
    for by, bx in zip(*np.nonzero(npass)):
        up = wave[by - 1, bx] if by else -1
        lf = wave[by, bx - 1] if bx else -1
        wave[by, bx] = max(up, lf) + 1
    return wave


def _diag_indices(dev):
    """Per pixel anti-diagonal of an 8x8 block, the flat positions of
    (centre, N, W, S, E) in the [10, 10] grid and of the four edge
    weights in the flattened vw [9, 8] and hw [8, 9] tables."""
    out = []
    for d in range(15):
        ys = np.arange(max(0, d - 7), min(7, d) + 1)
        xs = d - ys
        idx = ((ys + 1) * 10 + xs + 1, ys * 10 + xs + 1, (ys + 1) * 10 + xs,
               (ys + 2) * 10 + xs + 1, (ys + 1) * 10 + xs + 2,
               ys * 8 + xs, (ys + 1) * 8 + xs, ys * 9 + xs, ys * 9 + xs + 1)
        out.append(tuple(torch.from_numpy(i).to(dev) for i in idx))
    return out


def _dering_pass(g, dc, sharp, mod_hi, shift, diags):
    """One pass over a [K, 10, 10] int32 stack of block neighbourhoods;
    returns the new stack (interior rewritten, borders kept)."""
    def wf(d):
        m = 32 + dc - (d << shift)
        return torch.where(m < -64, sharp,
                           torch.minimum(m.clamp(min=0), mod_hi))

    K = g.shape[0]
    vw = wf((g[:, 1:, 1:9] - g[:, :-1, 1:9]).abs()).reshape(K, 72)
    hw = wf((g[:, 1:9, 1:] - g[:, 1:9, :-1]).abs()).reshape(K, 72)
    cur = g.reshape(K, 100)
    out = cur.clone()
    for ic, inn, iw, iso, ie, iwn, iws, iww, iwe in diags:
        wn, ws, ww, we = vw[:, iwn], vw[:, iws], hw[:, iww], hw[:, iwe]
        acc = ((128 - wn - ws - ww - we) * cur[:, ic] + 64
               + wn * out[:, inn] + ww * out[:, iw]
               + ws * cur[:, iso] + we * cur[:, ie])
        out[:, ic] = (acc >> 7).clamp(0, 255)
    return out.reshape(g.shape)


def dering_plane(plane: torch.Tensor, qi: torch.Tensor,
                 dc_scale: torch.Tensor, sharp_table: torch.Tensor,
                 variances: torch.Tensor, strong_level: bool,
                 pli: int) -> torch.Tensor:
    """Dering one deblocked plane: plane [h, w] uint8, qi [nv, nh] uint8
    (the frame qi each block dequantized with), variances from
    deblock_plane, strong_level whether the pp level asks for strong
    dering on this plane. Returns the new [h, w] uint8 plane."""
    h, w = plane.shape
    nv, nh = h >> 3, w >> 3
    dev = plane.device
    npass, strong = dering_plan(variances, strong_level, pli)
    npass_h = npass.cpu().numpy()
    if not npass_h.any():
        return plane.clone()
    out = plane.to(torch.int32)
    qil = qi.long()
    qs = dc_scale[qil].to(torch.int32)
    sharp = sharp_table[qil].to(torch.int32)
    mod_hi = torch.minimum(3 * qs, torch.where(strong, 32, 24)).to(torch.int32)
    shift = torch.where(strong, 0, 1).to(torch.int32)

    wave = dering_waves(npass_h)
    by_all, bx_all = np.nonzero(npass_h)
    waves = wave[by_all, bx_all]
    order = np.argsort(waves, kind="stable")
    by_all, bx_all, waves = by_all[order], bx_all[order], waves[order]
    starts = np.searchsorted(waves, np.arange(waves[-1] + 2))
    diags = _diag_indices(dev)
    # Edge-replicated plane rows and columns -1 .. h (w).
    rpad = torch.arange(-1, h + 1, device=dev).clamp(0, h - 1)
    cpad = torch.arange(-1, w + 1, device=dev).clamp(0, w - 1)
    ar10 = torch.arange(10, device=dev)
    ar8 = torch.arange(8, device=dev)
    for d in range(int(waves[-1]) + 1):
        lo, hi = starts[d], starts[d + 1]
        bys = torch.from_numpy(by_all[lo:hi]).to(dev)
        bxs = torch.from_numpy(bx_all[lo:hi]).to(dev)
        rows = rpad[(bys << 3)[:, None] + ar10]  # [K, 10]
        cols = cpad[(bxs << 3)[:, None] + ar10]
        g = out[rows[:, :, None], cols[:, None, :]]  # [K, 10, 10]
        dcd = qs[bys, bxs][:, None, None]
        shd = sharp[bys, bxs][:, None, None]
        mhd = mod_hi[bys, bxs][:, None, None]
        sfd = shift[bys, bxs][:, None, None]
        np_d = npass[bys, bxs].cpu().numpy()
        top, bot = bys == 0, bys == nv - 1
        left, right = bxs == 0, bxs == nh - 1
        for p in range(int(np_d.max())):
            act = torch.from_numpy(np.nonzero(np_d > p)[0]).to(dev)
            g[act] = _dering_pass(g[act], dcd[act], shd[act], mhd[act],
                                  sfd[act], diags)
            # Plane-edge blocks refresh their replicated borders from
            # their own updated pixels for the next pass.
            a = act[top[act]]
            g[a, 0] = g[a, 1]
            a = act[bot[act]]
            g[a, 9] = g[a, 8]
            a = act[left[act]]
            g[a, :, 0] = g[a, :, 1]
            a = act[right[act]]
            g[a, :, 9] = g[a, :, 8]
        ry = (bys << 3)[:, None, None] + ar8[None, :, None]
        rx = (bxs << 3)[:, None, None] + ar8[None, None, :]
        out[ry, rx] = g[:, 1:9, 1:9]
    return out.to(torch.uint8)


def postprocess_plane(src: torch.Tensor, dc_qis: torch.Tensor,
                      qi: torch.Tensor, dc_scale: torch.Tensor,
                      sharp_table: torch.Tensor, dering: bool,
                      strong: bool, pli: int) -> torch.Tensor:
    """Deblock, then dering where asked: the new [h, w] uint8 plane."""
    dst, variances = deblock_plane(src, dc_qis, dc_scale)
    if dering:
        dst = dering_plane(dst, qi, dc_scale, sharp_table, variances,
                           strong, pli)
    return dst
