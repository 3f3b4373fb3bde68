"""Closed-loop encode of one plane over the frames of a chunk, for G GOPs
at once.

Port of theora_tpu/encode/tpu_gop.py `make_plane_scan` and
`_scan_encode_plane`, with the trellis (use_trellis) or the R/D quantizer,
for one qi row (n_qis == 1) or for adaptive quantization's K <= 3 rows per
frame (n_qis > 1), with JAX's mesh GOP axis (theora_tpu/parallel/gop.py,
`jax.vmap(one_gop)` over a shard's GOPs) as a batch dimension on one
device, and its frag axis (frag_axis) over the ranks of a frag group
(parallel/ranks.py): each rank encodes its share of every frame's
fragments, and the reconstructed blocks and coded flags are all-gathered
at every frame step to rebuild the whole carried plane on every rank
(tpu_gop.py:160-166,185-192,294-309). The quantizer inputs
are per GOP and frame, as there: rate control changes the qi from frame
to frame and from GOP to GOP. The JAX scan over frames becomes a loop; the
carried (prev, gold) reference planes of every GOP stay on the device.
Per frame step, over the G GOPs' blocks at once:

  MC prediction by direct gathers (ops/mc.py) -> residual -> kernel K2
  (fDCT + quantization with each qi row, also returning the unquantized
  DCT) -> kernel KT (the trellis) at every qi row, on K2's outputs as they
  are; or, without the trellis, kernel KR's fused entry (K2's fDCT and
  quantization and the R/D quantizer in one launch); each returns the
  values, nonzero counts and DC-only flags -> kernel K1's encode entry
  (dequant + iDCT of every row, reconstruction, SSD, and with K > 1 rows
  the chooser, which keeps each block's cheapest row) -> the R/D skip
  test against the uncoded copy -> (over a frag group: the gather of
  every rank's blocks and coded flags) -> kernel KL (the loop filter and
  the borders, one launch over the G planes), or, when no GOP's limit is
  above 0, the borders alone.

Each kernel runs once per plane per frame step whatever K and G are: the
G GOPs are the kernels' segments (a GOP's quantizer rows and lambdas for
its n blocks). The chooser and the skip test keep the JAX program's
float32 lambda products. Their SSDs are integer sums; the JAX package sums
them in float32, which is exact for these integers below 2**24.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from theora_tpu_torch import transfer
from theora_tpu_torch.ops import fdct_cuda, idct_cuda, loopfilter_cuda, \
    qrd_cuda, trellis_cuda
from theora_tpu_torch.ops.mc import block_index_grid, blocks_to_plane, \
    mc_predict
from theora_tpu_torch.pipeline import fill_borders


def plane_blocks(planes: torch.Tensor, nv: int, nh: int) -> torch.Tensor:
    """[F, nv*8, nh*8] uint8 -> [F, nv*nh, 64] blocks, raster inside."""
    F = planes.shape[0]
    return (planes.reshape(F, nv, 8, nh, 8).permute(0, 1, 3, 2, 4)
            .reshape(F, nv * nh, 64))


def _frames_major(t: torch.Tensor) -> torch.Tensor:
    """[G, F, n, ...] -> [F, G*n, ...]: a frame step's blocks of every GOP
    in one row (a view at G = 1)."""
    G, F, n = t.shape[:3]
    return t.transpose(0, 1).reshape(F, G * n, *t.shape[3:])


def encode_plane(cur_planes, frag, is_intra, deq, limit, lam, nv: int,
                 nh: int, pad_y: int, pad_x: int, use_trellis: bool = True,
                 lam_t=None, nb=None, lam_q=None, lam_sc=None,
                 emit_recon: bool = False, frag_group=None):
    """Closed-loop encode of one plane over F frames of G GOPs at K qi
    rows.

    cur_planes: [G, F, nv*8, nh*8] uint8 source planes (bitstream
    orientation) on the device; frag: dict of [G, F, n] device tensors rs
    (0 intra, 1 prev, 2 gold; int64), o1y, o1x, o2y, o2x (full-pel MC
    offsets; int64), u2 (half-pel average; bool) and ms (may skip; bool);
    is_intra: F bools, the same for every GOP (each True frame starts a
    GOP); deq: [G, F, K, 2, 64] int16 zig-zag dequant rows on the device,
    per GOP, frame and qi row the intra and the inter row, slot 0 of every
    row holding the frame's base qi's DC factor; limit: [G, F] ints, the
    loop-filter limit of each frame (0: no filter); lam: [G, F] float32
    numpy, each frame's chooser and skip test lambda. With use_trellis,
    kernel KT quantizes: lam_t [G, F, K] float32 numpy, the trellis'
    lambda of each frame's rows for its frame type, and nb, the [64, 32]
    float32 token bit costs on the device; otherwise kernel KR: lam_q [G,
    F, K, 2] float32 numpy, per frame and row the intra and the inter
    block's lambda. lam_sc: None or [G, F, n] float32 per-block lambda
    scales on the device (the trellis' and the chooser's; KR takes none).

    frag_group: None, or this rank's parallel/ranks.py FragGroup of size
    Fr > 1: the rank encodes nl = ceil(n / Fr) fragments of each GOP
    (FragGroup.shard), and frag and lam_sc give those fragments' values,
    [G, F, nl] in place of [G, F, n]; its kernels launch on G * nl blocks
    (segment b / nl). The carried planes are whole on every rank.

    Returns (qout [G, F, n, 64] int16 quantized coefficients, zero for
    uncoded blocks; coded [G, F, n] bool; qii [G, F, n] uint8 each block's
    qi row; recon [G, F, Hp, Wp] uint8 padded planes when emit_recon, else
    None), with nl in place of n over a frag group.
    """
    dev = cur_planes.device
    G, F = cur_planes.shape[:2]
    K = deq.shape[2]
    n = nv * nh
    fr = frag_group
    h, w = nv * 8, nh * 8
    hp, wp = h + 2 * pad_y, w + 2 * pad_x
    grid = block_index_grid(nv, nh, pad_y, pad_x, wp, dev, G, hp)
    # Per frame step the G GOPs' blocks in one row of N: [F, N, 64].
    cur = cur_planes.reshape(G, F, nv, 8, nh, 8).permute(
        0, 1, 2, 4, 3, 5).reshape(G, F, n, 64)
    nl = n
    if fr is not None:
        # This rank's fragments of every GOP: the MC grid, the uncoded
        # copy (through the grid) and cur, taken by fragment index.
        nl, idx, _ = fr.shard(n)
        idx = transfer.upload(idx, dev)
        grid = grid.view(G, n, 8, 8)[:, idx].reshape(G * nl, 8, 8)
        cur = cur[:, :, idx]
    N = G * nl
    cur = _frames_major(cur)
    frag = {k: _frames_major(v) for k, v in frag.items()}
    deq = deq.transpose(0, 1).contiguous()             # [F, G, K, 2, 64]
    sc_f = None if lam_sc is None else _frames_major(lam_sc)
    prev = torch.full((G, hp, wp), 0x80, dtype=torch.uint8, device=dev)
    gold = prev
    # Each frame step's per-GOP lambdas and limits, uploaded once per
    # plane: [F, G, ...].
    lam_dev = transfer.upload(np.ascontiguousarray(lam.T), dev)
    if use_trellis:
        lam_t_dev = transfer.upload(lam_t.transpose(1, 0, 2), dev)
    else:
        lam_q_dev = transfer.upload(lam_q.transpose(1, 0, 2, 3), dev)
    limit = np.asarray(limit, np.int32)
    lim_dev = transfer.upload(limit.T, dev)
    qout = torch.empty((F, N, 64), dtype=torch.int16, device=dev)
    coded_out = torch.empty((F, N), dtype=torch.bool, device=dev)
    qii_out = torch.zeros((F, N), dtype=torch.uint8, device=dev)
    recon_out = [] if emit_recon else None
    # record_function labels group profiler time by codec stage
    # (tools/profile_encode.py).
    for f in range(F):
        rs = frag["rs"][f]
        ik = bool(is_intra[f])
        sc = None if sc_f is None else sc_f[f]
        with record_function("theora.enc.mc"):
            pred = mc_predict(prev, gold, grid, rs, frag["o1y"][f],
                              frag["o1x"][f], frag["o2y"][f],
                              frag["o2x"][f], frag["u2"][f]).reshape(N, 64)
            unc = prev.reshape(-1)[grid].reshape(N, 64)
            curi = cur[f].to(torch.int32)
            inter = (rs != 0).to(torch.uint8)
            res = (curi - pred).to(torch.int16)
        if use_trellis:
            with record_function("theora.enc.fdct_quant"):
                qdct0, dct = fdct_cuda.fdct_quantize(res, deq[f], inter)
            with record_function("theora.enc.trellis"):
                q16, cnt, dc_only = trellis_cuda.trellis_quantize(
                    qdct0, dct, deq[f], inter, lam_t_dev[f], nb, sc)
        else:
            with record_function("theora.enc.fdct_quant_rd"):
                q16, cnt, dc_only = qrd_cuda.fdct_quantize_rd(
                    res, deq[f], inter, lam_q_dev[f])
        lam_f = lam_dev[f]
        with record_function("theora.enc.idct_recon"):
            recon, ssd_rec, qii, q16, cnt = idct_cuda.idct_recon_choose(
                q16, dc_only, cnt, deq[f], inter, pred, cur[f], lam_f, sc)
        if K > 1:
            qii_out[f] = qii
        with record_function("theora.enc.skip"):
            du = unc - curi
            ssd_unc = (du * du).sum(dim=1, dtype=torch.int32)
            lamterm = (lam_f[:, None] * (
                6.0 * cnt.view(G, nl).to(torch.float32) + 2.0)).to(
                    torch.int32).view(N)
            coded = ~(frag["ms"][f]
                      & (16 * ssd_unc <= 16 * ssd_rec + lamterm))
            if ik:
                coded = torch.ones_like(coded)
            blocks = torch.where(coded[:, None], recon, unc)
        coded_all = coded
        if fr is not None:
            with record_function("theora.enc.frag_gather"):
                # One gather of every rank's blocks and coded flags,
                # [Fr, G * nl, 65] -> [G * n, 65].
                mine = torch.cat((blocks, coded[:, None].to(torch.uint8)), 1)
                both = fr.whole(fr.all_gather(mine, "step").view(
                    fr.size, G, nl, 65), n, 1).reshape(G * n, 65)
                blocks, coded_all = both[:, :64], both[:, 64].bool()
        with record_function("theora.enc.skip"):
            plane = blocks_to_plane(blocks.reshape(G * n, 8, 8), nv, nh,
                                    pad_y, pad_x, planes=G)
        # KL fills the borders of the planes it filters.
        filtered = bool(limit[:, f].any())
        if filtered:
            with record_function("theora.enc.loopfilter"):
                plane = loopfilter_cuda.loop_filter_plane(
                    plane, coded_all.reshape(G, nv, nh), lim_dev[f], nv, nh,
                    pad_y, pad_x)
        with record_function("theora.enc.borders"):
            if not filtered:
                fill_borders(plane, h, w, pad_y, pad_x)
            qout[f] = torch.where(coded[:, None], q16, 0)
            coded_out[f] = coded
        if ik:
            gold = plane
        prev = plane
        if emit_recon:
            recon_out.append(plane)
    recon = (torch.stack(recon_out, dim=1) if emit_recon else None)

    def gop_major(t):
        return t.view(F, G, nl, *t.shape[2:]).transpose(0, 1).contiguous()

    return (gop_major(qout), gop_major(coded_out), gop_major(qii_out),
            recon)
