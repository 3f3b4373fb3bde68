"""Closed-loop encode of one plane over the frames of a chunk.

Port of theora_tpu/encode/tpu_gop.py `make_plane_scan` and
`_scan_encode_plane` with the trellis, for one qi row (n_qis == 1) or for
adaptive quantization's K <= 3 rows per frame (n_qis > 1), on a single
device (frag_axis None). The JAX scan over frames becomes a loop; the
carried (prev, gold) reference planes stay on the device. Per frame:

  MC prediction by direct gathers (ops/mc.py) -> residual -> kernel K2
  (fDCT + quantization with each qi row, also returning the unquantized
  DCT) -> kernel KT (the trellis at every qi row, on K2's outputs as they
  are; it also returns the nonzero counts and DC-only flags) -> kernel K1
  (dequant + iDCT of every row) -> reconstruction -> with K > 1 rows the
  chooser keeps each block's cheapest row -> the R/D skip test against the
  uncoded copy -> loop filter -> borders.

Each kernel runs once per plane per frame whatever K is. The chooser and
the skip test keep the JAX program's float32 lambda products. Their SSDs
are integer sums; the JAX package sums them in float32, which is exact
for these integers below 2**24.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from theora_tpu_torch.ops import fdct_cuda, idct_cuda, trellis_cuda
from theora_tpu_torch.ops.loopfilter import loop_filter_plane
from theora_tpu_torch.ops.mc import block_index_grid, blocks_to_plane, \
    mc_predict
from theora_tpu_torch.pipeline import fill_borders


def plane_blocks(planes: torch.Tensor, nv: int, nh: int) -> torch.Tensor:
    """[F, nv*8, nh*8] uint8 -> [F, nv*nh, 64] blocks, raster inside."""
    F = planes.shape[0]
    return (planes.reshape(F, nv, 8, nh, 8).permute(0, 1, 3, 2, 4)
            .reshape(F, nv * nh, 64))


def choose_rows(ssd, cnt, lam, lam_sc):
    """Each block's qi row by the scan's R/D proxy (tpu_gop.py:256-285):
    the least 16 ssd + int32(lam * lam_sc * (6 cnt + 2 + 6 [k > 0])), in
    float32 and in that order, truncated toward zero; a tie keeps the
    earlier row.

    ssd, cnt: [K, n] int32; lam: float32 0-d tensor; lam_sc: [n] float32
    or None (all ones). Returns [n] uint8 row indices.
    """
    lam_b = lam if lam_sc is None else lam * lam_sc
    cntf = cnt.to(torch.float32)
    best = 16 * ssd[0] + (lam_b * (6.0 * cntf[0] + 2.0)).to(torch.int32)
    qii = torch.zeros(ssd.shape[1], dtype=torch.uint8, device=ssd.device)
    for k in range(1, ssd.shape[0]):
        cost = 16 * ssd[k] + (lam_b * (6.0 * cntf[k] + 2.0 + 6.0)).to(
            torch.int32)
        win = cost < best
        best = torch.where(win, cost, best)
        qii = torch.where(win, k, qii)
    return qii


def encode_plane(cur_planes, frag, is_intra, deq, limit: int, lam, lam_t,
                 nb, nv: int, nh: int, pad_y: int, pad_x: int,
                 lam_sc=None, emit_recon: bool = False):
    """Closed-loop encode of one plane over F frames at K qi rows.

    cur_planes: [F, nv*8, nh*8] uint8 source planes (bitstream
    orientation) on the device; frag: dict of [F, n] device tensors rs
    (0 intra, 1 prev, 2 gold; int64), o1y, o1x, o2y, o2x (full-pel MC
    offsets; int64), u2 (half-pel average; bool) and ms (may skip;
    bool); is_intra: F bools (each True frame starts a GOP); deq: [F, K,
    2, 64] int16 zig-zag dequant rows on the device, per frame and qi row
    the intra and the inter row, slot 0 of every row holding the frame's
    base qi's DC factor; limit: the loop-filter limit; lam: the chooser's
    and the skip test's float32 lambda; lam_t: [F, K] float32 numpy, the
    trellis' lambda of each frame's rows for its frame type; nb: [64, 32]
    float32 token bit costs on the device; lam_sc: None or [F, n] float32
    per-block lambda scales on the device (the trellis' and the
    chooser's).

    Returns (qout [F, n, 64] int16 quantized coefficients, zero for
    uncoded blocks; coded [F, n] bool; nnz [F, n] int32 nonzero counts;
    qii [F, n] uint8 each block's qi row; recon [F, Hp, Wp] uint8 padded
    planes when emit_recon, else None).
    """
    dev = cur_planes.device
    F = cur_planes.shape[0]
    K = deq.shape[1]
    n = nv * nh
    h, w = nv * 8, nh * 8
    grid = block_index_grid(nv, nh, pad_y, pad_x, w + 2 * pad_x, dev)
    cur = plane_blocks(cur_planes, nv, nh)
    prev = torch.full((h + 2 * pad_y, w + 2 * pad_x), 0x80,
                      dtype=torch.uint8, device=dev)
    gold = prev
    # K1's inputs that do not change within a frame: its dequant table
    # holds the frame's K rows as qii 0..K-1, and block k*n + i of a
    # launch is row k of block i.
    deq_tab = torch.zeros((F, 3, 2, 64), dtype=torch.int16, device=dev)
    deq_tab[:, :K] = deq
    zeros_i32 = torch.zeros(K * n, dtype=torch.int32, device=dev)
    row_of = torch.arange(K, dtype=torch.uint8, device=dev).repeat_interleave(
        n)
    blk = torch.arange(n, device=dev)
    lam_dev = torch.tensor(lam, dtype=torch.float32, device=dev)
    qout = torch.empty((F, n, 64), dtype=torch.int16, device=dev)
    coded_out = torch.empty((F, n), dtype=torch.bool, device=dev)
    nnz_out = torch.empty((F, n), dtype=torch.int32, device=dev)
    qii_out = torch.zeros((F, n), dtype=torch.uint8, device=dev)
    recon_out = [] if emit_recon else None
    # record_function labels group profiler time by codec stage
    # (tools/profile_encode.py).
    for f in range(F):
        rs = frag["rs"][f]
        ik = bool(is_intra[f])
        sc = None if lam_sc is None else lam_sc[f]
        with record_function("theora.enc.mc"):
            pred = mc_predict(prev, gold, grid, rs, frag["o1y"][f],
                              frag["o1x"][f], frag["o2y"][f],
                              frag["o2x"][f], frag["u2"][f]).reshape(n, 64)
            unc = prev.reshape(-1)[grid].reshape(n, 64).to(torch.int32)
            curi = cur[f].to(torch.int32)
            inter = (rs != 0).to(torch.uint8)
            res = (curi - pred).to(torch.int16)
        with record_function("theora.enc.fdct_quant"):
            qdct0, dct = fdct_cuda.fdct_quantize(res, deq[f], inter)
        with record_function("theora.enc.trellis"):
            q16, cnt, dc_only = trellis_cuda.trellis_quantize(
                qdct0, dct, deq[f], inter, lam_t[f], nb, sc)
        with record_function("theora.enc.idct_recon"):
            flat = q16.reshape(K * n, 64)
            residual = idct_cuda.dequantize_idct_frames(
                flat, flat[:, 0].contiguous(), deq_tab[f:f + 1], zeros_i32,
                row_of, inter if K == 1 else inter.repeat(K),
                dc_only.reshape(K * n))
            recon = torch.clamp(
                residual.to(torch.int32).reshape(K, n, 64) + pred, 0, 255)
            dr = recon - curi
            ssd = (dr * dr).sum(dim=2, dtype=torch.int32)
        if K > 1:
            with record_function("theora.enc.choose"):
                qii = choose_rows(ssd, cnt, lam_dev, sc)
                sel = qii.long()
                q16, cnt = q16[sel, blk], cnt[sel, blk]
                recon, ssd_rec = recon[sel, blk], ssd[sel, blk]
                qii_out[f] = qii
        else:
            q16, cnt, recon, ssd_rec = q16[0], cnt[0], recon[0], ssd[0]
        with record_function("theora.enc.skip"):
            du = unc - curi
            ssd_unc = (du * du).sum(dim=1, dtype=torch.int32)
            lamterm = (lam_dev * (6.0 * cnt.to(torch.float32) + 2.0)).to(
                torch.int32)
            coded = ~(frag["ms"][f]
                      & (16 * ssd_unc <= 16 * ssd_rec + lamterm))
            if ik:
                coded = torch.ones_like(coded)
            blocks = torch.where(coded[:, None], recon, unc).to(torch.uint8)
            plane = blocks_to_plane(blocks.reshape(n, 8, 8), nv, nh, pad_y,
                                    pad_x)
        if limit:
            with record_function("theora.enc.loopfilter"):
                plane = loop_filter_plane(plane, coded.reshape(nv, nh),
                                          limit, nv, nh, pad_y, pad_x)
        with record_function("theora.enc.borders"):
            fill_borders(plane, h, w, pad_y, pad_x)
            qout[f] = torch.where(coded[:, None], q16, 0)
            coded_out[f] = coded
            nnz_out[f] = torch.where(coded, cnt, 0)
        if ik:
            gold = plane
        prev = plane
        if emit_recon:
            recon_out.append(plane)
    recon = torch.stack(recon_out) if emit_recon else None
    return qout, coded_out, nnz_out, qii_out, recon
