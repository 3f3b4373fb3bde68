"""Closed-loop encode of one plane over the frames of a chunk.

Port of theora_tpu/encode/tpu_gop.py `make_plane_scan` and
`_scan_encode_plane`, with the trellis (use_trellis) or the R/D quantizer,
for one qi row (n_qis == 1) or for adaptive quantization's K <= 3 rows per
frame (n_qis > 1), on a single device (frag_axis None). The quantizer
inputs are per frame, as there: rate control changes the qi from frame to
frame. The JAX scan over frames becomes a loop; the carried (prev, gold)
reference planes stay on the device. Per frame:

  MC prediction by direct gathers (ops/mc.py) -> residual -> kernel K2
  (fDCT + quantization with each qi row, also returning the unquantized
  DCT) -> kernel KT (the trellis) or kernel KR (the R/D quantizer) at every
  qi row, on K2's outputs as they are; each also returns the nonzero
  counts and DC-only flags -> kernel K1's encode entry (dequant + iDCT of
  every row, reconstruction, SSD, and with K > 1 rows the chooser, which
  keeps each block's cheapest row) -> the R/D skip test against the
  uncoded copy -> loop filter -> borders.

Each kernel runs once per plane per frame whatever K is. The chooser and
the skip test keep the JAX program's float32 lambda products. Their SSDs
are integer sums; the JAX package sums them in float32, which is exact
for these integers below 2**24.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from theora_tpu_torch import transfer
from theora_tpu_torch.ops import fdct_cuda, idct_cuda, qrd_cuda, \
    trellis_cuda
from theora_tpu_torch.ops.loopfilter import loop_filter_plane
from theora_tpu_torch.ops.mc import block_index_grid, blocks_to_plane, \
    mc_predict
from theora_tpu_torch.pipeline import fill_borders


def plane_blocks(planes: torch.Tensor, nv: int, nh: int) -> torch.Tensor:
    """[F, nv*8, nh*8] uint8 -> [F, nv*nh, 64] blocks, raster inside."""
    F = planes.shape[0]
    return (planes.reshape(F, nv, 8, nh, 8).permute(0, 1, 3, 2, 4)
            .reshape(F, nv * nh, 64))


def encode_plane(cur_planes, frag, is_intra, deq, limit, lam, nv: int,
                 nh: int, pad_y: int, pad_x: int, use_trellis: bool = True,
                 lam_t=None, nb=None, lam_q=None, lam_sc=None,
                 emit_recon: bool = False):
    """Closed-loop encode of one plane over F frames at K qi rows.

    cur_planes: [F, nv*8, nh*8] uint8 source planes (bitstream
    orientation) on the device; frag: dict of [F, n] device tensors rs
    (0 intra, 1 prev, 2 gold; int64), o1y, o1x, o2y, o2x (full-pel MC
    offsets; int64), u2 (half-pel average; bool) and ms (may skip;
    bool); is_intra: F bools (each True frame starts a GOP); deq: [F, K,
    2, 64] int16 zig-zag dequant rows on the device, per frame and qi row
    the intra and the inter row, slot 0 of every row holding the frame's
    base qi's DC factor; limit: [F] the loop-filter limit of each frame
    (0: no filter); lam: [F] float32 numpy, each frame's chooser and skip
    test lambda. With use_trellis, kernel KT quantizes: lam_t [F, K]
    float32 numpy, the trellis' lambda of each frame's rows for its frame
    type, and nb, the [64, 32] float32 token bit costs on the device;
    otherwise kernel KR: lam_q [F, K, 2] float32 numpy, per frame and row
    the intra and the inter block's lambda. lam_sc: None or [F, n] float32
    per-block lambda scales on the device (the trellis' and the
    chooser's; KR takes none).

    Returns (qout [F, n, 64] int16 quantized coefficients, zero for
    uncoded blocks; coded [F, n] bool; qii [F, n] uint8 each block's qi
    row; recon [F, Hp, Wp] uint8 padded planes when emit_recon, else
    None).
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
    lam_dev = transfer.upload(lam, dev)
    qout = torch.empty((F, n, 64), dtype=torch.int16, device=dev)
    coded_out = torch.empty((F, n), dtype=torch.bool, device=dev)
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
            unc = prev.reshape(-1)[grid].reshape(n, 64)
            curi = cur[f].to(torch.int32)
            inter = (rs != 0).to(torch.uint8)
            res = (curi - pred).to(torch.int16)
        with record_function("theora.enc.fdct_quant"):
            qdct0, dct = fdct_cuda.fdct_quantize(res, deq[f], inter)
        if use_trellis:
            with record_function("theora.enc.trellis"):
                q16, cnt, dc_only = trellis_cuda.trellis_quantize(
                    qdct0, dct, deq[f], inter, lam_t[f], nb, sc)
        else:
            with record_function("theora.enc.quantize_rd"):
                q16, cnt, dc_only = qrd_cuda.quantize_rd(
                    qdct0, dct, deq[f], inter, lam_q[f])
        lam_f = lam_dev[f]
        with record_function("theora.enc.idct_recon"):
            recon, ssd_rec, qii, q16, cnt = idct_cuda.idct_recon_choose(
                q16, dc_only, cnt, deq[f], inter, pred, cur[f], lam_f, sc)
        if K > 1:
            qii_out[f] = qii
        with record_function("theora.enc.skip"):
            du = unc - curi
            ssd_unc = (du * du).sum(dim=1, dtype=torch.int32)
            lamterm = (lam_f * (6.0 * cnt.to(torch.float32) + 2.0)).to(
                torch.int32)
            coded = ~(frag["ms"][f]
                      & (16 * ssd_unc <= 16 * ssd_rec + lamterm))
            if ik:
                coded = torch.ones_like(coded)
            blocks = torch.where(coded[:, None], recon, unc)
            plane = blocks_to_plane(blocks.reshape(n, 8, 8), nv, nh, pad_y,
                                    pad_x)
        if limit[f]:
            with record_function("theora.enc.loopfilter"):
                plane = loop_filter_plane(plane, coded.reshape(nv, nh),
                                          int(limit[f]), nv, nh, pad_y,
                                          pad_x)
        with record_function("theora.enc.borders"):
            fill_borders(plane, h, w, pad_y, pad_x)
            qout[f] = torch.where(coded[:, None], q16, 0)
            coded_out[f] = coded
        if ik:
            gold = plane
        prev = plane
        if emit_recon:
            recon_out.append(plane)
    recon = torch.stack(recon_out) if emit_recon else None
    return qout, coded_out, qii_out, recon
