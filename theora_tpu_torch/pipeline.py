"""Frame-level compute cores.

Port of theora_tpu/pipeline.py: the three encode and reconstruction
cores, and `fill_borders` (state.c:770-835), whose body lives beside the
loop filter in ops/loopfilter.py (kernel KL writes the borders too).

  - intra_encode_core: keyframe blocks -> zig-zag quantized coefficients
    and their reconstruction, for any leading batch dims (the JAX
    package's "compute core", which its bench.py times);
  - inter_encode_core: one plane's quantized coefficients given
    per-block predictions;
  - recon_core: quantized coefficients -> reconstructed plane (the
    decoder's side).

Each runs the card's hand kernels on CUDA tensors (K2, ops/fdct_cuda.py;
K1's decode entry, ops/idct_cuda.py) and their plain PyTorch versions on
CPU tensors, through the kernels' wrappers. Results equal JAX's integers.
"""
from __future__ import annotations

import torch

from theora_tpu_torch.ops import fdct_cuda, idct_cuda
from theora_tpu_torch.ops.loopfilter import fill_borders  # noqa: F401


def _dequant_tab(rows: torch.Tensor, dc_quant: torch.Tensor):
    """K1's decode-entry dequant table for per-block rows: the distinct
    (row, DC factor) pairs as frames of a [F, 3, 2, 64] int16 table, the
    AC row at qii 1 and the DC factor in qii 0's DC slot, intra side.
    Returns (table, [N] int32 frame index of each block)."""
    key = torch.cat([rows.to(torch.int32), dc_quant.to(torch.int32)[:, None]],
                    dim=1)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    tab = torch.zeros((uniq.shape[0], 3, 2, 64), dtype=torch.int16,
                      device=rows.device)
    tab[:, 1, 0] = uniq[:, :64].to(torch.int16)
    tab[:, 0, 0, 0] = uniq[:, 64].to(torch.int16)
    return tab, inv.to(torch.int32)


def intra_encode_core(plane_blocks: torch.Tensor, dequant_zz: torch.Tensor):
    """Keyframe encode compute for one plane's fragments.

    plane_blocks: [..., N, 8, 8] uint8 source blocks (any leading batch
    dims); dequant_zz: [64] intra dequant factors (zig-zag).
    Returns (qdct [..., N, 64] int32 zig-zag quantized coefficients,
    recon [..., N, 8, 8] uint8 reconstruction assuming full coding).

    K2 makes one launch over every block of the leading dims (the intra
    row in both frame-type slots), K1's decode entry one over the same
    blocks: blocks whose only nonzero coefficient is DC take the
    (dc * q + 15) >> 5 fill path (state.c:967-975).
    """
    dev = plane_blocks.device
    res = (plane_blocks.reshape(-1, 64).to(torch.int16) - 128).contiguous()
    n = res.shape[0]
    dq = torch.as_tensor(dequant_zz, device=dev).to(torch.int16)
    deq = dq.expand(1, 2, 64).contiguous()
    inter = torch.zeros(n, dtype=torch.uint8, device=dev)
    qout, _ = fdct_cuda.fdct_quantize(res, deq, inter)
    q16 = qout[0]
    tab = torch.zeros((1, 3, 2, 64), dtype=torch.int16, device=dev)
    tab[0, :, :] = dq
    dc_only = (q16[:, 1:] == 0).all(dim=1)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    residual = idct_cuda.dequantize_idct_frames(
        q16, q16[:, 0].contiguous(), tab, zeros, inter, inter, dc_only)
    recon = (residual.to(torch.int32) + 128).clamp(0, 255).to(torch.uint8)
    lead = plane_blocks.shape[:-2]
    return (q16.to(torch.int32).reshape(*lead, 64),
            recon.reshape(plane_blocks.shape))


def inter_encode_core(cur_blocks, pred_blocks, is_intra, dequant_intra,
                      dequant_inter) -> torch.Tensor:
    """Inter-frame encode compute for one plane.

    cur_blocks, pred_blocks: [N, 8, 8] uint8; is_intra: [N] bool (intra
    blocks predict from 128); dequant_*: [64] zig-zag factors. Returns
    qdct [N, 64] int32: one K2 launch with the intra and inter rows and
    the per-block frame type.
    """
    dev = cur_blocks.device
    pred = torch.where(is_intra[:, None, None], 128,
                       pred_blocks.to(torch.int32))
    res = (cur_blocks.to(torch.int32) - pred).to(torch.int16) \
        .reshape(-1, 64).contiguous()
    deq = torch.stack([torch.as_tensor(d, device=dev).to(torch.int16)
                       for d in (dequant_intra, dequant_inter)])[None]
    inter = (~is_intra).to(torch.uint8).contiguous()
    qout, _ = fdct_cuda.fdct_quantize(res, deq, inter)
    return qout[0].to(torch.int32)


def _block_index(by, bx):
    ay = by.long()[:, None, None] + torch.arange(8, device=by.device)[
        None, :, None]
    ax = bx.long()[:, None, None] + torch.arange(8, device=bx.device)[
        None, None, :]
    return ay, ax


def recon_core(self_plane, prev_plane, gold_plane, by, bx, coeffs_zz,
               dequant_zz, dc, dc_quant, dc_only, refsel, o1y, o1x, o2y,
               o2x, use2) -> torch.Tensor:
    """Decode-side reconstruction of one plane's coded fragments.

    self_plane [H, W] uint8 holds the previous frame (the copy of the
    uncoded fragments); the coded blocks at top-left (by, bx) [N] are
    overwritten in a copy, which is returned. coeffs_zz [N, 64] zig-zag
    quantized values (DC slot ignored) and dequant_zz [N, 64] per-block
    factors; dc [N] predicted DC and dc_quant [N] its factor, both in
    the int16 range; dc_only [N] bool; refsel [N] 0 intra, 1 previous,
    2 golden; (o1y, o1x) and, where use2 [N] bool, (o2y, o2x) the offsets
    of the one or two reference blocks that are averaged. Every block
    lies inside the planes (they are padded).

    K1's decode entry makes one launch over the N blocks, with each
    distinct (row, DC factor) pair as one of its frames; the gathers,
    averages, clip and scatter are PyTorch ops.
    """
    dev = coeffs_zz.device
    n = coeffs_zz.shape[0]
    tab, frame = _dequant_tab(dequant_zz, dc_quant)
    qii = torch.ones(n, dtype=torch.uint8, device=dev)
    inter = torch.zeros(n, dtype=torch.uint8, device=dev)
    residual = idct_cuda.dequantize_idct_frames(
        coeffs_zz.to(torch.int16).contiguous(), dc.to(torch.int16).contiguous(),
        tab, frame, qii, inter, dc_only.to(torch.bool).contiguous())
    residual = residual.reshape(n, 8, 8).to(torch.int32)

    def gather(plane, oy, ox):
        ay, ax = _block_index(by + oy, bx + ox)
        return plane[ay, ax].to(torch.int32)

    p1, p2 = gather(prev_plane, o1y, o1x), gather(prev_plane, o2y, o2x)
    g1, g2 = gather(gold_plane, o1y, o1x), gather(gold_plane, o2y, o2x)
    two = use2.to(torch.bool)[:, None, None]
    pred_prev = torch.where(two, (p1 + p2) >> 1, p1)
    pred_gold = torch.where(two, (g1 + g2) >> 1, g1)
    sel = refsel.long()[:, None, None]
    pred = torch.where(sel == 0, 128, torch.where(sel == 1, pred_prev,
                                                  pred_gold))
    blocks = (residual + pred).clamp(0, 255).to(torch.uint8)
    out = self_plane.clone()
    ay, ax = _block_index(by, bx)
    out[ay, ax] = blocks
    return out
