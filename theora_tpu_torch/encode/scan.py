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

  kernel K2 with kernel KS's MC as its head (mc_fdct_quantize: each
  block's prediction from the carried planes and its residual made in
  registers, the fDCT and the quantization with each qi row, also
  returning the unquantized DCT) -> kernel KT (the trellis) at every qi
  row, on K2's outputs as they are; or, without the trellis, kernel KR's
  fused entry with the same head (mc_fdct_quantize_rd: MC, K2's fDCT and
  quantization and the R/D quantizer in one launch); each returns the
  values, nonzero counts and DC-only flags -> kernel K1's fused encode
  entry (mc_idct_recon_skip: the prediction again in registers, dequant +
  iDCT of every row, reconstruction, SSD, with K > 1 rows the chooser,
  then KS's R/D skip test against the uncoded copy and the new carried
  plane, with its borders when no GOP's limit is above 0; over a frag
  group the kept blocks' rows, the gather of every rank's rows and KS's
  place entry) -> kernel KL (the loop filter and the borders, one launch
  over the G planes) where a GOP's limit is above 0.

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
    mc_cuda, qrd_cuda, trellis_cuda


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
    hp, wp = nv * 8 + 2 * pad_y, nh * 8 + 2 * pad_x
    # Per frame step the G GOPs' blocks in one row of N: [F, N, 64].
    cur = cur_planes.reshape(G, F, nv, 8, nh, 8).permute(
        0, 1, 2, 4, 3, 5).reshape(G, F, n, 64)
    nl, fid = n, None
    if fr is not None:
        # This rank's fragments of every GOP: the fused entries take them
        # by fragment id, cur by index.
        nl, idx, _ = fr.shard(n)
        fid = transfer.upload(idx.astype(np.int32), dev)
        cur = cur[:, :, fid.long()]
    N = G * nl
    cur = _frames_major(cur)
    frag = {k: _frames_major(v) for k, v in frag.items()}
    # KS's MC side rows (ops/mc.py:SIDE_ROWS) of every frame step, [F, 6,
    # N] int8, and K2's, KR's and K1's inter flags, [F, N] uint8.
    side = torch.stack([frag[k] for k in ("rs", "o1y", "o1x", "o2y", "o2x",
                                          "u2")], 1).to(torch.int8)
    inter_all = (frag["rs"] != 0).to(torch.uint8)
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
    qii_out = torch.empty((F, N), dtype=torch.uint8, device=dev)
    recon_out = [] if emit_recon else None
    # record_function labels group profiler time by codec stage
    # (tools/profile_encode.py).
    for f in range(F):
        ik = bool(is_intra[f])
        sc = None if sc_f is None else sc_f[f]
        inter = inter_all[f]
        mc_in = (prev, gold, cur[f], side[f])
        geom = (nv, nh, pad_y, pad_x)
        if use_trellis:
            with record_function("theora.enc.fdct_quant"):
                qdct0, dct = fdct_cuda.mc_fdct_quantize(
                    *mc_in, deq[f], inter, *geom, fid)
            with record_function("theora.enc.trellis"):
                q16, cnt, dc_only = trellis_cuda.trellis_quantize(
                    qdct0, dct, deq[f], inter, lam_t_dev[f], nb, sc)
        else:
            with record_function("theora.enc.fdct_quant_rd"):
                q16, cnt, dc_only = qrd_cuda.mc_fdct_quantize_rd(
                    *mc_in, deq[f], inter, lam_q_dev[f], *geom, fid)
        # KL fills the borders of the planes it filters; K1's fused entry
        # those of the others.
        filtered = bool(limit[:, f].any())
        with record_function("theora.enc.idct_recon"):
            kept = idct_cuda.mc_idct_recon_skip(
                q16, dc_only, cnt, deq[f], inter, *mc_in, frag["ms"][f],
                lam_dev[f], sc, ik, qout[f], coded_out[f], qii_out[f],
                *geom, borders=not filtered, fid=fid)
        if fr is None:
            plane, coded_all = kept, coded_out[f]
        else:
            with record_function("theora.enc.frag_gather"):
                # One gather of every rank's blocks and coded flags,
                # [Fr, G * nl, 65] -> [G * n, 65].
                both = fr.whole(fr.all_gather(kept, "step").view(
                    fr.size, G, nl, 65), n, 1).reshape(G * n, 65)
            with record_function("theora.enc.borders"):
                plane, coded_all = mc_cuda.place_rows(
                    both.contiguous(), G, nv, nh, pad_y, pad_x,
                    borders=not filtered)
        if filtered:
            with record_function("theora.enc.loopfilter"):
                plane = loopfilter_cuda.loop_filter_plane(
                    plane, coded_all.view(G, nv, nh), lim_dev[f], nv, nh,
                    pad_y, pad_x)
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
