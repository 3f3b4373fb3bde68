"""Plain PyTorch twins of the codec transforms.

Port of theora_tpu/ops/transforms_jax.py: the iDCT side (`_i16`, `idct8`,
`idct8x8`, `dc_fill`, `dequantize_idct`), the fDCT and quantizer
(`fdct8`, `fdct8x8`, `quantize`) and the batched trellis
(`trellis_values`). Integer arithmetic is int32 with the explicit int16
wrap where the spec stores int16, so the results equal the C reference
(idct.c:30-296, fdct.c:27-154, enquant.c:220-249, state.c:959-980).

`dequantize_idct_frames` and `idct_recon_choose` (with the qi chooser
`choose_rows`) are the functions kernel K1 computes at its two entry
points (ops/idct_cuda.py), `fdct_quantize` the one kernel K2 computes
(ops/fdct_cuda.py) and `trellis_quantize` (`trellis_values` on K2's
outputs) the one kernel KT computes (ops/trellis_cuda.py): the CPU paths
of their wrappers and their oracles on the card. The encode-side ones take
the kernels' segment axis: dequant rows [G, K, 2, 64] (and lambdas with a
leading G) for N = G n blocks, block b in segment b // n (the mesh
encoder's G GOPs at one frame step); [K, 2, 64] is one segment.
"""
from __future__ import annotations

import numpy as np
import torch

from theora_tpu_torch.constants import (
    C1S7,
    C2S6,
    C3S5,
    C4S4,
    C5S3,
    C6S2,
    C7S1,
    ZIGZAG_TO_NAT,
)

_ZZ = torch.from_numpy(ZIGZAG_TO_NAT)
# The JAX package's float32 "infinite" cost (transforms_jax._BIG).
_BIG = 1e30


def _segments(deq: torch.Tensor, nblocks: int):
    """(deq as [G, K, 2, 64], [nblocks] int64 segment of each block) for
    dequant rows of one segment ([K, 2, 64]) or of G ([G, K, 2, 64])."""
    deq4 = deq[None] if deq.dim() == 3 else deq
    g = deq4.shape[0]
    seg = torch.arange(nblocks, device=deq.device) // max(nblocks // g, 1)
    return deq4, seg


def _i16(x: torch.Tensor) -> torch.Tensor:
    """int16 wraparound in the int32 domain."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _mul16(c: int, x: torch.Tensor) -> torch.Tensor:
    """(c * x) >> 16 with c a positive constant < 2**16; |x| <= 2**15
    keeps the product inside int32."""
    return (c * x) >> 16


def idct8(x: torch.Tensor) -> torch.Tensor:
    """1-D 8-point iDCT along the last axis (idct.c:30-81); int32."""
    t0 = _mul16(C4S4, _i16(x[..., 0] + x[..., 4]))
    t1 = _mul16(C4S4, _i16(x[..., 0] - x[..., 4]))
    t2 = _mul16(C6S2, x[..., 2]) - _mul16(C2S6, x[..., 6])
    t3 = _mul16(C2S6, x[..., 2]) + _mul16(C6S2, x[..., 6])
    t4 = _mul16(C7S1, x[..., 1]) - _mul16(C1S7, x[..., 7])
    t5 = _mul16(C3S5, x[..., 5]) - _mul16(C5S3, x[..., 3])
    t6 = _mul16(C5S3, x[..., 5]) + _mul16(C3S5, x[..., 3])
    t7 = _mul16(C1S7, x[..., 1]) + _mul16(C7S1, x[..., 7])
    t4, t5 = t4 + t5, _mul16(C4S4, _i16(t4 - t5))
    t7, t6 = t7 + t6, _mul16(C4S4, _i16(t7 - t6))
    t0, t3 = t0 + t3, t0 - t3
    t1, t2 = t1 + t2, t1 - t2
    t6, t5 = t6 + t5, t6 - t5
    return torch.stack(
        [
            _i16(t0 + t7), _i16(t1 + t6), _i16(t2 + t5), _i16(t3 + t4),
            _i16(t3 - t4), _i16(t2 - t5), _i16(t1 - t6), _i16(t0 - t7),
        ],
        dim=-1,
    )


def idct8x8(coeffs: torch.Tensor) -> torch.Tensor:
    """Dense 2-D iDCT: [N, 8, 8] int32 natural-order coefficients ->
    [N, 8, 8] residuals; row pass, then column pass (idct.c:285-296)."""
    w = idct8(coeffs).transpose(-1, -2)
    y = idct8(w).transpose(-1, -2)
    return _i16((y + 8) >> 4)


def dc_fill(dc: torch.Tensor, dc_quant: torch.Tensor) -> torch.Tensor:
    """[N] -> [N, 8, 8]: DC-only blocks (state.c:967-975)."""
    p = _i16((dc * dc_quant + 15) >> 5)
    return p[:, None, None].expand(*p.shape, 8, 8)


def dequantize_idct(coeffs_zz, dequant_zz, dc, dc_quant, dc_only):
    """Reconstruct residual blocks.

    coeffs_zz: [N, 64] int32 quantized coefficients, zig-zag, DC slot
    ignored; dequant_zz: [N, 64] int32 factors (zig-zag); dc: [N]
    predicted DC; dc_quant: [N]; dc_only: [N] bool, the blocks that take
    the decoder's last_zzi < 2 path. Returns [N, 8, 8] int32.
    """
    deq = _i16(coeffs_zz * dequant_zz)
    deq[:, 0] = _i16(dc * dc_quant)  # deq is a fresh tensor: in place
    nat = torch.zeros_like(deq)
    nat[:, _ZZ.to(deq.device)] = deq
    full = idct8x8(nat.reshape(-1, 8, 8))
    return torch.where(dc_only[:, None, None], dc_fill(dc, dc_quant), full)


def dequantize_idct_frames(qz, dc, deq_tab, frame, qii, inter, dc_only):
    """Dequant + iDCT of the blocks of F frames of one plane (kernel K1's
    function; the decode scan's step at theora_tpu/decode/tpu_batch.py:
    85-111).

    qz: [N, 64] int16 zig-zag, DC slot ignored; dc: [N] int16 predicted
    DC; deq_tab: [F, 3, 2, 64] int16 per-frame dequant rows indexed
    (qii, inter); frame: [N] int32; qii, inter: [N] uint8; dc_only: [N]
    bool. The DC factor is deq_tab[frame, 0, inter, 0]. Returns [N, 64]
    int16 residuals in raster order inside each block.
    """
    tab = deq_tab.to(torch.int32)
    f = frame.long()
    t = inter.long()
    rows = tab[f, qii.long(), t]
    dcq = tab[f, 0, t, 0]
    res = dequantize_idct(qz.to(torch.int32), rows, dc.to(torch.int32), dcq,
                          dc_only)
    return res.reshape(-1, 64).to(torch.int16)


def choose_rows(ssd, cnt, lam, lam_sc):
    """Each block's qi row by the scan's R/D proxy (tpu_gop.py:256-285):
    the least 16 ssd + int32(lam * lam_sc * (6 cnt + 2 + 6 [k > 0])), in
    float32 and in that order, truncated toward zero; a tie keeps the
    earlier row.

    ssd, cnt: [K, n] int32; lam: float32 0-d tensor or [n] per block;
    lam_sc: [n] float32 or None (all ones). Returns [n] uint8 row
    indices.
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


def idct_recon_choose(q16, dc_only, cnt, deq, inter, pred, cur, lam,
                      lam_sc=None):
    """The encode scan's step after the trellis (kernel K1's encode entry;
    the JAX scan's dequant + iDCT, reconstruction, SSD and qi chooser at
    theora_tpu/encode/tpu_gop.py:231-285): each of the K qi rows through
    `dequantize_idct_frames` as one launch over K x N (row, block) pairs
    (qii = row, DC from the values' slot 0 with row 0's DC factor), the
    clamp to [0, 255], the int32 SSD against the source, and each block's
    row by `choose_rows`.

    q16: [K, N, 64] int16 values; dc_only: [K, N] bool; cnt: [K, N] int32;
    deq: [K, 2, 64] int16 dequant rows (every row's slot 0 the base qi's
    DC factor); inter: [N] uint8; pred: [N, 64] int32; cur: [N, 64] uint8;
    lam: float32 0-d tensor; lam_sc: None or [N] float32. With G segments:
    deq [G, K, 2, 64] and lam [G], segment g's rows as frame g of the
    dequant table and its lambda for its blocks. Returns (recon [N, 64]
    uint8, ssd [N] int32, qii [N] uint8, q [N, 64] int16, cnt [N] int32)
    of each block's kept row; at K = 1, row 0 (q and cnt are views).
    """
    K, n = q16.shape[0], q16.shape[1]
    dev = q16.device
    deq4, seg = _segments(deq, n)
    flat = q16.reshape(K * n, 64)
    deq_tab = torch.zeros((deq4.shape[0], 3, 2, 64), dtype=torch.int16,
                          device=dev)
    deq_tab[:, :K] = deq4
    residual = dequantize_idct_frames(
        flat, flat[:, 0].contiguous(), deq_tab,
        seg.to(torch.int32).repeat(K),
        torch.arange(K, dtype=torch.uint8, device=dev).repeat_interleave(n),
        inter.repeat(K), dc_only.reshape(K * n))
    recon = torch.clamp(residual.to(torch.int32).reshape(K, n, 64) + pred,
                        0, 255)
    dr = recon - cur.to(torch.int32)
    ssd = (dr * dr).sum(dim=2, dtype=torch.int32)
    if K == 1:
        return (recon[0].to(torch.uint8), ssd[0],
                torch.zeros(n, dtype=torch.uint8, device=dev), q16[0], cnt[0])
    qii = choose_rows(ssd, cnt, lam if lam.dim() == 0 else lam[seg],
                      lam_sc)
    sel, blk = qii.long(), torch.arange(n, device=dev)
    return (recon[sel, blk].to(torch.uint8), ssd[sel, blk], qii,
            q16[sel, blk], cnt[sel, blk])


def fdct8(x: torch.Tensor) -> torch.Tensor:
    """1-D 8-point fDCT along the last axis (fdct.c:27-120); int32."""
    t0 = x[..., 0] + x[..., 7]
    t7 = x[..., 0] - x[..., 7]
    t1 = x[..., 1] + x[..., 6]
    t6 = x[..., 1] - x[..., 6]
    t2 = x[..., 2] + x[..., 5]
    t5 = x[..., 2] - x[..., 5]
    t3 = x[..., 3] + x[..., 4]
    t4 = x[..., 3] - x[..., 4]
    t0, t3 = t0 + t3, t0 - t3
    t1, t2 = t1 + t2, t1 - t2
    t6, t5 = t6 + t5, t6 - t5

    def nz(t):
        return (t != 0).to(torch.int32)

    s = (((27146 * t5 + 0xB500) >> 16) + t5 + nz(t5)) >> 1
    t4, t5 = t4 + s, t4 - s
    s = (((27146 * t6 + 0xB500) >> 16) + t6 + nz(t6)) >> 1
    t7, t6 = t7 + s, t7 - s
    r = ((27146 * t0 + 0x4000) >> 16) + t0 + nz(t0)
    s = ((27146 * t1 + 0xB500) >> 16) + t1 + nz(t1)
    u = (r + s) >> 1
    y0, y4 = u, r - u
    u = ((C6S2 * t2 + C2S6 * t3 + 0x6CB7) >> 16) + nz(t3)
    s = ((C6S2 * u) >> 16) - t2
    y2, y6 = u, ((s * 21600 + 0x2800) >> 18) + s + nz(s)
    u = ((C5S3 * t6 + C3S5 * t5 + 0x0E3D) >> 16) + nz(t5)
    s = t6 - ((C5S3 * u) >> 16)
    y5, y3 = u, ((s * 26568 + 0x3400) >> 17) + s + nz(s)
    u = ((C7S1 * t4 + C1S7 * t7 + 0x7B1B) >> 16) + nz(t7)
    s = ((C7S1 * u) >> 16) - t4
    y1, y7 = u, ((s * 20539 + 0x3000) >> 20) + s + nz(s)
    return _i16(torch.stack([y0, y1, y2, y3, y4, y5, y6, y7], dim=-1))


def fdct8x8(res: torch.Tensor) -> torch.Tensor:
    """[N, 8, 8] residuals -> [N, 64] zig-zag DCT coefficients, int32
    (fdct.c:128-154): x4 scaling, the systematic-error biases of x[0],
    x[1] and x[8], a column pass, a row pass, then (y + 2) >> 2."""
    w = res.to(torch.int32) << 2
    w[:, 0, 0] += (w[:, 0, 0] != 0).to(torch.int32) + 1
    w[:, 0, 1] += 1
    w[:, 1, 0] -= 1
    y = fdct8(w.transpose(-1, -2))
    w2 = fdct8(y.transpose(-1, -2))
    flat = w2.reshape(w2.shape[0], 64)
    return _i16((flat[:, _ZZ.to(flat.device)] + 2) >> 2)


def quantize(dct_zz: torch.Tensor, dequant_zz: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest quantizer, ties away from zero
    (enquant.c:220-249); int32."""
    d = dequant_zz.to(torch.int32)
    v2 = dct_zz.abs() << 1
    q = torch.where(v2 >= d, torch.div(v2 + d, 2 * d, rounding_mode="floor"),
                    0)
    return torch.sign(dct_zz) * q


def fdct_quantize(res, deq, inter):
    """fDCT of [N] blocks of one plane of one frame and their
    round-to-nearest quantization with each of K qi rows (kernel K2's
    function; the JAX encode scan's `fdct8x8` + `quantize` at
    theora_tpu/encode/tpu_gop.py:203-218, once per qi row with adaptive
    quantization, :249-264; the Pallas kernel `fdct_quantize_soa`).

    res: [N, 64] int16 residuals, raster order inside each block; deq:
    [K, 2, 64] int16 zig-zag dequant rows, per qi row the intra row, then
    the inter row; inter: [N] uint8, the row each block uses; with G
    segments deq [G, K, 2, 64]. Returns ([K, N, 64] int16 zig-zag
    quantized coefficients, [N, 64] int16 zig-zag unquantized DCT, the
    trellis' input).
    """
    dct = fdct8x8(res.reshape(-1, 8, 8))
    deq4, seg = _segments(deq, res.shape[0])
    rows = deq4.to(torch.int32)[seg, :, inter.long()].transpose(0, 1) \
        .contiguous()
    return quantize(dct[None], rows).to(torch.int16), dct.to(torch.int16)


def rd_lambda(qi: int, dequant_ac: int) -> float:
    """R/D lambda of the skip test, 0.2125 * qavg^2 with qavg the AC
    quantizer in the x4 domain (theora_tpu/ops/fdct_np.py:rd_lambda,
    after rate.c:151-202)."""
    return 0.2125 * float(dequant_ac) * float(dequant_ac) / 16.0


# ---------------------------------------------------------------------------
# Batched trellis quantizer (transforms_jax.trellis_values, the device
# counterpart of the host Viterbi tokenizer, tokenize.c:457-744): a dense
# dynamic program over the 63 AC positions of every block at once, float32
# costs. Its decisions must equal the JAX package's, so every float32
# operation is the JAX program's, in its order, as XLA on the CPU runs it:
#   - the prefix sum of c^2 is reduce-window based: sequential inside
#     chunks of 16 positions, the chunk totals summed sequentially and
#     added to each chunk (`_xla_cumsum16`); torch.cumsum adds in another
#     order (and accumulates float32 in double on the CPU);
#   - XLA's CPU compiler contracts a*b + c into one fused multiply-add
#     where the product feeds the add directly, and which product of a
#     sum of two it takes depends on the compiled context (ROADMAP.md §3,
#     F4). In the JAX encoder's plane scan, whose steps carry the
#     lambda's two factors, the three cost sums with a lambda all fuse
#     lam * bits: the lone and the next-lower value's costs e*e +
#     lam*bits as fma(lam, bits, e*e), the EOB cost (P[64] - P[i]) +
#     lam*bits as fma(lam, bits, P[64] - P[i])
#     (testdata/probe_trellis_fma_context.py). Adaptive quantization's
#     per-block scales make lam fractional and lam * bits inexact, where
#     the placement decides near-ties. `_fma` computes them with one
#     rounding. Every other product feeds no add or adds a 0 / 1e30
#     mask, where contraction changes nothing;
#   - no other op may fuse (no addcmul), and nothing uses TF32.

def _value_token_id(mag, neg):
    """Token id of a lone coefficient of magnitude mag >= 1 (tokenize.c
    category layout)."""
    t = torch.where(mag <= 2, 9 + (mag - 1) * 2 + neg, 0)
    t = torch.where((mag >= 3) & (mag <= 6), 10 + mag, t)
    t = torch.where((mag >= 7) & (mag <= 8), 17, t)
    t = torch.where((mag >= 9) & (mag <= 12), 18, t)
    t = torch.where((mag >= 13) & (mag <= 20), 19, t)
    t = torch.where((mag >= 21) & (mag <= 36), 20, t)
    t = torch.where((mag >= 37) & (mag <= 68), 21, t)
    return torch.where(mag >= 69, 22, t)


def _alt_mag(mag):
    """Top of the next-lower value-token category."""
    alt = torch.where(mag <= 6, mag - 1, 0)
    alt = torch.where((mag >= 7) & (mag <= 8), 6, alt)
    alt = torch.where((mag >= 9) & (mag <= 12), 8, alt)
    alt = torch.where((mag >= 13) & (mag <= 20), 12, alt)
    alt = torch.where((mag >= 21) & (mag <= 36), 20, alt)
    alt = torch.where((mag >= 37) & (mag <= 68), 36, alt)
    return torch.where(mag >= 69, 68, alt)


def _xla_cumsum16(z: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum of [N, 64] along dim 1 in the order of
    XLA's CPU reduce-window rewrite (chunks of 16)."""
    n = z.shape[0]
    loc = z.reshape(n, 4, 16).clone()
    for j in range(1, 16):
        loc[:, :, j] = loc[:, :, j - 1] + loc[:, :, j]
    tot = loc[:, :, 15]
    pre = torch.zeros((n, 4), dtype=z.dtype, device=z.device)
    for c in range(1, 4):
        pre[:, c] = pre[:, c - 1] + tot[:, c - 1]
    return (loc + pre[:, :, None]).reshape(n, 64)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, as a fused multiply-add. The
    float64 product of two float32 values is exact; the float64 sum is
    rounded to odd (its exact error from a two-sum moves an even result
    one ulp towards the exact value), which makes the final rounding to
    float32 the correctly rounded one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=s.device)
    odd = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    return torch.where((err != 0) & even, odd, s).float()


def trellis_values(dct_zz, qdct_rtn, dequant_zz, lam, nb_full, acmin):
    """Jointly choose quantized values minimizing d^2 + lam * bits over
    the block's token structure (runs, combos, EOB placement).

    dct_zz, qdct_rtn, dequant_zz: [N, 64] int32 (unquantized DCT, its
    round-to-nearest quantization, dequant factors; zig-zag); lam: [N]
    float32; nb_full: [64, 32] float32 bits per (position, token); acmin:
    [N] int32, positions below it code values rate-free. Returns [N, 64]
    int32 chosen values, DC passed through.
    """
    dev = dct_zz.device
    f32 = torch.float32
    N = dct_zz.shape[0]
    big = torch.tensor(_BIG, dtype=f32, device=dev)
    cf = dct_zz.to(f32)
    df = dequant_zz.to(f32)
    q = qdct_rtn
    jcols = torch.arange(64, device=dev)
    idx = torch.arange(63, 0, -1, device=dev)
    z = torch.where(q != 0, cf * cf, 0.0)
    P = torch.cat([torch.zeros((N, 1), dtype=f32, device=dev),
                   _xla_cumsum16(z)], dim=1)
    aj = q.abs()
    sj = torch.where(q < 0, -1, 1).to(torch.int32)
    m23 = torch.where(aj > 2, 3, 2)
    cv23 = sj * m23

    lamv = torch.where(jcols[None, :] < acmin[:, None], 0.0, lam[:, None])
    a_cl = torch.clamp(aj, max=580)
    neg = (q < 0).to(torch.int32)
    tokA = _value_token_id(torch.clamp(a_cl, min=1), neg)
    altm = _alt_mag(a_cl)
    tokB = _value_token_id(torch.clamp(altm, min=1), neg)
    pos = jcols[None, :].expand(N, 64)
    nbA = nb_full[pos, tokA]
    nbB = nb_full[pos, tokB]
    eA = (a_cl * sj).to(f32) * df - cf
    eB = (altm * sj).to(f32) * df - cf
    cA_s = _fma(lamv, nbA, eA * eA)
    cB_s = _fma(lamv, nbB, eB * eB)
    useB = (altm >= 1) & (cB_s < cA_s)
    c1_s = torch.where(aj >= 1, torch.where(useB, cB_s, cA_s), big)
    v1_s = torch.where(aj >= 1, torch.where(useB, altm * sj, a_cl * sj), 0)
    e1j = cf - sj.to(f32) * df
    e23j = cf - cv23.to(f32) * df
    pre1 = torch.where((aj >= 1) & (aj <= 2), e1j * e1j, big)
    pre23 = torch.where((aj >= 2) & (aj <= 4), e23j * e23j, big)
    costc_s = _fma(lam[:, None].expand(N, 64),
                   nb_full[:, 0][None].expand(N, 64), P[:, 64:] - P[:, :64])
    # Per-step rows by run length r = j - i (the i == 1 step keeps one
    # slot of headroom for a zero DC extending the leading run).
    r_si = jcols[None, :] - idx[:, None]                  # [63, 64]
    maskj_si = r_si > 0
    nbi = nb_full[idx]                                    # [63, 32]
    zb_si = torch.where(r_si <= 8, nbi[:, 7:8], nbi[:, 8:9])
    amask_si = torch.where(maskj_si, 0.0, big)
    cb1_si = torch.where(r_si <= 5, nbi[:, 22:23], 0.0)
    for rr, ti in ((1, 23), (2, 24), (3, 25), (4, 26), (5, 27)):
        cb1_si = torch.where(r_si == rr, nbi[:, ti:ti + 1], cb1_si)
    cb1_si = torch.where((r_si >= 6) & (r_si <= 9), nbi[:, 28:29], cb1_si)
    cb1_si = torch.where(r_si >= 10, nbi[:, 29:30], cb1_si)
    dc_allow = torch.where(idx == 1, 0, 1)[:, None]
    b1mask_si = torch.where(maskj_si & (r_si <= 16 + dc_allow), 0.0, big)
    cb23_si = torch.where(r_si == 1, nbi[:, 30:31], nbi[:, 31:32])
    b23mask_si = torch.where(maskj_si & (r_si <= 2 + dc_allow), 0.0, big)

    # Forward DP over positions 63..1; per position one int32 decision
    # word (bits 0-10 node1 value + 1024, 11 node1 successor, 12-13 node0
    # ending, 14-19 node0 run end, 20-30 node0 combo value + 1024).
    cost0 = torch.full((N, 64), _BIG, dtype=f32, device=dev)
    cost0[:, 0] = 0.0
    cost1 = torch.full((N, 64), _BIG, dtype=f32, device=dev)
    c0p = torch.zeros(N, dtype=f32, device=dev)
    c1p = torch.full((N,), _BIG, dtype=f32, device=dev)
    lamc = lam[:, None]
    Pj = P[:, :64]
    words = []
    for k in range(63):
        i = 63 - k
        bn_next = torch.minimum(c0p, c1p)
        next1 = (c1p < c0p).to(torch.int32)
        c1 = c1_s[:, i] + bn_next
        D2 = Pj - P[:, i:i + 1]
        costa = D2 + (lamc * zb_si[k][None, :] + amask_si[k][None, :]) + cost1
        bn = torch.minimum(cost0, cost1)
        bn_nextj = torch.roll(bn, -1, dims=1)
        cost_b1 = (pre1 + D2 + (lamc * cb1_si[k][None, :]
                                + b1mask_si[k][None, :]) + bn_nextj)
        cost_b23 = (pre23 + D2 + (lamc * cb23_si[k][None, :]
                                  + b23mask_si[k][None, :]) + bn_nextj)
        m_b = torch.minimum(cost_b1, cost_b23)
        m_j = torch.minimum(costa, m_b)
        # First minimum, as jnp.argmin picks it, by an integer min over
        # the tied positions (no reliance on a reduction's tie order).
        cbest = m_j.amin(dim=1)
        jbest = torch.where(m_j == cbest[:, None], jcols, 64).amin(dim=1)
        typ_j = torch.where(costa <= m_b, 1,
                            torch.where(cost_b1 <= cost_b23, 2, 3))
        jb = jbest[:, None]
        typ_at = torch.gather(typ_j, 1, jb)[:, 0]
        cv_j = torch.where(typ_j == 3, cv23, sj)
        cv_at = torch.gather(cv_j, 1, jb)[:, 0]
        costc = costc_s[:, i]
        use_eob = costc <= cbest
        c0 = torch.where(use_eob, costc, cbest)
        e0 = torch.where(use_eob, 0, typ_at)
        words.append(
            (v1_s[:, i] + 1024)
            | (next1 << 11)
            | (e0 << 12)
            | (torch.where(use_eob, 0, jbest) << 14)
            | ((cv_at + 1024) << 20)
        )
        cost0[:, i] = c0
        cost1[:, i] = c1
        c0p, c1p = c0, c1

    # Backtrack: one sweep over positions 1..63, each block carrying its
    # next event (position, node kind, pending combo value).
    ep = torch.ones(N, dtype=torch.int64, device=dev)
    nd = (cost1[:, 1] < cost0[:, 1]).to(torch.int64)
    runend = torch.zeros(N, dtype=torch.bool, device=dev)
    pend = torch.zeros(N, dtype=torch.int64, device=dev)
    take = torch.zeros(N, dtype=torch.bool, device=dev)
    out = torch.zeros((N, 64), dtype=torch.int32, device=dev)
    for p in range(1, 64):
        w = words[63 - p].to(torch.int64)
        v1 = (w & 0x7FF) - 1024
        nxt1 = (w >> 11) & 1
        er = (w >> 12) & 3
        jr = (w >> 14) & 63
        cv = ((w >> 20) & 0x7FF) - 1024
        at = ep == p
        isn = at & ~runend
        isr = at & runend
        n1 = isn & (nd == 1)
        run = isn & (nd == 0) & (er != 0)
        out[:, p] = torch.where(
            n1, v1, torch.where(isr, torch.where(take, v1, pend), 0)
        ).to(torch.int32)
        adv = n1 | isr
        ep = torch.where(at, torch.where(adv, p + 1,
                                         torch.where(run, jr, 0)), ep)
        nd = torch.where(adv, nxt1, nd)
        runend = torch.where(at, run, runend)
        pend = torch.where(run, cv, pend)
        take = torch.where(run, er == 1, take)
    out[:, 0] = q[:, 0]
    return out


def trellis_quantize(qout, dout, deq, inter, lam, nb_full, lam_sc=None):
    """The trellis on kernel K2's outputs for [N] blocks of one plane of
    one frame at each of K qi rows: trellis_values behind the casts this
    interface needs.

    qout: [K, N, 64] int16 zig-zag round-to-nearest values and dout:
    [N, 64] int16 unquantized DCT (fdct_quantize's outputs); deq: [K, 2,
    64] int16 dequant rows (per qi row intra, inter); inter: [N] uint8,
    nonzero for an inter block (dequant row 1, acmin 0; an intra block:
    row 0, acmin 3); lam: [K] float32, the frame's lambda per qi row;
    nb_full: [64, 32] float32; lam_sc: [N] float32 per-block lambda
    scales or None. Block n of row k takes the float32 product lam[k] *
    lam_sc[n] (theora_tpu/encode/tpu_gop.py:228), lam[k] without lam_sc.
    With G segments: deq [G, K, 2, 64] and lam [G, K], block n taking its
    segment's rows and lambdas. Returns ([K, N, 64] int16 chosen values,
    [K, N] int32 nonzero counts, [K, N] bool "no AC value is nonzero").
    """
    k, n = qout.shape[:2]
    dev = qout.device
    is_inter = inter != 0
    deq4, seg = _segments(deq, n)
    lam_gk = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    lam_k = lam_gk.reshape(-1, k)[seg].T              # [K, N]
    lam_b = lam_k if lam_sc is None else lam_k * lam_sc[None]
    vals = trellis_values(
        dout.to(torch.int32).repeat(k, 1),
        qout.reshape(k * n, 64).to(torch.int32),
        deq4.to(torch.int32)[seg, :, is_inter.long()].transpose(0, 1)
        .reshape(k * n, 64),
        lam_b.reshape(k * n).contiguous(), nb_full,
        torch.where(is_inter, 0, 3).to(torch.int32).repeat(k))
    nzf = vals != 0
    cnt = nzf.sum(dim=1, dtype=torch.int32)
    dc_only = (cnt - nzf[:, 0].to(torch.int32)) == 0
    return (vals.to(torch.int16).reshape(k, n, 64), cnt.reshape(k, n),
            dc_only.reshape(k, n))


# ---------------------------------------------------------------------------
# R/D quantizer (transforms_jax.quantize_rd, the speed levels' and
# use_trellis=False's quantizer): per AC coefficient a magnitude reduction,
# two sweeps that kill isolated +-1 values and four that kill a block's
# last +-1, each accepted when it wins d^2 + lam * bits in float32. As XLA
# on the CPU compiles it, three of its float32 expressions contract into a
# fused multiply-add (found with testdata/make_qrd_fma_cases.py):
#   - the magnitude test err + lam * bits, on both sides, as fma(lam, bits,
#     err) (err = t * t, rounded);
#   - the kill sweeps' gain av * av - err_coded as fma(av, av, -err_coded)
#     (err_coded = (d - av)^2, rounded).
# With the encoder's dequant values (<= 304) every square is an exact
# integer and only the first matters: lam * bits is inexact.

# Bits of a lone value of magnitude 0..8 (transforms_jax._MAG_BITS_J).
_MAG_BITS = torch.tensor([0.0, 4.5, 5.5, 6.5, 6.5, 7.5, 7.5, 8.5, 9.5])
_ISO_BITS = 11.0
_TAIL_BITS = 14.0


def quantize_rd_values(q0, dct_zz, dequant_zz, lam):
    """The R/D quantizer's values from the round-to-nearest ones.

    q0: [N, 64] int32 round-to-nearest values (quantize(dct_zz,
    dequant_zz), kernel K2's output); dct_zz, dequant_zz: [N, 64] int32
    (zig-zag); lam: [N] float32. Returns [N, 64] int32, DC passed
    through.
    """
    dev = q0.device
    f32 = torch.float32
    d = dequant_zz.to(f32)
    av = dct_zz.abs().to(f32)
    lamc = lam[:, None]
    a0 = q0.abs()
    a1 = torch.clamp(a0 - 1, min=0)
    mb = _MAG_BITS.to(dev)
    t0 = a0.to(f32) * d - av
    t1 = a1.to(f32) * d - av
    bits0 = mb[torch.clamp(a0, max=8)]
    bits1 = mb[torch.clamp(a1, max=8)]
    take1 = _fma(lamc.expand_as(d), bits1, t1 * t1) <= _fma(
        lamc.expand_as(d), bits0, t0 * t0)
    out = torch.where(take1, torch.sign(q0) * a1, q0)
    out[:, 0] = q0[:, 0]
    # Isolated kill: a lone +-1 between zeros (position 1's left and
    # position 63's right neighbour count as zero); two sweeps, the second
    # on the first's output.
    tc = d - av
    gain = _fma(av, av, -(tc * tc))
    kill_iso = gain <= lamc * _ISO_BITS
    for _ in range(2):
        nz = out != 0
        left_zero = torch.ones_like(nz)
        left_zero[:, 2:] = ~nz[:, 1:-1]
        right_zero = torch.ones_like(nz)
        right_zero[:, :-1] = ~nz[:, 1:]
        iso = nz & left_zero & right_zero & (out.abs() == 1)
        iso[:, 0] = False
        out = torch.where(iso & kill_iso, 0, out)
    # Tail kill: a block's last nonzero AC value, if +-1; four sweeps.
    rows = torch.arange(out.shape[0], device=dev)
    pos = torch.arange(64, device=dev)
    for _ in range(4):
        nz = out != 0
        nz[:, 0] = False
        has = nz.any(dim=1)
        last = torch.where(nz, pos, 0).amax(dim=1)
        q_at = out[rows, last]
        t_at = q_at.abs().to(f32) * d[rows, last] - av[rows, last]
        v_at = av[rows, last]
        kill = has & (q_at.abs() == 1) & (
            _fma(v_at, v_at, -(t_at * t_at)) <= lam * _TAIL_BITS)
        out[rows, last] = torch.where(kill, 0, q_at)
    return out


def quantize_rd(dct_zz, dequant_zz, lam):
    """transforms_jax.quantize_rd: dct_zz, dequant_zz [N, 64] int32, lam
    [N] float32 -> [N, 64] int32."""
    return quantize_rd_values(quantize(dct_zz, dequant_zz), dct_zz,
                              dequant_zz, lam)


def quantize_rd_rows(qout, dout, deq, inter, lam_q):
    """The R/D quantizer on kernel K2's outputs for [N] blocks of one
    plane of one frame at each of K qi rows (kernel KR's function; the JAX
    scan's quantize_rd at theora_tpu/encode/tpu_gop.py:230-236, once per
    qi row), with trellis_quantize's output contract.

    qout: [K, N, 64] int16 round-to-nearest values and dout: [N, 64] int16
    unquantized DCT (fdct_quantize's outputs); deq: [K, 2, 64] int16
    dequant rows (per qi row intra, inter); inter: [N] uint8; lam_q: [K, 2]
    float32 (per qi row the intra and the inter lambda; block n takes
    lam_q[k, inter[n] != 0], keyed by the block, not the frame). With G
    segments: deq [G, K, 2, 64] and lam_q [G, K, 2], block n taking its
    segment's. Returns ([K, N, 64] int16 values, DC passed through; [K, N]
    int32 nonzero counts; [K, N] bool "no AC value is nonzero").
    """
    k, n = qout.shape[:2]
    dev = qout.device
    sel = (inter != 0).long()
    deq4, seg = _segments(deq, n)
    lam_g = torch.as_tensor(lam_q, dtype=torch.float32, device=dev)
    lam = lam_g.reshape(-1, k, 2)[seg, :, sel].T      # [K, N]
    vals = quantize_rd_values(
        qout.reshape(k * n, 64).to(torch.int32),
        dout.to(torch.int32).repeat(k, 1),
        deq4.to(torch.int32)[seg, :, sel].transpose(0, 1).reshape(k * n, 64),
        lam.reshape(k * n).contiguous())
    nzf = vals != 0
    cnt = nzf.sum(dim=1, dtype=torch.int32)
    dc_only = (cnt - nzf[:, 0].to(torch.int32)) == 0
    return (vals.to(torch.int16).reshape(k, n, 64), cnt.reshape(k, n),
            dc_only.reshape(k, n))
