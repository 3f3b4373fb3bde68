"""The yardstick's counting: the operations and bytes each hand kernel
of the port must at least execute and move for one call, and the H100's
published peaks they are divided by.

Frozen copies, function by function, of the port's tools/bench_*.py at
commit 6cd77e7 (each block names its file); only their imports of one
another were taken out. The benchmark divides the sum of these bounds over
a traced stretch's launches by the launches' traced time; later changes
to the port do not move this yardstick."""
from __future__ import annotations

import numpy as np
import torch

# theora_tpu_torch/tools/bench_fdct.py
# int32 operations outside the tensor cores: half the 67 TFLOP/s float32
# rate (an SM has 64 INT32 lanes beside its 128 FP32 lanes).
INT32_OPS_S = 33.5e12


# theora_tpu_torch/tools/bench_fdct.py
def k2_ops(n: int, k: int) -> int:
    """int32 operations of csrc/fdct_quant.cu for n blocks at k qi rows:
    per block 16 1-D fDCTs of 119 ops (8 input adds, 6 butterflies, 2 x 9
    for the t5/t6 rotations, 15 for y0/y4, 3 x 16 for y2/y6, y5/y3,
    y1/y7, 8 wraps of 3), 64 input x4 scalings and 64 output
    round/shift/wraps (5 ops); per value and qi row one quantization
    (abs, halved dequant, add, widening multiply, shift, sign: 6 ops)."""
    return n * (16 * 119 + 64 + 64 * 5 + k * 64 * 6)


# theora_tpu_torch/tools/bench_trellis.py
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# float32 rate outside the tensor cores.
HBM_BYTES_S = 3.35e12


# theora_tpu_torch/tools/bench_trellis.py
FP32_OPS_S = 67e12


# theora_tpu_torch/tools/bench_trellis.py
def _kt_pairs(limit: int) -> np.ndarray:
    """[64] per position j: the DP steps i (1 <= i < j) at which a run
    from i may end at j within run length limit (limit - 1 at i == 1,
    where the DC keeps one slot of headroom)."""
    return np.array([sum(j - i <= (limit - 1 if i == 1 else limit)
                         for i in range(1, j)) for j in range(64)])


# theora_tpu_torch/tools/bench_trellis.py
def kt_float_ops(qrtn: np.ndarray) -> int:
    """The float32 operations the trellis needs for these blocks ([N, 64]
    round-to-nearest values), a fused multiply-add counted as two, as the
    67 TFLOP/s peak counts it. Only a nonzero position can end a run
    (every other one costs _BIG), a +-1 combo only at magnitude 1-2 and
    run length <= 17, a +-2/3 combo only at magnitude 2-4 and run length
    <= 3. Set-up: c^2 and its prefix sum per nonzero position (2), the
    EOB cost per AC position (3); per nonzero AC position the value's
    error and token cost (5), the next-lower value's and the compare
    (6, magnitude >= 2), each combo's error base (3). Per DP step: the
    best next cost, node1's cost, the EOB compare (3), each position's
    best cost (1). Per (step, nonzero position) pair: D2 and the run +
    value cost (4) and the first-minimum reduction (1); each combo in
    reach 4 and a minimum. The integer work (token ids, decision words,
    backtrack) runs on the separate INT32 pipe and binds less."""
    a = np.abs(qrtn.astype(np.int64))
    nz = a != 0
    ac = a[:, 1:]
    j = np.arange(1, 64)
    nzac = ac != 0
    c1 = (ac >= 1) & (ac <= 2)
    c23 = (ac >= 2) & (ac <= 4)
    setup = (2 * nz.sum() + 63 * 3 * len(a) + 5 * nzac.sum()
             + 6 * (ac >= 2).sum() + 3 * c1.sum() + 3 * c23.sum())
    dp = (63 * 4 * len(a) + nzac.sum() + 5 * (nzac * (j - 1)).sum()
          + 5 * (c1 * _kt_pairs(17)[1:]).sum()
          + 5 * (c23 * _kt_pairs(3)[1:]).sum())
    return int(setup + dp)


# theora_tpu_torch/tools/bench_trellis.py
def kt_bound(args) -> dict:
    """KT's least time for these arguments: each input read once (the
    [K, N, 64] and [N, 64] int16 rows, [N] flags, the dequant rows, the K
    lambdas, the [N] lambda scales if any, the bit table), each output
    written once ([K, N, 64] int16, [K, N] int32, [K, N] bool), over the
    memory rate; the float32 operations these inputs need (a lambda
    scale's product per pair included) over the float32 rate. The larger
    binds."""
    qout, dout, deq, inter, lam, nb, lam_sc = args
    k, n = qout.shape[:2]
    ins = [qout, dout, deq, inter, nb] + ([] if lam_sc is None else [lam_sc])
    nbytes = (sum(a.numel() * a.element_size() for a in ins) + 4 * k
              + k * n * (64 * 2 + 4 + 1))
    ops = kt_float_ops(qout.reshape(-1, 64).cpu().numpy())
    if lam_sc is not None:
        ops += k * n
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / FP32_OPS_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# theora_tpu_torch/tools/bench_idct.py
# int32 operations of one block through dequant and both passes: 16 1-D
# iDCTs of 16 (c*x)>>16 products (2 ops), 12 wraps (3 ops) and 28 adds;
# 64 dequant products with a wrap (4 ops); 64 output round/shift/wraps
# (5 ops).
IDCT_OPS = 16 * (16 * 2 + 12 * 3 + 28) + 64 * 4 + 64 * 5


# theora_tpu_torch/tools/bench_idct.py
FILL_OPS = 6  # a DC-only block: product, bias, shift, wrap


# theora_tpu_torch/tools/bench_idct.py
# Per (row, block) of the encode entry: per pixel add, two clamps,
# subtract, square, sum (6 ops), the 8-lane sum (3 shuffles and adds), and
# the cost's integer part (multiply, add, compare).
RECON_OPS = 64 * 6 + 6 + 3


# theora_tpu_torch/tools/bench_idct.py
COST_FLOPS = 4  # 6 cnt, + 2, + 6, times lam_b (float32)


# theora_tpu_torch/tools/bench_idct.py
def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# theora_tpu_torch/tools/bench_idct.py
def k1_bytes(entry: str, args) -> int:
    """Bytes K1 must move for these arguments: each input read once, each
    output written once. The decode entry reads no coefficients of a
    DC-only block; the encode entry writes the kept row's values and count
    only at K > 1 (at K = 1 the wrapper returns views of its inputs)."""
    if entry == "decode":
        qz, dc, tab, frame, qii, inter, dc_only = args
        n = qz.shape[0]
        live = n - int(dc_only.sum())
        return (live * 128 + _nbytes(dc, tab, frame, qii, inter, dc_only)
                + n * 128)
    q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc = args
    k, n = q16.shape[0], q16.shape[1]
    return (_nbytes(q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc)
            + n * (64 + 4 + 1) + (n * (128 + 4) if k > 1 else 0))


# theora_tpu_torch/tools/bench_idct.py
def k1_ops(entry: str, args) -> tuple[int, int]:
    """(int32, float32) operations K1 does on these arguments: the iDCT for
    each block (decode) or (row, block) pair (encode) that is not DC-only,
    the fill for the others; the encode entry adds each pair's
    reconstruction, SSD and cost and each block's lam_b product."""
    dc_only = args[6] if entry == "decode" else args[1]
    pairs = dc_only.numel()
    fills = int(dc_only.sum())
    ops = (pairs - fills) * IDCT_OPS + fills * FILL_OPS
    if entry == "decode":
        return ops, 0
    n = args[0].shape[1]
    return ops + pairs * RECON_OPS, pairs * COST_FLOPS + n


# theora_tpu_torch/tools/bench_idct.py
def k1_bound(entry: str, args) -> dict:
    """K1's least time for these arguments: k1_bytes over the memory rate,
    k1_ops over the int32 and float32 rates. The larger binds."""
    nbytes = k1_bytes(entry, args)
    iops, fops = k1_ops(entry, args)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = (iops / INT32_OPS_S + fops / FP32_OPS_S) * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "int32_ops": iops,
            "float32_ops": fops, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# theora_tpu_torch/tools/bench_qrd.py
# float32 operations per AC position of a (row, block) pair: the
# magnitude test (2 products, 2 differences, 2 squares, 2 fused
# multiply-adds of 2 each, 1 comparison), the gain (1 difference, 1
# square, 1 fused multiply-add of 2) and its 2 comparisons.
OPS_PER_POSITION = 18


# theora_tpu_torch/tools/bench_mc.py
# int32 operations per pixel: MC (the half-pel average, the select), the
# residual or the clamped sum, the SSD's square and sum.
OPS_PER_PIXEL = 6


# theora_tpu_torch/tools/bench_mc.py
def plane_shape(nv: int, nh: int, pad_y: int, pad_x: int) -> tuple:
    return 8 * nv + 2 * pad_y, 8 * nh + 2 * pad_x


# theora_tpu_torch/tools/bench_mc.py
def _refs(side) -> int:
    """Reference rows the data make MC read: one per block with rs != 0,
    a second where u2."""
    s = side.cpu().numpy()
    return int((s[0] != 0).sum() + ((s[0] != 0) & (s[5] != 0)).sum())


# theora_tpu_torch/tools/bench_mc.py
def ks_bound(entry: str, args) -> dict:
    """KS's least time for one call of `entry` with the wrapper's
    arguments, after the call (the skip entries' coded flags are read):
    the bytes it must move, each input read once and each output written
    once, over the memory rate, and OPS_PER_PIXEL int32 operations per
    pixel over the int32 rate. Data decide the bytes: a reference block is
    read only where rs != 0, a second one only there where u2; the skip
    test reads recon and q16 of a coded block, prev's block of a skipped
    one, and its decision inputs only on an inter step. Bytes bind. Copies
    the side rows and coded flags to the host."""
    if entry in ("mc_residual", "mc_recon"):
        refs = _refs(args[3])
        n = args[3].shape[1]
        if entry == "mc_residual":
            fid = args[8]
            nbytes = n * (6 + 64 + 64 + 256 + 128 + 4) + 64 * refs + (
                0 if fid is None else 4 * fid.numel())
        else:
            pic = args[9]
            nbytes = n * (6 + 128) + 64 * refs + args[0].numel() + (
                0 if pic is None else pic.numel())
    elif entry == "place_rows":
        rows = args[0]
        G, nv, nh, pad_y, pad_x = args[1:6]
        n = rows.shape[0]
        nbytes = n * (65 + 1) + G * np.prod(plane_shape(nv, nh, pad_y, pad_x))
    else:
        prev, intra, coded = args[0], args[8], args[10]
        n = coded.numel()
        nc = int(coded.sum())
        nbytes = nc * (64 + 128) + (n - nc) * 64 + n * (128 + 1) + (
            0 if intra else n * 13 + 4 * prev.shape[0])
        nbytes += prev.numel() if entry == "skip_place" else 65 * n
    ops = OPS_PER_PIXEL * 64 * n
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / INT32_OPS_S * 1e3
    return {"bytes": int(nbytes), "bytes_ms": bytes_ms, "ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# theora_tpu_torch/tools/bench_mc.py
def fused_bound(entry: str, args) -> dict:
    """The least time of one call of a fused entry with the wrapper's
    arguments, after the call (K1's coded flags are read), with
    mc_residual's and skip_place's counting rules (ks_bound): each input
    read once where the data need it (a reference row only for rs != 0, a
    second where u2; prev's uncoded block on an inter step), each output
    written once (qout, coded, qii and the plane or the rows); nothing
    in between (the prediction, the residual, the reconstruction) reaches
    memory. Operations: the kernel's own (bench_fdct.k2_ops, bench_qrd's
    R/D count, bench_idct.k1_ops) plus OPS_PER_PIXEL per pixel of MC, at
    the int32 and float32 rates. Entries: "mc_fdct_quantize",
    "mc_fdct_quantize_rd", "mc_idct_recon_skip"."""

    def nb(*ts):
        return sum(x.numel() * x.element_size() for x in ts
                   if isinstance(x, torch.Tensor))

    if entry == "mc_idct_recon_skip":
        (q16, dc_only, cnt, deq, inter, prev, gold, cur, side, ms, lam,
         lam_sc, intra, qout, coded, qii) = args[:16]
        fid = args[21] if len(args) > 21 else None
        k, n = q16.shape[:2]
        nbytes = (nb(q16, dc_only, cnt, deq, inter, cur, side, ms, lam,
                      lam_sc, fid, qout, coded, qii) + 64 * _refs(side)
                  + (0 if intra else 64 * n)
                  + (prev.numel() if fid is None else 65 * n))
        iops, fops = k1_ops("encode", (q16, dc_only, cnt, deq, inter, None,
                                       cur, lam, lam_sc))
        fops += 2 * n  # the skip test's product and conversion
    else:
        prev, gold, cur, side, deq, inter = args[:6]
        rd = entry == "mc_fdct_quantize_rd"
        fid = args[11 if rd else 10]
        n, k = cur.shape[0], deq.shape[-3]
        nbytes = (nb(cur, side, deq, inter, fid, *(args[6:7] if rd else ()))
                  + 64 * _refs(side)
                  + (k * n * (128 + 4 + 1) if rd else n * 128 * (1 + k)))
        iops = k2_ops(n, k)
        fops = k * n * (63 * OPS_PER_POSITION + 2) if rd else 0
    iops += OPS_PER_PIXEL * 64 * n
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = max(iops / INT32_OPS_S, (iops + fops) / FP32_OPS_S) * 1e3
    return {"bytes": int(nbytes), "bytes_ms": bytes_ms, "int32_ops": iops,
            "float32_ops": fops, "ops": iops + fops, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# theora_tpu_torch/tools/bench_me.py
# Absolute differences per macroblock and reference of one search (the
# plain version computes every cell of every grid, masked or not): the
# coarse 225 candidates x 64 pyramid pixels, the 25 full-pel cells x 256,
# the 9 half-pel positions x 256, the SAD at offset 0.
COARSE_AD, FULL_AD, HALF_AD, NOMV_AD = 225 * 64, 25 * 256, 9 * 256, 256


# theora_tpu_torch/tools/bench_me.py
# Against prev only: the 4MV refine (4 blocks x (25 full-pel + 9
# half-pel) x 64) and the 16 candidate SADs x 256.
BLOCK_FULL_AD, BLOCK_HALF_AD, CAND_AD = 4 * 25 * 64, 4 * 9 * 64, 16 * 256


# theora_tpu_torch/tools/bench_me.py
# Instructions, each counted at the int32 rate. Hopper's SIMD video
# instructions take the absolute difference of 4 packed bytes and add it
# to an accumulator in one (VABSDIFF4, __vsadu4), of 2 packed 16-bit
# pyramid values (at most 1,020 each) in one (__vsadu2). A two-tap
# prediction of 4 bytes costs one more, the truncating per-byte average
# (__vhaddu4). Each candidate's key is a multiply-add and a minimum (2).
# Should the SIMD forms issue slower than int32 adds, the card's least
# time lies above this bound, never below it.
AD_PER_OP, PYR_AD_PER_OP, HALF_OPS_PER_4, KEY_OPS = 4, 2, 2, 2


# theora_tpu_torch/tools/bench_me.py
KEYS_MB = 225 + 25 + 9           # keyed candidates per search


# theora_tpu_torch/tools/bench_me.py
KEYS_4MV = 4 * (25 + 9)


# theora_tpu_torch/tools/bench_me.py
def km_op_mix(rows: int, h: int, w: int) -> dict:
    """Instructions of the ME plan of `rows` rows of h x w luma by kind,
    byte SIMD counted as above: per macroblock two searches and, against
    prev, the 4MV refine, sad_intra (per 4 pixels a sum and a deviation
    from the block mean, one __vsadu4 each) and the candidate SADs; per
    row the 2x2 pyramids of cur and both references (3 adds per pyramid
    pixel), the histogram (1 per MB) and the top-16 selection (16 passes
    over 3,969 bins, 2 ops each). A two-tap group of 4 is one __vhaddu4
    and one __vsadu4 (HALF_OPS_PER_4)."""
    n = (h // 16) * (w // 16)

    def q(ad):
        return ad // AD_PER_OP

    per_mb = {
        "vsadu2": 2 * (COARSE_AD // PYR_AD_PER_OP),
        "vsadu4": (2 * (q(FULL_AD + NOMV_AD) + q(HALF_AD)) + q(BLOCK_FULL_AD)
                   + q(BLOCK_HALF_AD + CAND_AD) + 256 // 4 * 2),
        "vhaddu4": 2 * q(HALF_AD) + q(BLOCK_HALF_AD + CAND_AD),
        "int32": (2 * KEYS_MB + KEYS_4MV) * KEY_OPS,
    }
    mix = {k: rows * n * v for k, v in per_mb.items()}
    mix["int32"] += rows * (3 * (h * w // 4) * 3 + n + 16 * 63 * 63 * 2)
    return mix


# theora_tpu_torch/tools/bench_me.py
def km_ops(rows: int, h: int, w: int) -> int:
    """Instructions of the ME plan (km_op_mix), all at the int32 rate."""
    return sum(km_op_mix(rows, h, w).values())


# theora_tpu_torch/tools/bench_me.py
def km_bytes(frames: int, h: int, w: int) -> int:
    """Bytes the plan must move: the frames read once, gold_idx read once
    and the 11 int32 outputs written once (per row and MB: mv, gmv and
    2 x 4 bmv components, 6 SADs, 16 candidate SADs; per row 16 candidate
    vectors)."""
    rows, n = frames - 1, (h // 16) * (w // 16)
    return frames * h * w + 8 * rows + 4 * rows * (n * (4 + 8 + 6 + 16)
                                                   + 32)


# theora_tpu_torch/tools/bench_me.py
def km_bound(ys) -> dict:
    """KM's least time for the frames ys [F, H, W]: km_bytes over the
    memory rate, km_ops over the int32 rate. The larger binds. The work
    does not depend on the frames' content."""
    f, h, w = ys.shape
    nbytes, ops = km_bytes(f, h, w), km_ops(f - 1, h, w)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / INT32_OPS_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# theora_tpu_torch/tools/bench_loopfilter.py
# int32 operations per pixel line of a filtered edge: f = p0 - p3 +
# 3 (p2 - p1) (3), the response (+4, >> 3, |R|, L2 - |R|, min, max, the
# sign: 8), the two outputs with their clamps (6).
OPS_PER_LINE = 17


# theora_tpu_torch/tools/bench_loopfilter.py
def kl_edges(coded: np.ndarray) -> int:
    """Edges the filter applies for coded [..., nv, nh]: an h edge where
    either block beside it is coded, a v edge where either block above
    or below it is (libtheora filters each once)."""
    c = np.asarray(coded, bool)
    return int((c[..., :, 1:] | c[..., :, :-1]).sum()
               + (c[..., 1:, :] | c[..., :-1, :]).sum())


# theora_tpu_torch/tools/bench_loopfilter.py
def kl_bound(args) -> dict:
    """KL's least time for one call's arguments (plane, coded, limit, nv,
    nh, pad_y, pad_x), as the wrapper takes them: every plane read once
    and written once (the filter and the borders it fills: every byte of
    the padded plane, which is what the kernel moves), the coded flags and
    a limit tensor read once, over the memory rate; OPS_PER_LINE int32
    operations per pixel line of the edges this call's coded flags fire
    in the planes whose limit is above 0 (kl_edges), over the int32 rate.
    The larger binds: bytes at 720p; both lie well below one launch's
    latency, which is what holds the kernel (its source's note). Copies
    coded and a limit tensor to the host."""
    plane, coded, limit = args[:3]
    nbytes = 2 * plane.numel() + coded.numel()
    c = coded.cpu().numpy().reshape((-1,) + tuple(coded.shape[-2:]))
    if isinstance(limit, torch.Tensor):
        nbytes += 4 * limit.numel()
        live = limit.cpu().numpy().reshape(-1) > 0
    else:
        live = np.array([int(limit) > 0])
    ops = OPS_PER_LINE * 8 * kl_edges(c[live])
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / INT32_OPS_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
