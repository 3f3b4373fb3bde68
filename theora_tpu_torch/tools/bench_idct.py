"""Kernel K1's inputs, bound and time on the card, beside an earlier build.

Usage: python -m theora_tpu_torch.tools.bench_idct [--old-src PATH] [--warps W,...]

Times K1 (csrc/idct.cu) with CUDA events over 50 launches, L2 flushed
before each:

- the decode entry (th_dequant_idct) on 172,800 random blocks (one launch
  of the 1280x720 decode: three planes of a batch of 8 frames) and on 3 x
  14,400 blocks as the encode scan launched it over K x N (row, block)
  pairs before it had an entry of its own;
- the encode entry (th_idct_recon_choose) at K = 3 and K = 1 over 14,400
  blocks (one 1280x720 luma plane), on kernel K2's and KT's outputs for
  random residuals at the q56 qi triple, beside the chain it replaced
  (`parent_chain`: the decode entry over K x N pairs, then the clamp, the
  SSD, `transforms.choose_rows` and the gathers as PyTorch ops).

With --old-src, an idct.cu of the one-entry interface (th_dequant_idct
only, as at commit bac324f) is built beside the tree's source; its outputs
must equal the tree's; both are timed in turns, old, new, new, old, and
the replaced chain runs on it. With --warps, the tree's source is also
built with each of those warps per CTA (-DK1_WARPS=W; the tree's is 8) and
timed in turns with the tree's build. Every case prints its bound
(`k1_bound`: the bytes the function must move and the operations it does
on these inputs). Needs a CUDA card. Prints one JSON summary as its last
line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from theora_tpu_torch.tools.bench_fdct import INT32_OPS_S
from theora_tpu_torch.tools.bench_trellis import FP32_OPS_S, HBM_BYTES_S, \
    ITERS, event_ms

SEED = 20261022
QIS = (56, 46, 63)  # adaptive quantization's q56 inter triple
# int32 operations of one block through dequant and both passes: 16 1-D
# iDCTs of 16 (c*x)>>16 products (2 ops), 12 wraps (3 ops) and 28 adds;
# 64 dequant products with a wrap (4 ops); 64 output round/shift/wraps
# (5 ops).
IDCT_OPS = 16 * (16 * 2 + 12 * 3 + 28) + 64 * 4 + 64 * 5
FILL_OPS = 6  # a DC-only block: product, bias, shift, wrap
# Per (row, block) of the encode entry: per pixel add, two clamps,
# subtract, square, sum (6 ops), the 8-lane sum (3 shuffles and adds), and
# the cost's integer part (multiply, add, compare).
RECON_OPS = 64 * 6 + 6 + 3
COST_FLOPS = 4  # 6 cnt, + 2, + 6, times lam_b (float32)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


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


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def decode_inputs(rng, n, nframes, device):
    """Random decode-entry inputs: coefficients over the whole int16 range
    (so the wraps are exercised), random DC, tables, flags."""
    return (
        _t(rng.integers(-32768, 32768, (n, 64), dtype=np.int16), device),
        _t(rng.integers(-32768, 32768, n, dtype=np.int16), device),
        _t(rng.integers(1, 32768, (nframes, 3, 2, 64), dtype=np.int16),
           device),
        _t(np.sort(rng.integers(0, nframes, n)).astype(np.int32), device),
        _t(rng.integers(0, 3, n).astype(np.uint8), device),
        _t(rng.integers(0, 2, n).astype(np.uint8), device),
        _t(rng.random(n) < 0.3, device),
    )


def encode_inputs(rng, n, device, k=1):
    """Decode-entry inputs as the encode scan built them for one plane of
    one frame at k qi rows: a [1, 3, 2, 64] table holding the k rows'
    intra and inter rows at qii 0..k-1, frame index 0, block r*n + i being
    row r of block i (qii r, block i's inter flag), DC from the
    coefficients."""
    coeffs = rng.integers(-32768, 32768, (k * n, 64), dtype=np.int16)
    deq_tab = np.zeros((1, 3, 2, 64), np.int16)
    deq_tab[0, :k] = rng.integers(1, 32768, (k, 2, 64), dtype=np.int16)
    return (
        _t(coeffs, device), _t(coeffs[:, 0], device), _t(deq_tab, device),
        _t(np.zeros(k * n, np.int32), device),
        _t(np.repeat(np.arange(k, dtype=np.uint8), n), device),
        _t(np.tile(rng.integers(0, 2, n).astype(np.uint8), k), device),
        _t(rng.random(k * n) < 0.3, device),
    )


def recon_args(arrays, device):
    """Encode-entry arguments on device from the numpy tuple the
    generators below return (lam a float32 scalar, lam_sc an array or
    None)."""
    q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc = arrays
    return tuple(_t(a, device) for a in (q16, dc_only, cnt, deq, inter,
                                         pred, cur)) + (
        torch.tensor(lam, dtype=torch.float32, device=device),
        None if lam_sc is None else _t(lam_sc, device))


def _recon_rest(rng, q16, deq, scales):
    """The encode-entry numpy tuple for values q16 [K, N, 64] and dequant
    rows deq: consistent counts and DC-only flags, a prediction over [0,
    255], a source within +-30 of it, random inter flags, lam in [20,
    400] and lam_sc in [0.1, 8] or None."""
    n = q16.shape[1]
    pred = rng.integers(0, 256, (n, 64)).astype(np.int32)
    cur = np.clip(pred + rng.integers(-30, 31, (n, 64)), 0, 255)
    return (q16, ~(q16[:, :, 1:] != 0).any(axis=2),
            (q16 != 0).sum(axis=2).astype(np.int32), deq,
            rng.integers(0, 2, n).astype(np.uint8), pred,
            cur.astype(np.uint8), np.float32(rng.uniform(20.0, 400.0)),
            rng.uniform(0.1, 8.0, n).astype(np.float32) if scales else None)


def recon_inputs(rng, n, k, scales=True, qis=QIS, pli=0):
    """Encode-entry inputs (numpy) for n random blocks at the first k of
    qis (plane pli's dequant rows, DC at the base qi): per (row, block) a
    density of small nonzero AC values from none to dense and a DC in
    [-100, 100]; the first blocks are the edge classes (an all-zero row, a
    DC-only row, two blocks of int16 extremes)."""
    from theora_tpu_torch.tools.bench_fdct import triple_rows

    density = rng.random((k, n, 1)) ** 3
    sign = rng.choice([-1, 1], (k, n, 64))
    q = np.where(rng.random((k, n, 64)) < density,
                 rng.geometric(0.5, (k, n, 64)) * sign, 0)
    q[:, :, 0] = rng.integers(-100, 101, (k, n))
    q[:, 0] = 0
    q[:, 1, 1:] = 0
    q[:, 2:4] = rng.choice([-32768, 32767], (k, 2, 64))
    return _recon_rest(rng, q.astype(np.int16), triple_rows(qis[:k], pli),
                       scales)


def tie_inputs(rng, n, scales=True):
    """Encode-entry inputs (numpy) at K = 3 on which rows tie in cost: the
    three rows share the base qi's dequant rows and block b copies values
    (with their flags and counts) between rows, so their SSDs are equal,
    and raises cnt[0] by one where rows 0 and 1 must tie (row 0 pays 6
    less): b % 3 == 0, all three rows equal, row 0 wins; 1, rows 1 and 2
    equal, row 1 wins over row 2; 2, rows 0 and 1 equal, row 0 wins over
    row 1. The counts of row 0 then differ from its values' own."""
    q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc = recon_inputs(
        rng, n, 3, scales, qis=(QIS[0],) * 3)
    kind = np.arange(n) % 3
    for dst, src, sel in ((1, 0, kind != 1), (2, 0, kind == 0),
                          (2, 1, kind == 1)):
        for a in (q16, dc_only, cnt):
            a[dst, sel] = a[src, sel]
    cnt[0, kind != 1] += 1
    return q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc


def ulp_inputs(rng, n):
    """Encode-entry inputs (numpy) at K = 2 whose choice hangs on one
    float32 rounding: both rows hold the same values (equal SSDs), cnt[0]
    = cnt[1] + 2, so row 0's lambda term is lam_b * (m1 + 6) against row
    1's lam_b * m1 (m1 = 6 cnt[1] + 8), and lam_b = lam * lam_sc < 1/6.
    lam_sc is picked per block among the float32 values next to t / (lam
    m1), t an integer, so that lam_b * m1 comes within one float32 ulp of
    t: computed at or above t, both terms truncate to t and row 0 wins the
    tie; one ulp below, row 1 wins."""
    q16, dc_only, cnt, deq, inter, pred, cur, _, _ = recon_inputs(
        rng, n, 2, False, qis=(QIS[0],) * 2)
    q16[1], dc_only[1], cnt[1] = q16[0], dc_only[0], cnt[0]
    cnt[0] = cnt[1] + 2
    f32 = np.float32
    lam = f32(0.1)
    m1 = f32(6.0) * cnt[1].astype(f32) + f32(2.0) + f32(6.0)
    t = 1 + np.floor(rng.random(n) * (np.ceil(m1 / 6.0) - 1))
    base = (t / (np.float64(lam) * m1)).astype(f32)
    sc = [base]
    for toward in (f32(np.inf), f32(-np.inf)):
        s = base
        for _ in range(3):
            s = np.nextafter(s, toward)
            sc.append(s)
    sc = np.stack(sc)
    prod = (lam * sc).astype(f32) * m1
    near = np.abs(prod.astype(np.float64) - t) <= np.spacing(t.astype(f32))
    pick = np.argmax(near * rng.random(sc.shape), axis=0)
    return (q16, dc_only, cnt, deq, inter, pred, cur, lam,
            sc[pick, np.arange(n)])


def kernel_chain_inputs(rng, n, k, device, scales):
    """Encode-entry arguments (on device) as the encode scan makes them at
    the first k rows of the q56 triple, from random residuals (the
    generator of tools/bench_fdct.py) over a random prediction: kernel K2,
    then kernel KT with the inter lambdas (and lambda scales in [0.1, 8]
    when scales), and the chooser's lambda at q56."""
    from theora_tpu_torch.ops import fdct_cuda, trellis_cuda
    from theora_tpu_torch.ops.transforms import rd_lambda
    from theora_tpu_torch.tools.bench_fdct import random_residuals, \
        triple_rows
    from theora_tpu_torch.tools.bench_trellis import kt_tables

    dq, nb, lam_tab = kt_tables()
    qis = list(QIS[:k])
    pred = rng.integers(0, 256, (n, 64)).astype(np.int32)
    cur = np.clip(pred + random_residuals(rng, n), 0, 255)
    inter = _t(rng.integers(0, 2, n).astype(np.uint8), device)
    deq = _t(triple_rows(qis, 0), device)
    q, d = fdct_cuda.fdct_quantize(_t((cur - pred).astype(np.int16), device),
                                   deq, inter)
    sc = (_t(rng.uniform(0.1, 8.0, n).astype(np.float32), device) if scales
          else None)
    q16, cnt, dc_only = trellis_cuda.trellis_quantize(
        q, d, deq, inter, _t(lam_tab[1, qis], device), _t(nb, device), sc)
    lam = np.float32(rd_lambda(QIS[0], int(dq[QIS[0], 0, 1, 1])) * 3.0 * 4.0)
    return (q16, dc_only, cnt, deq, inter, _t(pred, device),
            _t(cur.astype(np.uint8), device),
            torch.tensor(lam, dtype=torch.float32, device=device), sc)


def parent_chain(k1, args):
    """The encode scan's step after the trellis as it ran before K1 had
    an encode entry: k1 (a function of the decode entry's contract, such
    as idct_cuda.dequantize_idct_frames) over the K x N (row, block)
    pairs, then the clamp, the int32 SSD, transforms.choose_rows and the
    gathers as PyTorch ops. The per-plane invariants are built here, as
    the scan built them once per plane; returns run() -> (recon [N, 64]
    int32, ssd, qii, q, cnt)."""
    from theora_tpu_torch.ops.transforms import choose_rows

    q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc = args
    K, n = q16.shape[0], q16.shape[1]
    dev = q16.device
    deq_tab = torch.zeros((1, 3, 2, 64), dtype=torch.int16, device=dev)
    deq_tab[0, :K] = deq
    zeros_i32 = torch.zeros(K * n, dtype=torch.int32, device=dev)
    row_of = torch.arange(K, dtype=torch.uint8, device=dev).repeat_interleave(
        n)
    blk = torch.arange(n, device=dev)
    curi = cur.to(torch.int32)
    qii0 = torch.zeros(n, dtype=torch.uint8, device=dev)

    def run():
        flat = q16.reshape(K * n, 64)
        residual = k1(flat, flat[:, 0].contiguous(), deq_tab, zeros_i32,
                      row_of, inter if K == 1 else inter.repeat(K),
                      dc_only.reshape(K * n))
        recon = torch.clamp(
            residual.to(torch.int32).reshape(K, n, 64) + pred, 0, 255)
        dr = recon - curi
        ssd = (dr * dr).sum(dim=2, dtype=torch.int32)
        if K == 1:
            return recon[0], ssd[0], qii0, q16[0], cnt[0]
        qii = choose_rows(ssd, cnt, lam, lam_sc)
        sel = qii.long()
        return (recon[sel, blk], ssd[sel, blk], qii, q16[sel, blk],
                cnt[sel, blk])

    return run


def same_outputs(got, want) -> bool:
    """Encode-entry outputs equal, recon compared as uint8."""
    return all(torch.equal(g.to(w.dtype) if i == 0 else g, w)
               for i, (g, w) in enumerate(zip(got, want)))


def _build(src: str, tag: str, flags=()):
    """A K1 library built from src into csrc/build/ under tag."""
    from theora_tpu_torch.ops import idct_cuda
    from theora_tpu_torch.ops.cuda_build import nvcc_build

    return ctypes.CDLL(nvcc_build(src, idct_cuda._SO.replace(
        ".so", f"_{tag}.so"), flags))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--old-src", default=None)
    ap.add_argument("--warps", default="",
                    help="comma-separated warps per CTA to build and time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_idct: needs a CUDA card", file=sys.stderr)
        return 2
    from theora_tpu_torch.ops import idct_cuda, transforms

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    idct_cuda.build()
    old = None
    if args.old_src:
        # The one-entry source was built without extra flags.
        old = idct_cuda.bind(_build(args.old_src, "old"), recon=False)
        print(f"[old] {args.old_src}", flush=True)
    shapes = {int(w): idct_cuda.bind(_build(
        idct_cuda._SRC, f"w{w}", idct_cuda.NVCC_FLAGS + (f"-DK1_WARPS={w}",)))
        for w in args.warps.split(",") if w}
    rng = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def turns(row, a, b):
        """Time two launchers in turns a, b, b, a into row."""
        for (who, fn) in (a, b, b, a):
            row.setdefault(f"{who}_ms", []).append(event_ms(fn, ITERS, flush))

    rows = []
    for what, dargs in (
            ("decode entry, 172800 blocks", decode_inputs(rng, 172800, 8,
                                                          dev)),
            ("decode entry, 3 x 14400 blocks (encode rows)",
             encode_inputs(rng, 14400, dev, 3))):
        got = idct_cuda.dequantize_idct_frames(*dargs)
        if not torch.equal(got, transforms.dequantize_idct_frames(*dargs)):
            raise AssertionError(f"K1 != plain on {what}")
        row = {"case": what, "entry": "decode"}
        row.update(k1_bound("decode", dargs))

        def new(dargs=dargs):
            idct_cuda.dequantize_idct_frames(*dargs)

        if old is None:
            row["new_ms"] = [event_ms(new, ITERS, flush)]
        else:
            if not torch.equal(idct_cuda.launch_dequant_idct(old, *dargs),
                               got):
                raise AssertionError(f"old K1 != new K1 on {what}")
            turns(row, ("old", lambda dargs=dargs: idct_cuda.
                        launch_dequant_idct(old, *dargs)), ("new", new))
        for w, lib in shapes.items():
            if not torch.equal(idct_cuda.launch_dequant_idct(lib, *dargs),
                               got):
                raise AssertionError(f"K1 with {w} warps != the tree's")
            turns(row, (f"w{w}", lambda dargs=dargs, lib=lib: idct_cuda.
                        launch_dequant_idct(lib, *dargs)), ("new", new))
        rows.append(row)

    for k, scales in ((3, True), (1, False)):
        eargs = kernel_chain_inputs(rng, 14400, k, dev, scales)
        got = idct_cuda.idct_recon_choose(*eargs)
        if not same_outputs(got, transforms.idct_recon_choose(*eargs)):
            raise AssertionError(f"K1 encode entry != plain at K = {k}")
        chain_k1 = idct_cuda.dequantize_idct_frames if old is None else (
            lambda *a: idct_cuda.launch_dequant_idct(old, *a))
        chain = parent_chain(chain_k1, eargs)
        if not same_outputs(chain(), got):
            raise AssertionError(f"replaced chain != K1 encode entry at "
                                 f"K = {k}")
        row = {"case": f"encode entry, K = {k}, 14400 blocks"
                       + (", lambda scales" if scales else ""),
               "entry": "encode", "k": k,
               "chain_k1": "old" if old is not None else "new",
               "dc_only_share": float(eargs[1].float().mean())}
        row.update(k1_bound("encode", eargs))
        turns(row, ("chain", chain),
              ("new", lambda eargs=eargs: idct_cuda.idct_recon_choose(
                  *eargs)))
        for w, lib in shapes.items():
            if not same_outputs(idct_cuda.launch_recon_choose(lib, *eargs),
                                got):
                raise AssertionError(f"K1 with {w} warps != the tree's")
            turns(row, (f"w{w}", lambda eargs=eargs, lib=lib: idct_cuda.
                        launch_recon_choose(lib, *eargs)),
                  ("new", lambda eargs=eargs: idct_cuda.idct_recon_choose(
                      *eargs)))
        rows.append(row)

    for row in rows:
        print(f"[k1] {row['case']}: " + ", ".join(
            f"{key} {v}" for key, v in row.items() if key.endswith("_ms")
            and isinstance(v, list)) + f"; bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']} ({row['bytes']} B) | {smi}", flush=True)
    print(json.dumps({"card": smi, "iters": ITERS, "cases": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
