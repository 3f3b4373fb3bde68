"""Kernel KR's inputs, bound and time on the card, beside kernel KT and
beside the K2 -> KR chain its fused entry replaces.

Usage: python -m theora_tpu_torch.tools.bench_qrd

Times with CUDA events over 50 launches, L2 flushed before each. KR's
standalone entry (qrd_cuda.quantize_rd) on K2's outputs for random
residuals at K = 1 and 3 qi rows over 14,400 blocks (a 1280x720 luma
plane) and at K = 1 over 3,600 (a chroma plane), inter flags at random
(each block takes its own row's intra or inter lambda), beside its bound
(kr_bound), the plain version (transforms.quantize_rd_rows), a device copy
of the same bytes, and kernel KT (the trellis, which KR replaces at speed
levels 2-4) on the same K2 outputs with the trellis' lambdas. Then KR's
fused entry (qrd_cuda.fdct_quantize_rd, the encode scan's) on the
residuals themselves at 14,400 blocks, K = 1 and 3, and over 3 segments
of 14,400 blocks at K = 3 (tools/bench_segments.py:segment_case, the
mesh's shape): the fused entry, the chain it replaced (K2, then the
standalone entry) and K2 alone timed in turns (chain, fused, K2, K2,
fused, chain), beside the fused entry's bound (kr_fused_bound) and the
plain version (transforms.fdct_quantize_rd). Every kernel must equal its
plain version first, and the fused entry the chain. First it prints
each kernel's instructions in KR's and K2's libraries by kind
(sass_counts: cuobjdump -sass of the build, static counts). Needs a CUDA
card. Prints one JSON summary as its last line.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from theora_tpu_torch.tools.bench_fdct import INT32_OPS_S, k2_ops
from theora_tpu_torch.tools.bench_trellis import HBM_BYTES_S, FP32_OPS_S, \
    event_ms, kt_tables

SEED = 20261022
ITERS = 50  # timed launches per reading
RD_STRENGTH = 3.0  # GopEncoder's default
# Instruction kinds sass_counts reports: integer arithmetic, logic,
# compare, select and byte permutes (IMAD aside), float32 arithmetic, and
# conversions.
INT_OPS = ("ISETP", "LOP3", "SEL", "SHF", "PRMT", "LEA", "IADD3", "VIADD",
           "IABS", "VIMNMX", "FSETP", "FSEL", "FMNMX")
FLOAT_OPS = ("FMUL", "FADD", "FFMA")
CONVERSIONS = ("I2F", "I2FP", "F2I")
# float32 operations per AC position of a (row, block) pair: the
# magnitude test (2 products, 2 differences, 2 squares, 2 fused
# multiply-adds of 2 each, 1 comparison), the gain (1 difference, 1
# square, 1 fused multiply-add of 2) and its 2 comparisons.
OPS_PER_POSITION = 18


def qi_lists() -> dict:
    """{K: qi list}: the encoder's base qi at one row and adaptive
    quantization's real lists at two and three (the q63 pair, the q56
    inter triple)."""
    from theora_tpu_torch.encode import aq

    return {1: [48], 2: aq.qi_triple(True, 63, 1, 0),
            3: aq.qi_triple("auto", 56, 1, 0)}


def lam_q_rows(qis, pli: int) -> np.ndarray:
    """[K, 2] float32: per qi row the R/D quantizer's intra and inter
    lambda of plane pli, as encode/gop.py computes them."""
    from theora_tpu_torch.ops.transforms import rd_lambda

    dq = kt_tables()[0]
    return np.array([[rd_lambda(q, int(dq[q, pli, t, 1])) * RD_STRENGTH
                      for t in (0, 1)] for q in qis], np.float32)


def fused_args(rng, n: int, qis, pli: int, device):
    """Arguments of KR's fused entry (res, deq, inter, lam_q) for [n]
    blocks of random residuals (bench_fdct.random_residuals) at the qi rows
    qis of plane pli, inter flags at random."""
    from theora_tpu_torch.tools import bench_fdct as bf

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    res = bf.random_residuals(rng, n)
    deq = t(bf.triple_rows(qis, pli))
    inter = t(rng.integers(0, 2, n).astype(np.uint8))
    return (t(res), deq, inter, t(lam_q_rows(qis, pli)))


def kr_args(rng, n: int, qis, pli: int, device):
    """Arguments of KR's standalone entry for K2's outputs on
    fused_args(rng, n, qis, pli, device)."""
    from theora_tpu_torch.ops import fdct_cuda

    res, deq, inter, lam_q = fused_args(rng, n, qis, pli, device)
    q, d = fdct_cuda.fdct_quantize(res, deq, inter)
    return (q, d, deq, inter, lam_q)


def chain(res, deq, inter, lam_q):
    """The launches the fused entry replaced: K2, then KR's standalone
    entry on K2's outputs."""
    from theora_tpu_torch.ops import fdct_cuda, qrd_cuda

    q, d = fdct_cuda.fdct_quantize(res, deq, inter)
    return qrd_cuda.quantize_rd(q, d, deq, inter, lam_q)


def kr_cases(device, sizes=((14400, 0), (3600, 1), (21600, 2)),
             fused: bool = False):
    """(label, KR arguments): K2's outputs on random residuals at K = 1, 2
    and 3 real qi lists, per (blocks, plane) in sizes, intra and inter
    blocks mixed; with `fused`, the fused entry's arguments (the
    residuals themselves)."""
    rng = np.random.default_rng(SEED)
    for n, pli in sizes:
        for k, qis in qi_lists().items():
            what = "residuals" if fused else "K2 outputs"
            yield (f"{what}, {k} x {n} blocks, plane {pli}, qis {qis}",
                   (fused_args if fused else kr_args)(rng, n, qis, pli,
                                                      device))


def edge_args(device):
    """KR arguments for the edge classes among 2,000 blocks at q40,
    intra and inter blocks mixed: a lone +-1 at position 1 and at position
    63, +-1 pairs, blocks without a nonzero AC value, +-32767 everywhere,
    and between them fDCTs of random residuals. The round-to-nearest
    values come from the plain quantizer, as K2 makes them."""
    from theora_tpu_torch.ops import transforms
    from theora_tpu_torch.tools import bench_fdct as bf

    rng = np.random.default_rng(SEED + 1)
    qi, n = 40, 2000
    rows = bf.triple_rows([qi], 0)
    inter = rng.integers(0, 2, n).astype(np.uint8)
    res = rng.integers(-255, 256, (n, 8, 8)) // rng.integers(1, 40,
                                                             (n, 1, 1))
    dct = transforms.fdct8x8(torch.from_numpy(res.astype(np.int32))).numpy()
    d = rows[0][inter.astype(np.int64)].astype(np.int32)
    sign = rng.choice([-1, 1], (n, 64))
    k = np.arange(0, 600, 6)
    for j, pos in enumerate((1, 63)):
        # Magnitudes from d / 2 to d: round-to-nearest 1, some killed.
        dct[k + j, 1:] = 0
        dct[k + j, pos] = sign[k + j, pos] * (
            d[k + j, pos] // 2 + 1 + (k % 5) * (d[k + j, pos] // 8))
    dct[k + 2, 1:] = 0
    p = 1 + k % 61
    dct[k + 2, p] = sign[k + 2, p] * d[k + 2, p]
    dct[k + 2, p + 1] = sign[k + 2, p + 1] * d[k + 2, p + 1]
    dct[k + 3, 1:] = rng.integers(-3, 4, (len(k), 63))  # no AC value
    dct[k + 4] = sign[k + 4] * 32767
    dct[k + 5, 1:] = 0
    dct[k + 5, 1::2] = sign[k + 5, 1::2] * d[k + 5, 1::2]
    dct = np.clip(dct, -32768, 32767)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    q0 = transforms.quantize(torch.from_numpy(dct), torch.from_numpy(d))
    return (t(q0.numpy().astype(np.int16)[None]), t(dct.astype(np.int16)),
            t(rows), t(inter), t(lam_q_rows([qi], 0)))


def fma_args(path: str, device):
    """KR arguments for each block of qrd_fma_cases.npz, one launch each:
    the block's dequant row as both rows, its lambda for both."""
    from theora_tpu_torch.ops import transforms

    cases = np.load(path)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for dct, row, lam in zip(cases["dct"], cases["deq"], cases["lam"]):
        q0 = transforms.quantize(torch.from_numpy(dct[None].astype(np.int32)),
                                 torch.from_numpy(row[None].astype(np.int32)))
        yield (t(q0.numpy().astype(np.int16)[None]), t(dct[None]),
               t(np.stack([row, row])[None]),
               torch.zeros(1, dtype=torch.uint8, device=device),
               t(np.full((1, 2), lam, np.float32)))


def kr_bound(args) -> dict:
    """KR's least time for these arguments: each input read once (the [K,
    N, 64] and [N, 64] int16 rows, the [N] flags, the dequant rows and
    the 2K lambdas), each output written once ([K, N, 64] int16, [K, N]
    int32 and bool), over the memory rate; its float32 operations
    (OPS_PER_POSITION per AC position of a pair, 2 products of the
    lambda per pair) over the float32 rate. The larger binds."""
    qout, dout, deq, inter, lam_q = args
    k, n = qout.shape[:2]
    nbytes = (k * n * 64 * 2 + n * 64 * 2 + n + deq.numel() * 2
              + lam_q.numel() * 4 + k * n * 64 * 2 + 5 * k * n)
    ops = k * n * (63 * OPS_PER_POSITION + 2)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / FP32_OPS_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def kr_fused_bound(args) -> dict:
    """The fused entry's least time for its arguments (res, deq, inter,
    lam_q): the residuals, flags, dequant rows and lambdas read once, the
    [K, N, 64] int16 values, [K, N] int32 counts and bool flags written
    once (129 + K x 133 B per block), over the memory rate; its
    operations, K2's int32 count (bench_fdct.k2_ops) and KR's float32 one
    (OPS_PER_POSITION per AC position of a pair, 2 products of the lambda
    per pair), over the rates: the int32 work at the int32 rate, and all
    of it at the float32 rate, the issue rate the two kinds share. The
    larger binds."""
    res, deq, inter, lam_q = args
    n, k = res.shape[0], deq.shape[-3]
    nbytes = (n * 128 + n + deq.numel() * 2 + lam_q.numel() * 4
              + k * n * (128 + 4 + 1))
    int_ops = k2_ops(n, k)
    fp_ops = k * n * (63 * OPS_PER_POSITION + 2)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = max(int_ops / INT32_OPS_S, (int_ops + fp_ops) / FP32_OPS_S) * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "int32_ops": int_ops,
            "float32_ops": fp_ops, "ops": int_ops + fp_ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def check_fused(args) -> tuple:
    """The fused entry on args against its plain version and the chain
    it replaced, every output exactly; returns the fused outputs."""
    from theora_tpu_torch.ops import qrd_cuda, transforms

    got = qrd_cuda.fdct_quantize_rd(*args)
    for what, want in (("plain", transforms.fdct_quantize_rd(*args)),
                       ("the K2 -> KR chain", chain(*args))):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                bad = int((g != w).reshape(len(g), -1).any(dim=1).sum())
                raise AssertionError(f"KR's fused entry != {what}: {bad} "
                                     f"rows differ")
    return got


def time_fused(args, flush) -> dict:
    """The fused entry on args (checked first) beside the chain it
    replaced and K2 alone, in turns (chain, fused, K2, K2, fused, chain),
    each reading a CUDA-event mean over ITERS; the plain version over 5;
    and kr_fused_bound."""
    from theora_tpu_torch.ops import fdct_cuda, qrd_cuda, transforms

    check_fused(args)
    fns = {"chain": lambda: chain(*args),
           "fused": lambda: qrd_cuda.fdct_quantize_rd(*args),
           "k2": lambda: fdct_cuda.fdct_quantize(*args[:3])}
    out = {"rows": int(args[1].shape[-3]), "blocks": int(args[0].shape[0]),
           "segments": int(args[1].shape[0]) if args[1].dim() == 4 else 1}
    for who in ("chain", "fused", "k2", "k2", "fused", "chain"):
        out.setdefault(f"{who}_ms", []).append(
            event_ms(fns[who], ITERS, flush))
    out["plain_ms"] = event_ms(lambda: transforms.fdct_quantize_rd(*args),
                               5, flush)
    out.update(kr_fused_bound(args))
    return out


def fused_shapes(device):
    """(label, fused-entry arguments) of the three timed shapes: 14,400
    blocks at K = 1 and 3, and 3 segments of 14,400 blocks at K = 3 (the
    mesh's shape, bench_segments.segment_case)."""
    from theora_tpu_torch.tools import bench_segments as bs

    rng = np.random.default_rng(SEED + 2)
    for k in (1, 3):
        yield (f"14400 blocks, K = {k}",
               fused_args(rng, 14400, qi_lists()[k], 0, device))
    c = bs.segment_case(np.random.default_rng(bs.SEED), 14400, 3, device)
    yield ("3 segments x 14400 blocks, K = 3",
           (c["res"], c["deq"], c["inter"], c["lam_q"]))


def time_case(args, qis, flush) -> dict:
    """KR's time on args (at the qi rows qis) beside its bound, its plain
    version, a device copy of the same bytes and KT on the same K2 outputs
    (the trellis' inter lambda of each row's qi). Both kernels are checked
    against their plain versions first."""
    from theora_tpu_torch.ops import qrd_cuda, transforms, trellis_cuda

    qout, dout, deq, inter, lam_q = args
    _, nb, lam_tab = kt_tables()
    kt_args = (qout, dout, deq, inter,
               torch.from_numpy(lam_tab[1, qis]).to(qout.device),
               torch.from_numpy(nb).to(qout.device), None)
    for fn, plain, a in ((qrd_cuda.quantize_rd, transforms.quantize_rd_rows,
                          args),
                         (trellis_cuda.trellis_quantize,
                          transforms.trellis_quantize, kt_args)):
        got, want = fn(*a), plain(*a)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{fn.__name__} != plain")
    b = kr_bound(args)
    src = torch.empty(b["bytes"] // 2, dtype=torch.uint8, device=qout.device)
    dst = torch.empty_like(src)
    return {
        "rows": int(qout.shape[0]), "blocks": int(qout.shape[1]),
        "ms": event_ms(lambda: qrd_cuda.quantize_rd(*args), ITERS, flush),
        "plain_ms": event_ms(lambda: transforms.quantize_rd_rows(*args), 5,
                             flush),
        "copy_ms": event_ms(lambda: dst.copy_(src), ITERS, flush),
        "kt_ms": event_ms(lambda: trellis_cuda.trellis_quantize(*kt_args),
                          ITERS, flush),
        **b,
    }


def sass_counts(so: str) -> dict:
    """{kernel: {"total", "int", "float", "conversions", "imad",
    "shuffles": static instruction counts}} of a kernel library, from
    cuobjdump -sass (the CUDA toolkit's, beside nvcc)."""
    import collections
    import os
    import re

    from theora_tpu_torch.ops.cuda_build import _nvcc

    sass = subprocess.run(
        [os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass", so],
        capture_output=True, text=True, check=True, timeout=120).stdout
    out = {}
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        ops = collections.Counter(op.split(".")[0] for op in re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn))
        out[name] = {
            "total": sum(ops.values()),
            "int": sum(ops[k] for k in INT_OPS),
            "float": sum(ops[k] for k in FLOAT_OPS),
            "conversions": sum(ops[k] for k in CONVERSIONS),
            "imad": ops["IMAD"], "shuffles": ops["SHFL"]}
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_qrd: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from theora_tpu_torch.ops import fdct_cuda, qrd_cuda

    sass = {}
    for so in (qrd_cuda.build(), fdct_cuda.build()):
        for name, c in sass_counts(so).items():
            print(f"[sass] {name}: {c}", flush=True)
            sass[name] = c
    rng = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for n, pli, k in ((14400, 0, 1), (14400, 0, 3), (3600, 1, 1)):
        qis = qi_lists()[k]
        row = time_case(kr_args(rng, n, qis, pli, dev), qis, flush)
        print(f"[kr] K = {k}, {n} blocks: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, KT {row['kt_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}; copy of the "
              f"same bytes {row['copy_ms']:.4f} ms | {smi}", flush=True)
        rows.append(row)
    fused = []
    for label, args in fused_shapes(dev):
        row = time_fused(args, flush)
        print(f"[kr fused] {label}: fused "
              f"{' / '.join(f'{x:.4f}' for x in row['fused_ms'])} ms, K2 -> "
              f"KR chain {' / '.join(f'{x:.4f}' for x in row['chain_ms'])} "
              f"ms, K2 alone {' / '.join(f'{x:.4f}' for x in row['k2_ms'])} "
              f"ms, plain {row['plain_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['bytes']} B); fused == plain == chain | {smi}",
              flush=True)
        fused.append(dict(row, shape=label))
    print(json.dumps({"card": smi, "iters": ITERS, "cases": rows,
                      "fused": fused, "sass": sass}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
