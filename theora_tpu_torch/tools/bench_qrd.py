"""Kernel KR's inputs, bound and time on the card, beside kernel KT.

Usage: python -m theora_tpu_torch.tools.bench_qrd

Times KR (csrc/quantize_rd.cu) with CUDA events over 50 launches, L2
flushed before each, on K2's outputs for random residuals at K = 1 and 3
qi rows over 14,400 blocks (a 1280x720 luma plane) and at K = 1 over
3,600 (a chroma plane), inter flags at random (each block takes its own
row's intra or inter lambda). Beside each: its bound (kr_bound), the
plain version (transforms.quantize_rd_rows), a device copy of the same
bytes, and kernel KT (the trellis, which KR replaces at speed levels 2-4)
on the same K2 outputs with the trellis' lambdas. Both kernels must equal
their plain versions first. Needs a CUDA card. Prints one JSON summary as
its last line.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from theora_tpu_torch.tools.bench_trellis import HBM_BYTES_S, FP32_OPS_S, \
    event_ms, kt_tables

SEED = 20261022
ITERS = 50  # timed launches per reading
RD_STRENGTH = 3.0  # GopEncoder's default
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


def kr_args(rng, n: int, qis, pli: int, device):
    """KR arguments for K2's outputs on [n] blocks of random residuals
    (bench_fdct.random_residuals) at the qi rows qis of plane pli, inter
    flags at random."""
    from theora_tpu_torch.ops import fdct_cuda
    from theora_tpu_torch.tools import bench_fdct as bf

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    res = bf.random_residuals(rng, n)
    deq = t(bf.triple_rows(qis, pli))
    inter = t(rng.integers(0, 2, n).astype(np.uint8))
    q, d = fdct_cuda.fdct_quantize(t(res), deq, inter)
    return (q, d, deq, inter, t(lam_q_rows(qis, pli)))


def kr_cases(device, sizes=((14400, 0), (3600, 1), (21600, 2))):
    """(label, KR arguments): K2's outputs on random residuals at K = 1, 2
    and 3 real qi lists, per (blocks, plane) in sizes, intra and inter
    blocks mixed."""
    rng = np.random.default_rng(SEED)
    for n, pli in sizes:
        for k, qis in qi_lists().items():
            yield (f"K2 outputs, {k} x {n} blocks, plane {pli}, qis {qis}",
                   kr_args(rng, n, qis, pli, device))


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


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_qrd: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
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
    print(json.dumps({"card": smi, "iters": ITERS, "cases": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
