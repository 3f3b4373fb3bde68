"""Kernel K2's inputs, bound and time on the card, beside an earlier build.

Usage: python -m theora_tpu_torch.tools.bench_fdct [--old-src PATH]
           [--parent-src PATH] [--warps W,...]

Times K2 (csrc/fdct_quant.cu) with CUDA events over 50 launches, L2
flushed before each, on 21,600 random residual blocks (the three planes of
a 1280x720 4:2:0 frame) at K = 1, 2 and 3 qi rows: the q56 inter triple
[56, 46, 63] of adaptive quantization, its first two rows, and q56 alone,
with the DC of every row at the base qi as the encoder builds them. For
each it prints the bound (bytes moved and int32 operations). With
--old-src, a fdct_quant.cu of the one-row interface (th_fdct_quant(res,
deq [2, 64], inter, qout, dout, n, stream)) is built beside it; its
outputs must equal the new kernel's at K = 1, and both are timed at K = 1
in turns, old, new, new, old. With --parent-src, a fdct_quant.cu of the
tree's interface (th_fdct_quant(res, deq [G, K, 2, 64], inter, qout,
dout, n, k, nseg, stream), e.g. a parent commit's, with the fdct_core.cuh
beside it if it includes one) is built beside it; its outputs must equal
the tree's at K = 1, 2 and 3, and both are timed at each K in turns,
parent, tree, tree, parent. With --warps, the tree's source is also built
with each of those warps per CTA (-DK2_WARPS=W; the tree's is 8) and
timed at K = 1 and 3 in turns with the tree's build. Needs a CUDA card.
Prints one JSON summary as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from theora_tpu_torch.tools.bench_trellis import HBM_BYTES_S, ITERS, event_ms

# int32 operations outside the tensor cores: half the 67 TFLOP/s float32
# rate (an SM has 64 INT32 lanes beside its 128 FP32 lanes).
INT32_OPS_S = 33.5e12
TRIPLE = (56, 46, 63)
SEED = 20261020


def k2_ops(n: int, k: int) -> int:
    """int32 operations of csrc/fdct_quant.cu for n blocks at k qi rows:
    per block 16 1-D fDCTs of 119 ops (8 input adds, 6 butterflies, 2 x 9
    for the t5/t6 rotations, 15 for y0/y4, 3 x 16 for y2/y6, y5/y3,
    y1/y7, 8 wraps of 3), 64 input x4 scalings and 64 output
    round/shift/wraps (5 ops); per value and qi row one quantization
    (abs, halved dequant, add, widening multiply, shift, sign: 6 ops)."""
    return n * (16 * 119 + 64 + 64 * 5 + k * 64 * 6)


def k2_bound(args) -> dict:
    """K2's least time for these arguments: the residuals, flags and
    dequant rows read once, the DCT and the K quantized rows written once,
    over the memory rate; k2_ops over the int32 rate. The larger binds."""
    res, deq, inter = args
    n, k = res.shape[0], deq.shape[-3]  # deq [K, 2, 64] or [G, K, 2, 64]
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + n * 128 * (1 + k))
    ops = k2_ops(n, k)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / INT32_OPS_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def triple_rows(qis, pli: int) -> np.ndarray:
    """[K, 2, 64] int16 dequant rows of plane pli at qis, every row's DC
    (slot 0) at qis[0], as encode/gop.py builds them."""
    from theora_tpu_torch import tables
    from theora_tpu_torch.quant import dequant_tables_init

    dq = dequant_tables_init(tables.DEF_QUANT_INFO)
    rows = dq[list(qis), pli].astype(np.int16)
    rows[:, :, 0] = rows[:1, :, 0]
    return rows


def random_residuals(rng, n: int) -> np.ndarray:
    """[n, 64] int16 residuals over [-255, 255] from noise to nearly flat
    blocks, with the int16-safe extremes (saturated flat, checkerboard and
    stripe blocks) first."""
    res = rng.integers(-255, 256, (n, 64)) // rng.integers(1, 40, (n, 1))
    ext = np.stack([
        np.full(64, 255), np.full(64, -255),
        np.where(np.indices((8, 8)).sum(0) % 2, 255, -255).reshape(64),
        np.where(np.arange(64) % 2, -255, 255),
        np.where(np.arange(64) // 8 % 2, -255, 255),
    ])
    res[:len(ext)] = ext
    return res.astype(np.int16)


def _old_kernel(src: str):
    """A launcher for the one-row K2 built from src: returns prepare(args)
    -> (launch, (qout, dout)) for K = 1 arguments of the new interface."""
    from theora_tpu_torch.ops.cuda_build import nvcc_build
    from theora_tpu_torch.ops.fdct_cuda import _SO

    so = nvcc_build(src, _SO.replace(".so", "_old.so"))
    lib = ctypes.CDLL(so)
    lib.th_fdct_quant.restype = ctypes.c_int
    lib.th_fdct_quant.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_void_p]

    def prepare(args):
        res, deq, inter = args
        n = res.shape[0]
        qout = torch.empty((n, 64), dtype=torch.int16, device=res.device)
        dout = torch.empty_like(qout)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = lib.th_fdct_quant(res.data_ptr(), deq.data_ptr(),
                                    inter.data_ptr(), qout.data_ptr(),
                                    dout.data_ptr(), n, stream)
            if err != 0:
                raise RuntimeError(f"old K2 launch failed: CUDA error {err}")

        return launch, (qout, dout)

    return so, prepare


def _build_kernel(src: str, tag: str, flags=()):
    """K2 built from src, a fdct_quant.cu of the tree's interface (with
    the fdct_core.cuh beside it, if any, as its header): returns
    launch(args) -> (qout, dout) for one-segment arguments, the wrapper's
    contract."""
    import os

    from theora_tpu_torch.ops.cuda_build import nvcc_build
    from theora_tpu_torch.ops.fdct_cuda import _SO

    core = os.path.join(os.path.dirname(os.path.abspath(src)),
                        "fdct_core.cuh")
    lib = ctypes.CDLL(nvcc_build(src, _SO.replace(".so", f"_{tag}.so"),
                                 tuple(flags),
                                 (core,) if os.path.exists(core) else ()))
    lib.th_fdct_quant.restype = ctypes.c_int
    lib.th_fdct_quant.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def launch(args):
        res, deq, inter = args
        n, k = res.shape[0], deq.shape[0]
        qout = torch.empty((k, n, 64), dtype=torch.int16, device=res.device)
        dout = torch.empty((n, 64), dtype=torch.int16, device=res.device)
        err = lib.th_fdct_quant(res.data_ptr(), deq.data_ptr(),
                                inter.data_ptr(), qout.data_ptr(),
                                dout.data_ptr(), n, k, 1,
                                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K2 ({tag}) launch failed: CUDA error {err}")
        return qout, dout

    return launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--old-src", default=None)
    ap.add_argument("--parent-src", default=None)
    ap.add_argument("--warps", default="",
                    help="comma-separated warps per CTA to build and time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fdct: needs a CUDA card", file=sys.stderr)
        return 2
    from theora_tpu_torch.ops import fdct_cuda, transforms

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    fdct_cuda.build()
    prepare = None
    if args.old_src:
        so, prepare = _old_kernel(args.old_src)
        print(f"[old] {args.old_src} -> {so}", flush=True)
    shapes = {int(w): _build_kernel(fdct_cuda._SRC, f"w{w}",
                                    (f"-DK2_WARPS={w}",))
              for w in args.warps.split(",") if w}
    parent = (_build_kernel(args.parent_src, "parent")
              if args.parent_src else None)
    rng = np.random.default_rng(SEED)
    n = 21600
    res = torch.from_numpy(random_residuals(rng, n)).to(dev)
    inter = torch.from_numpy(rng.integers(0, 2, n).astype(np.uint8)).to(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for k in (1, 2, 3):
        deq = torch.from_numpy(triple_rows(TRIPLE[:k], 0)).to(dev)
        kargs = (res, deq, inter)
        got = fdct_cuda.fdct_quantize(*kargs)
        want = transforms.fdct_quantize(*kargs)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K2 != plain at K = {k}")
        row = {"k": k, "blocks": n, "qis": list(TRIPLE[:k])}
        row.update(k2_bound(kargs))

        def new():
            fdct_cuda.fdct_quantize(*kargs)

        if prepare is None or k > 1:
            row["ms"] = [event_ms(new, ITERS, flush)]
        else:
            old, (oq, od) = prepare((res, deq[0], inter))
            old()
            torch.cuda.synchronize()
            if not (torch.equal(oq, got[0][0]) and torch.equal(od, got[1])):
                raise AssertionError("old K2 != new K2 at K = 1")
            for who, fn in (("old", old), ("new", new), ("new", new),
                            ("old", old)):
                row.setdefault(f"{who}_ms", []).append(
                    event_ms(fn, ITERS, flush))
            row["ms"] = row.pop("new_ms")
        if parent is not None:
            if not all(torch.equal(g, x)
                       for g, x in zip(parent(kargs), got)):
                raise AssertionError(f"K2 from {args.parent_src} != the "
                                     f"tree's at K = {k}")
            for who, fn in (("parent", lambda: parent(kargs)), ("new", new),
                            ("new", new), ("parent", lambda: parent(kargs))):
                row.setdefault(f"{who}_ms", []).append(
                    event_ms(fn, ITERS, flush))
            row["ms"] += row.pop("new_ms")
        for w, launch in shapes.items():
            if not all(torch.equal(g, x) for g, x in zip(launch(kargs), got)):
                raise AssertionError(f"K2 with {w} warps != the tree's")
            if k == 2:
                continue
            for who, fn in ((f"w{w}", lambda: launch(kargs)), ("new", new),
                            ("new", new), (f"w{w}", lambda: launch(kargs))):
                row.setdefault(f"{who}_ms", []).append(
                    event_ms(fn, ITERS, flush))
        print(f"[k2] K = {k}, {n} blocks, qis {row['qis']}: " + ", ".join(
            f"{key} {v}" for key, v in row.items() if key.endswith("ms"))
            + f"; bound by {row['bound_by']} ({row['bytes']} B) | {smi}",
            flush=True)
        rows.append(row)
    print(json.dumps({"card": smi, "iters": ITERS, "cases": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
