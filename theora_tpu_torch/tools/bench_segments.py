"""Kernels K2, KT, KR and K1's encode entry over G segments, against G
launches of one segment each.

Usage: python -m theora_tpu_torch.tools.bench_segments [--blocks N]
           [--segments G] [--old-src DIR]

The mesh encoder (parallel/gop.py) runs G GOPs side by side, so each
encode-side kernel takes a segment axis: N = G n blocks of one plane at
one frame step, segment g's blocks quantized with its own K qi rows and
lambdas (deq [G, K, 2, 64], KT's lam [G, K], KR's lam_q [G, K, 2], K1's
lam [G]). On the card, with n blocks per segment (14,400 by default, a
1280x720 luma plane) and G segments (3), each with its own qi triple,
lambdas and per-block lambda scales: the chain K2 -> KT -> K1 and K2 -> KR
as one launch of each kernel over the G segments must equal the plain
versions on the same inputs and the chain run as G launches of one
segment each, exactly, and each kernel's one launch
is timed (CUDA events over 50 launches, L2 flushed before each) beside
its G launches. With --old-src, a directory holding the parent's
fdct_quant.cu, trellis.cu, quantize_rd.cu and idct.cu (the interfaces
without the segment axis), each kernel at G = 1 must equal the parent's
build of it and is timed beside it on the same inputs, in turns (old,
new, new, old). Needs a CUDA card; prints one JSON summary as its last
line.

segment_case(), run_chain() and run_separately() build and run the same
chain on CPU tensors, where every wrapper runs its plain version
(tests/test_torch_mesh.py); chip_smoke.py runs them on the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

SEED = 20261017
ITERS = 50  # timed launches per reading
RD_STRENGTH = 3.0  # GopEncoder's default
# A distinct qi triple per segment (base, coarser, finer), DC at the base.
QIS = ((56, 46, 63), (50, 41, 59), (44, 36, 52), (60, 52, 63))
# The block axis of each output of each kernel: [K, N, ...] outputs on
# dim 1, [N, ...] ones on dim 0.
BLOCK_DIMS = {"K2": (1, 0), "KT": (1, 1, 1), "KR": (1, 1, 1),
              "K1": (0, 0, 0, 0, 0)}


def segment_case(rng, n: int, nseg: int, device, scales: bool = True,
                 inter_frame: bool = True, pli: int = 0) -> dict:
    """The inputs of the chain over nseg segments of n blocks: random
    residuals (bench_fdct.random_residuals), inter flags at random on an
    inter frame, predictions and sources; segment g at qi triple
    QIS[g % 4] with its plane's dequant rows, trellis and R/D lambdas and
    the chooser's lambda; with `scales`, per-block lambda scales in
    [0.1, 8]."""
    from theora_tpu_torch.ops.transforms import rd_lambda
    from theora_tpu_torch.tools import bench_fdct as bf
    from theora_tpu_torch.tools.bench_qrd import lam_q_rows
    from theora_tpu_torch.tools.bench_trellis import kt_tables

    dq, nb, rdl = kt_tables()
    qis = [QIS[g % len(QIS)] for g in range(nseg)]
    N = nseg * n
    pred = rng.integers(0, 256, (N, 64)).astype(np.int32)
    res = bf.random_residuals(rng, N)
    cur = np.clip(pred + res, 0, 255).astype(np.uint8)
    inter = (rng.integers(0, 2, N) if inter_frame
             else np.zeros(N)).astype(np.uint8)
    qti = 1 if inter_frame else 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "n": n, "segments": nseg, "qis": qis,
        "res": t((cur.astype(np.int32) - pred).astype(np.int16)),
        "deq": t(np.stack([bf.triple_rows(q, pli) for q in qis])),
        "inter": t(inter),
        "lam_t": t(np.array([[rdl[qti][q] for q in qs] for qs in qis],
                            np.float32)),
        "lam_q": t(np.stack([lam_q_rows(qs, pli) for qs in qis])),
        "lam": t(np.array([rd_lambda(qs[0], int(dq[qs[0], 0, 1, 1]))
                           * RD_STRENGTH * 4.0 for qs in qis], np.float32)),
        "lam_sc": (t(rng.uniform(0.1, 8.0, N).astype(np.float32))
                   if scales else None),
        "nb": t(nb), "pred": t(pred), "cur": t(cur),
    }


def part(c: dict, g: int) -> dict:
    """The case restricted to segment g: its blocks, rows and lambdas."""
    b = slice(g * c["n"], (g + 1) * c["n"])
    out = dict(c, segments=1, qis=c["qis"][g:g + 1])
    for k in ("res", "inter", "pred", "cur", "lam_sc"):
        if c[k] is not None:
            out[k] = c[k][b]
    for k in ("deq", "lam_t", "lam_q", "lam"):
        out[k] = c[k][g:g + 1]
    return out


def kernel_args(c: dict) -> dict:
    """Each kernel's arguments for the case, the quantizers' and K1's on
    the outputs of the kernels before them (computed here)."""
    from theora_tpu_torch.ops import fdct_cuda, trellis_cuda

    k2 = (c["res"], c["deq"], c["inter"])
    q, d = fdct_cuda.fdct_quantize(*k2)
    kt = (q, d, c["deq"], c["inter"], c["lam_t"], c["nb"], c["lam_sc"])
    vals, cnt, dc_only = trellis_cuda.trellis_quantize(*kt)
    return {"K2": k2, "KT": kt,
            "KR": (q, d, c["deq"], c["inter"], c["lam_q"]),
            "K1": (vals, dc_only, cnt, c["deq"], c["inter"], c["pred"],
                   c["cur"], c["lam"], c["lam_sc"])}


def wrappers() -> dict:
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, qrd_cuda, \
        trellis_cuda

    return {"K2": fdct_cuda.fdct_quantize,
            "KT": trellis_cuda.trellis_quantize,
            "KR": qrd_cuda.quantize_rd, "K1": idct_cuda.idct_recon_choose}


def plains() -> dict:
    """Each kernel's plain PyTorch version (ops/transforms.py)."""
    from theora_tpu_torch.ops import transforms

    return {"K2": transforms.fdct_quantize,
            "KT": transforms.trellis_quantize,
            "KR": transforms.quantize_rd_rows,
            "K1": transforms.idct_recon_choose}


def run_chain(c: dict, args: dict | None = None, fns: dict | None = None):
    """K2, then KT and KR on K2's outputs, then K1's encode entry on KT's,
    one launch each over the case's segments (or fns, e.g. plains(), on
    the same arguments): {kernel: outputs}."""
    args = kernel_args(c) if args is None else args
    return {k: tuple(w(*args[k])) for k, w in (fns or wrappers()).items()}


def run_separately(c: dict) -> dict:
    """The chain as one launch of each kernel per segment, the outputs
    joined along their block axes."""
    outs = [run_chain(part(c, g)) for g in range(c["segments"])]
    return {k: tuple(torch.cat([o[k][i] for o in outs], dim=d)
                     for i, d in enumerate(BLOCK_DIMS[k]))
            for k in outs[0]}


def differ(a: dict, b: dict) -> list[str]:
    """The kernels whose outputs differ between two chain results."""
    return [k for k in a
            if not all(torch.equal(x, y) for x, y in zip(a[k], b[k]))]


def time_segments(c: dict, flush) -> dict:
    """{kernel: (ms of one launch over the segments, ms of the launches
    of one segment each)}, each a CUDA-event mean over ITERS."""
    from theora_tpu_torch.tools.bench_trellis import event_ms

    whole = kernel_args(c)
    parts = [kernel_args(part(c, g)) for g in range(c["segments"])]
    out = {}
    for k, w in wrappers().items():
        out[k] = (event_ms(lambda w=w, a=whole[k]: w(*a), ITERS, flush),
                  event_ms(lambda w=w, k=k: [w(*p[k]) for p in parts],
                           ITERS, flush))
    return out


# ------------------------------------------------------------------------
# The parent's builds (no segment axis), for the cost at G = 1.

def _old_libs(src_dir: str) -> dict:
    """The parent's four kernels built from src_dir, bound with their own
    interfaces: {kernel: launcher(args) for one-segment arguments}."""
    from theora_tpu_torch.ops.cuda_build import nvcc_build

    out_dir = os.path.join(src_dir, "build")
    libs = {}
    for k, src, flags in (("K2", "fdct_quant.cu", ()),
                          ("KT", "trellis.cu", ("-fmad=false",)),
                          ("KR", "quantize_rd.cu", ("-fmad=false",)),
                          ("K1", "idct.cu", ("-fmad=false",))):
        libs[k] = ctypes.CDLL(nvcc_build(
            os.path.join(src_dir, src),
            os.path.join(out_dir, f"lib_old_{k}.so"), flags))
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
    libs["K2"].th_fdct_quant.argtypes = [p] * 5 + [i64, i32, p]
    libs["KT"].th_trellis.argtypes = [p] * 4 + [f32] * 3 + [p] * 5 + [
        i64, i32, p]
    libs["KR"].th_quantize_rd.argtypes = [p] * 4 + [f32] * 6 + [p] * 3 + [
        i64, i32, p]
    libs["K1"].th_idct_recon_choose.argtypes = [p] * 14 + [i64, i32, p]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k2(res, deq, inter):
        n, k = res.shape[0], deq.shape[1]
        q = torch.empty((k, n, 64), dtype=torch.int16, device=res.device)
        d = torch.empty((n, 64), dtype=torch.int16, device=res.device)
        libs["K2"].th_fdct_quant(res.data_ptr(), deq.data_ptr(),
                                 inter.data_ptr(), q.data_ptr(),
                                 d.data_ptr(), n, k, stream())
        return q, d

    def outs(q):
        k, n = q.shape[:2]
        return (torch.empty_like(q),
                torch.empty((k, n), dtype=torch.int32, device=q.device),
                torch.empty((k, n), dtype=torch.bool, device=q.device))

    def kt(q, d, deq, inter, lam, nb, lam_sc):
        k, n = q.shape[:2]
        v, c, dc = outs(q)
        lams = [float(lam[0, min(i, k - 1)]) for i in range(3)]
        libs["KT"].th_trellis(
            q.data_ptr(), d.data_ptr(), deq.data_ptr(), inter.data_ptr(),
            *lams, None if lam_sc is None else lam_sc.data_ptr(),
            nb.data_ptr(), v.data_ptr(), c.data_ptr(), dc.data_ptr(), n, k,
            stream())
        return v, c, dc

    def kr(q, d, deq, inter, lam_q):
        k, n = q.shape[:2]
        v, c, dc = outs(q)
        lams = [float(lam_q[0, min(i, k - 1), t]) for i in range(3)
                for t in (0, 1)]
        libs["KR"].th_quantize_rd(
            q.data_ptr(), d.data_ptr(), deq.data_ptr(), inter.data_ptr(),
            *lams, v.data_ptr(), c.data_ptr(), dc.data_ptr(), n, k,
            stream())
        return v, c, dc

    def k1(q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc):
        k, n = q16.shape[:2]
        dev = q16.device
        recon = torch.empty((n, 64), dtype=torch.uint8, device=dev)
        ssd = torch.empty(n, dtype=torch.int32, device=dev)
        qii = torch.empty(n, dtype=torch.uint8, device=dev)
        q = torch.empty((n, 64), dtype=torch.int16, device=dev)
        cs = torch.empty(n, dtype=torch.int32, device=dev)
        libs["K1"].th_idct_recon_choose(
            q16.data_ptr(), dc_only.data_ptr(), cnt.data_ptr(),
            deq.data_ptr(), inter.data_ptr(), pred.data_ptr(),
            cur.data_ptr(), lam.data_ptr(),
            None if lam_sc is None else lam_sc.data_ptr(), recon.data_ptr(),
            ssd.data_ptr(), qii.data_ptr(), q.data_ptr(), cs.data_ptr(), n,
            k, stream())
        return recon, ssd, qii, q, cs

    return {"K2": k2, "KT": kt, "KR": kr, "K1": k1}


def compare_old(c: dict, src_dir: str, flush) -> dict:
    """Each kernel at G = 1 on segment 0 of the case: its outputs against
    the parent's build's (K > 1, so K1's kept values are its own arrays),
    then both timed in turns. Returns {kernel: [old, new, new, old] ms}
    and, under "KT_pairs_changed", the (row, block) pairs whose trellis
    values differ from the parent's: the lone value's cost now fuses lam
    * bits as the JAX encoder's scan does (ROADMAP.md §3, F4), which
    decides near-ties at fractional lambdas. Any other difference
    raises."""
    from theora_tpu_torch.tools.bench_trellis import event_ms

    old = _old_libs(src_dir)
    args = kernel_args(part(c, 0))
    out = {}
    for k, w in wrappers().items():
        a = args[k]
        # The parent's KT and KR take their lambdas by value: from a host
        # copy, so no launch waits for a device read.
        a_old = (a[:4] + (a[4].cpu(),) + a[5:]) if k in ("KT", "KR") else a
        got, want = w(*a), old[k](*a_old)
        if k == "KT":
            out["KT_pairs_changed"] = int(
                (got[0] != want[0]).any(dim=2).sum())
        elif not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{k} at G = 1 differs from the parent's")
        fns = (lambda f=old[k], a=a_old: f(*a), lambda w=w, a=a: w(*a))
        out[k] = [event_ms(fns[i], ITERS, flush) for i in (0, 1, 1, 0)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--blocks", type=int, default=14400)
    ap.add_argument("--segments", type=int, default=3)
    ap.add_argument("--old-src", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_segments: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    c = segment_case(np.random.default_rng(SEED), args.blocks,
                     args.segments, dev)
    kargs = kernel_args(c)
    one = run_chain(c, kargs)
    bad = differ(one, run_chain(c, kargs, plains()))
    if bad:
        raise AssertionError(f"kernels != plain over {args.segments} "
                             f"segments: {bad}")
    bad = differ(one, run_separately(c))
    if bad:
        raise AssertionError(f"one launch over {args.segments} segments != "
                             f"{args.segments} launches: {bad}")
    summary = {"card": smi, "blocks_per_segment": args.blocks,
               "segments": args.segments, "qis": c["qis"],
               "one_vs_separate_ms": time_segments(c, flush)}
    for k, (one, sep) in summary["one_vs_separate_ms"].items():
        print(f"[segments] {k}: one launch over {args.segments} x "
              f"{args.blocks} blocks {one:.4f} ms, {args.segments} launches "
              f"{sep:.4f} ms | {smi}", flush=True)
    if args.old_src:
        summary["g1_old_new_new_old_ms"] = compare_old(c, args.old_src,
                                                       flush)
        for k, v in summary["g1_old_new_new_old_ms"].items():
            if k == "KT_pairs_changed":
                print(f"[G = 1] KT: {v} (row, block) pairs differ from the "
                      f"parent's", flush=True)
                continue
            print(f"[G = 1] {k}: parent / this / this / parent "
                  f"{' / '.join(f'{x:.4f}' for x in v)} ms | {smi}",
                  flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
