"""Kernel KT's inputs, bound and time on the card, beside an earlier build.

Usage: python -m theora_tpu_torch.tools.bench_trellis [--old-src PATH]

Times KT (csrc/trellis.cu) with CUDA events over 50 launches, L2 flushed
before each, on launches like those of the 720p encode (one per plane per
frame):

- K2's outputs on random residuals (the generator chip_smoke.py's phase
  6b checks KT on), 14,400 and 3,600 blocks (a 1280x720 luma and chroma
  plane), an inter frame;
- the 1280x720 test clip's first frame as the encoder's first launch of
  each plane sees it (intra: residual = source - 128; q48), luma and
  chroma.

For each it prints the histogram of nonzero AC values per block and the
bound (bytes moved and the float32 operations these inputs need). With
--old-src, a trellis.cu of the interface before KT read K2's outputs
directly (th_trellis over three [N, 64] int32 rows, [N] lambdas and [N]
acmins) is built beside it and both are timed in turns, old, new, new, old;
both must equal the plain version first. Needs a CUDA card. Prints one
JSON summary as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# float32 rate outside the tensor cores.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
QI_HD = 48
SEED = 20261018
ITERS = 50  # timed launches per reading


def kt_tables():
    """(dequant tables [qi, plane, qti, 64], the [64, 32] bit table, the
    pixel-format-0 lambdas [qti, qi]), as the encoder builds them."""
    from theora_tpu_torch import tables
    from theora_tpu_torch.encode.gop import trellis_bit_costs
    from theora_tpu_torch.quant import dequant_tables_init

    return (dequant_tables_init(tables.DEF_QUANT_INFO),
            trellis_bit_costs(tables.VP31_HUFF_CODES),
            np.array(tables.RD_LAMBDA[0], np.float32))  # [qti, qi]


def k2_cases(device, sizes=(14400, 3600, 21600)):
    """(label, KT arguments) for K2's outputs on random residuals, from
    noise to nearly flat blocks: per size an intra frame (every block
    intra, the intra lambda) and an inter frame (inter flags at random,
    the inter lambda), at a qi and plane drawn per size."""
    from theora_tpu_torch.ops import fdct_cuda

    dq, nb, lam_tab = kt_tables()
    rng = np.random.default_rng(SEED)
    nb = torch.from_numpy(nb).to(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for n in sizes:
        qi = int(rng.integers(0, 64))
        deq = t(dq[qi, int(rng.integers(0, 3))].astype(np.int16))
        for qti in (0, 1):
            inter = (np.zeros(n, np.uint8) if qti == 0
                     else rng.integers(0, 2, n).astype(np.uint8))
            res = (rng.integers(-255, 256, (n, 64))
                   // rng.integers(1, 40, (n, 1)))
            q, d = fdct_cuda.fdct_quantize(t(res.astype(np.int16)), deq,
                                           t(inter))
            yield (f"K2 outputs, {n} blocks, qi {qi}, "
                   f"{('intra', 'inter')[qti]} frame",
                   (q, d, deq, t(inter), lam_tab[qti, qi], nb))


def first_frame_cases(device):
    """(label, KT arguments) for the 1280x720 test clip's first frame, as
    the encoder's first launch of each plane sees it: intra, so the
    prediction is 128; q48 and the intra lambda; luma, then chroma (U)."""
    from theora_tpu_torch.encode.scan import plane_blocks
    from theora_tpu_torch.ops import fdct_cuda
    from theora_tpu_torch.tools.profile_encode import hd720_frames

    dq, nb, lam_tab = kt_tables()
    nb = torch.from_numpy(nb).to(device)
    frame = hd720_frames(1)[0]
    for pli, what in ((0, "luma"), (1, "chroma")):
        plane = np.ascontiguousarray(frame[pli][::-1])  # bitstream rows
        h, w = plane.shape
        blocks = plane_blocks(torch.from_numpy(plane)[None], h // 8,
                              w // 8)[0].to(device)
        res = (blocks.to(torch.int32) - 128).to(torch.int16)
        deq = torch.from_numpy(dq[QI_HD, pli].astype(np.int16)).to(device)
        inter = torch.zeros(len(res), dtype=torch.uint8, device=device)
        q, d = fdct_cuda.fdct_quantize(res, deq, inter)
        yield (f"720p first frame {what}, {len(res)} blocks, q{QI_HD}",
               (q, d, deq, inter, lam_tab[0, QI_HD], nb))


def nonzero_histogram(qout: np.ndarray) -> dict:
    """{nonzero AC values per block: blocks} over [N, 64] values."""
    k = (qout[:, 1:] != 0).sum(axis=1)
    counts = np.bincount(k, minlength=64)
    return {int(i): int(c) for i, c in enumerate(counts) if c}


def _kt_pairs(limit: int) -> np.ndarray:
    """[64] per position j: the DP steps i (1 <= i < j) at which a run
    from i may end at j within run length limit (limit - 1 at i == 1,
    where the DC keeps one slot of headroom)."""
    return np.array([sum(j - i <= (limit - 1 if i == 1 else limit)
                         for i in range(1, j)) for j in range(64)])


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


def kt_bound(args) -> dict:
    """KT's least time for these arguments: each input read once (two
    [N, 64] int16 rows, [N] flags, the dequant rows, the lambda, the bit
    table), each output written once ([N, 64] int16, [N] int32, [N]
    bool), over the memory rate; the float32 operations these inputs need
    over the float32 rate. The larger binds."""
    qout, dout, deq, inter, _, nb = args
    n = qout.shape[0]
    nbytes = (sum(a.numel() * a.element_size()
                  for a in (qout, dout, deq, inter, nb)) + 4
              + n * (64 * 2 + 4 + 1))
    ops = kt_float_ops(qout.cpu().numpy())
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / FP32_OPS_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def event_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean CUDA-event time of fn over iters calls, each after writing a
    buffer larger than L2 so the inputs come from device memory, and after
    a ~0.5 ms device sleep, so that the host has queued fn's launches
    before the card reaches them and the time is the card's alone."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.fill_(1)
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def _old_kernel(src: str):
    """A launcher for the earlier KT interface built from src: it takes
    the new interface's arguments, makes the old one's (int32 rows, [N]
    lambdas and acmins) once, and returns (launch, output)."""
    from theora_tpu_torch.ops.cuda_build import nvcc_build
    from theora_tpu_torch.ops.trellis_cuda import NVCC_FLAGS, _SO

    so = nvcc_build(src, _SO.replace(".so", "_old.so"), NVCC_FLAGS)
    lib = ctypes.CDLL(so)
    lib.th_trellis.restype = ctypes.c_int
    lib.th_trellis.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64,
                                                        ctypes.c_void_p]

    def prepare(args):
        qout, dout, deq, inter, lam, nb = args
        n = qout.shape[0]
        is_inter = inter != 0
        ins = (dout.to(torch.int32), qout.to(torch.int32),
               deq.to(torch.int32)[is_inter.long()].contiguous(),
               torch.full((n,), float(lam), dtype=torch.float32,
                          device=qout.device),
               nb, torch.where(is_inter, 0, 3).to(torch.int32))
        out = torch.empty((n, 64), dtype=torch.int32, device=qout.device)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = lib.th_trellis(*(a.data_ptr() for a in ins),
                                 out.data_ptr(), n, stream)
            if err != 0:
                raise RuntimeError(f"old KT launch failed: CUDA error {err}")

        return launch, out

    return so, prepare


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--old-src", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_trellis: needs a CUDA card", file=sys.stderr)
        return 2
    from theora_tpu_torch.ops import transforms, trellis_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    trellis_cuda.build()
    prepare = None
    if args.old_src:
        so, prepare = _old_kernel(args.old_src)
        print(f"[old] {args.old_src} -> {so}", flush=True)
    cases = [c for c in k2_cases(dev, (14400, 3600)) if "inter" in c[0]]
    cases += list(first_frame_cases(dev))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for label, kargs in cases:
        want = transforms.trellis_quantize(*kargs)
        got = trellis_cuda.trellis_quantize(*kargs)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"KT != plain on {label}")
        row = {"case": label, "blocks": int(kargs[0].shape[0]),
               "nonzero_ac_histogram": nonzero_histogram(
                   kargs[0].cpu().numpy())}
        row.update(kt_bound(kargs))

        def new():
            trellis_cuda.trellis_quantize(*kargs)

        if prepare is None:
            row["ms"] = [event_ms(new, ITERS, flush)]
        else:
            old, old_out = prepare(kargs)
            old()
            torch.cuda.synchronize()
            if not torch.equal(old_out, want[0].to(torch.int32)):
                raise AssertionError(f"old KT != plain on {label}")
            turns = [("old", old), ("new", new), ("new", new), ("old", old)]
            for who, fn in turns:
                row.setdefault(f"{who}_ms", []).append(
                    event_ms(fn, ITERS, flush))
            row["ms"] = row.pop("new_ms")
        print(f"[kt] {label}: " + ", ".join(
            f"{k} {v}" for k, v in row.items() if k.endswith("ms"))
            + f"; nonzero AC per block {row['nonzero_ac_histogram']} | {smi}",
            flush=True)
        rows.append(row)
    print(json.dumps({"card": smi, "iters": ITERS, "cases": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
