"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. card: name and power limit;
2. build: the native host library (g++) and kernel K1 (nvcc, sm_90a),
   both from the sources in the checkout, in parallel;
3. K1 against its plain PyTorch version on the card: random blocks at the
   main path's per-plane shapes (115,200 and 28,800 at 1280x720 4:2:0,
   batch 8) and their sum 172,800, int16 extremes included, and the
   libtheora iDCT vectors, exact equality; CUDA-event times of both at
   172,800 blocks, beside a device copy of the same bytes;
4. golden streams: BatchDecoder(device="cuda").decode_clip must equal
   libtheora's .ref.yuv output byte for byte;
5. real size, the main path: decode_clip(batch=8) of the 1280x720 test
   stream, every frame's SHA-256 against the committed list, a warm pass
   timed with K1's launch count reset just before it.

The last two lines are the card's name and power limit from nvidia-smi,
then {"ok": true, "device": {...}}. Imports nothing of JAX or theora_tpu.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(ROOT, "testdata")
GOLDEN = ("cif_k4_q40", "cif_cbr", "clip64x48_k8_q5", "crop80x64",
          "clip422", "clip444")
HD_NAME = "hd720_q56_k12"
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and int32
# operations/s outside the tensor cores, half the 67 TFLOP/s float32 rate
# (an SM has 64 INT32 lanes beside its 128 FP32 lanes).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 33.5e12
# int32 operations per 8x8 block in csrc/idct.cu: 16 1-D iDCTs of 16
# (c*x)>>16 products (2 ops), 12 wraps (3 ops) and 28 adds = 96 ops; 64
# dequant products with a wrap (4 ops); 64 output round/shift/wraps
# (5 ops).
K1_OPS_PER_BLOCK = 16 * (16 * 2 + 12 * 3 + 28) + 64 * 4 + 64 * 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name, smi


def build() -> None:
    from theora_tpu_torch import native
    from theora_tpu_torch.ops import idct_cuda

    def timed(fn):
        t0 = time.perf_counter()
        path = fn()
        return path, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        jobs = {"native (g++)": ex.submit(timed, native.build),
                "K1 (nvcc sm_90a)": ex.submit(timed, idct_cuda.build)}
        for what, job in jobs.items():
            path, dt = job.result()
            log(f"[build] {what}: {dt:.2f}s -> {os.path.relpath(path, ROOT)}")
    with open(idct_cuda._SO + ".log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")


def _k1_inputs(rng, n, nframes, device):
    """Random K1 inputs: coefficients over the whole int16 range (so the
    wraps are exercised), random DC, tables, flags."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (
        t(rng.integers(-32768, 32768, (n, 64), dtype=np.int16)),
        t(rng.integers(-32768, 32768, n, dtype=np.int16)),
        t(rng.integers(1, 32768, (nframes, 3, 2, 64), dtype=np.int16)),
        t(np.sort(rng.integers(0, nframes, n)).astype(np.int32)),
        t(rng.integers(0, 3, n).astype(np.uint8)),
        t(rng.integers(0, 2, n).astype(np.uint8)),
        t(rng.random(n) < 0.3),
    )


def _vector_inputs(device):
    """libtheora's iDCT cases (natural-order coefficients x, outputs y)
    as K1 inputs: zig-zag coefficients, unit dequant, no DC-only."""
    from theora_tpu_torch.constants import ZIGZAG_TO_NAT

    rec = np.dtype([("x", "<i2", 64), ("zzi", "<i4"), ("y", "<i2", 64)])
    cases = np.fromfile(os.path.join(TESTDATA, "vectors", "idct_cases.bin"),
                        dtype=rec)
    x = cases["x"].astype(np.int16)
    n = len(x)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    inputs = (
        t(x[:, ZIGZAG_TO_NAT]), t(x[:, 0]),
        t(np.ones((1, 3, 2, 64), np.int16)), t(np.zeros(n, np.int32)),
        t(np.zeros(n, np.uint8)), t(np.zeros(n, np.uint8)),
        t(np.zeros(n, bool)),
    )
    return inputs, cases["y"].astype(np.int16)


def _event_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean CUDA-event time of fn over iters calls, each after writing a
    buffer larger than L2 so the inputs come from device memory."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.fill_(1)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def kernel_vs_plain(device) -> dict:
    from theora_tpu_torch.ops import idct_cuda, transforms

    rng = np.random.default_rng(20261016)
    # The main path launches K1 once per plane per batch of 8 frames:
    # 8 * 14400 luma and 8 * 3600 blocks per chroma plane at 1280x720
    # 4:2:0. Check those shapes and their sum, the issue's 172,800.
    err = 0
    for n in (8 * 14400, 8 * 3600, 8 * (14400 + 2 * 3600)):
        args = _k1_inputs(rng, n, 8, device)
        got = idct_cuda.dequantize_idct_frames(*args)
        want = transforms.dequantize_idct_frames(*args)
        torch.cuda.synchronize()
        err = max(err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 != plain on {n} random blocks "
                                 f"(max |d| {err})")
    vin, vy = _vector_inputs(device)
    vgot = idct_cuda.dequantize_idct_frames(*vin).cpu().numpy()
    vplain = transforms.dequantize_idct_frames(*vin).cpu().numpy()
    if not (np.array_equal(vgot, vy) and np.array_equal(vplain, vy)):
        raise AssertionError("K1 or plain != libtheora idct_cases.bin")
    err = max(err, int(np.abs(vgot.astype(np.int32) - vy).max()))
    log(f"[k1] random 115200, 28800 and {n} blocks: kernel == plain; "
        f"idct_cases.bin {len(vy)} cases: kernel == plain == libtheora; "
        f"max |err| {err} (tolerance 0: exact)")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    ms = _event_ms(lambda: idct_cuda.dequantize_idct_frames(*args), 50,
                   flush)
    plain_ms = _event_ms(lambda: transforms.dequantize_idct_frames(*args), 5,
                         flush)
    nbytes = sum(a.numel() * a.element_size() for a in args) + n * 64 * 2
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    # What the card's memory actually sustains: one device copy that
    # reads and writes the same number of bytes as K1 moves.
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    copy_ms = _event_ms(lambda: dst.copy_(src), 50, flush)
    ops_ms = n * K1_OPS_PER_BLOCK / INT32_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[k1] time at {n} blocks: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms; bound {bound_ms:.4f} ms ({nbytes} B -> {bytes_ms:.4f} ms at "
        f"3.35 TB/s; {n * K1_OPS_PER_BLOCK} int32 ops -> {ops_ms:.4f} ms); "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved; a device copy of "
        f"the same bytes takes {copy_ms:.4f} ms "
        f"({nbytes / (copy_ms * 1e-3) / 1e9:.1f} GB/s); no single PyTorch "
        f"call computes this integer iDCT (library_ms null)")
    return {
        "name": "dequant_idct", "route": "cuda",
        "source": "theora_tpu_torch/csrc/idct.cu",
        "replaces": "theora_tpu/ops/pallas_kernels.py:174",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def _open(name: str):
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    if name.endswith(".ogv"):
        from theora_tpu_torch.ogg import demux_stream

        with open(os.path.join(TESTDATA, name), "rb") as f:
            pkts = demux_stream(f.read())
    else:
        from theora_tpu_torch.tpkt import read_tpkt

        pkts = read_tpkt(os.path.join(TESTDATA, name))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    return BatchDecoder(info, setup, device="cuda"), [p.data for p in pkts[3:]]


def _frame_bytes(frame) -> bytes:
    return b"".join(np.ascontiguousarray(p).tobytes() for p in frame)


def golden_streams() -> None:
    from theora_tpu_torch.ops import idct_cuda

    for name in GOLDEN:
        dec, data = _open(f"{name}.tpkt")
        before = idct_cuda.dequantize_idct_frames.launches
        outs = dec.decode_clip(data, batch=8)
        launched = idct_cuda.dequantize_idct_frames.launches - before
        ref = np.fromfile(os.path.join(TESTDATA, f"{name}.ref.yuv"),
                          np.uint8).reshape(len(data), -1)
        bad = [i for i, o in enumerate(outs)
               if _frame_bytes(o) != ref[i].tobytes()]
        if len(outs) != len(data) or bad:
            raise AssertionError(f"{name}: frames {bad} differ from .ref.yuv")
        if launched == 0:
            raise AssertionError(f"{name}: K1 was not launched")
        log(f"[golden] {name}: {len(outs)} frames byte-identical to "
            f".ref.yuv; K1 launches {launched}")


def real_size(smi: str) -> int:
    from theora_tpu_torch.ops import idct_cuda

    with open(os.path.join(TESTDATA, f"{HD_NAME}.sha256")) as f:
        want = f.read().split()

    def check(outs, what):
        got = [hashlib.sha256(_frame_bytes(o)).hexdigest() for o in outs]
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if len(got) != len(want) or bad:
            raise AssertionError(f"{HD_NAME} {what}: frames {bad} differ")

    dec, data = _open(f"{HD_NAME}.ogv")
    check(dec.decode_clip(data, batch=8), "first pass")
    # Warm pass: a fresh decoder on the same process, K1 count from 0.
    dec, data = _open(f"{HD_NAME}.ogv")
    dec.device_spans = []
    torch.cuda.synchronize()
    idct_cuda.dequantize_idct_frames.launches = 0
    t0 = time.perf_counter()
    outs = dec.decode_clip(data, batch=8)
    wall = time.perf_counter() - t0
    launches = idct_cuda.dequantize_idct_frames.launches
    check(outs, "warm pass")
    if launches == 0:
        raise AssertionError("K1 was not launched on the main path")
    torch.cuda.synchronize()
    dev_s = sum(a.elapsed_time(b) for a, b in dec.device_spans) / 1e3
    nf = len(outs)
    mpix = nf * 1280 * 720 * 1.5 / 1e6
    log(f"[720p] {nf} frames, all {len(want)} SHA-256 match; warm pass "
        f"{wall:.4f} s = {nf / wall:.2f} frames/s = {mpix / wall:.2f} "
        f"Mpix/s; host parse {dec.host_parse_s:.4f} s; device spans "
        f"(CUDA events) {dev_s:.4f} s over {len(dec.device_spans)} "
        f"batches; K1 launches {launches} | {smi}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    name, smi = card()
    build()
    k1 = kernel_vs_plain(torch.device("cuda"))
    golden_streams()
    k1["launches"] = real_size(smi)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
