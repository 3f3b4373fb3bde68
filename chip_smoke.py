"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. card: name and power limit;
2. build: the native host library (g++) and kernels K1, K2 and KT (nvcc,
   sm_90a; KT with -fmad=false), all from the sources in the checkout, in
   parallel;
3. K1 against its plain PyTorch version on the card: random blocks at the
   decode path's per-plane shapes (115,200 and 28,800 at 1280x720 4:2:0,
   batch 8) and their sum 172,800, int16 extremes included; at the encode
   path's per-plane shapes (14,400 and 3,600 blocks, one frame, its one
   dequant table), whose chroma launch ends in a partial CTA; and the
   libtheora iDCT vectors, exact equality; CUDA-event times of both at
   172,800 blocks, beside a device copy of the same bytes;
4. golden streams: BatchDecoder(device="cuda").decode_clip must equal
   libtheora's .ref.yuv output byte for byte;
5. real-size decode: decode_clip(batch=8) of the 1280x720 test stream,
   every frame's SHA-256 against the committed list, a warm pass timed
   with K1's launch count reset just before it;
6. K2 against its plain version on the card: random residuals with the
   int16-safe extremes, random dequant rows and frame types, at the
   encode path's per-plane shapes (14,400 and 3,600 blocks at 1280x720
   4:2:0) and their sum 21,600, and the libtheora fDCT vectors, exact
   equality; CUDA-event times at 21,600 blocks beside a device copy of
   the same bytes;
6b. KT (the trellis) against its plain version (transforms.
   trellis_quantize) on the card, exact equality of the values, nonzero
   counts and DC-only flags, one launch per frame type as the encoder
   makes them (one qi, the frame's RD_LAMBDA lambda; intra blocks take
   acmin 3, inter blocks acmin 0): on K2's own outputs for random
   residuals at 14,400, 3,600 and 21,600 blocks, an intra and an inter
   frame each; on the 1280x720 clip's first frame, luma and chroma; on
   the edge classes (no nonzero AC value, one nonzero value at position
   63 or at position 1, dense +-32767) among K2's outputs; on a launch
   without any nonzero AC value; on 1,500 blocks of coefficients up to
   +-32767; on the 97 blocks of testdata/vectors/trellis_order_cases.npz,
   one launch per (qi, frame type); CUDA-event times at 14,400 and 3,600
   blocks of K2's outputs, of the first frame's planes and of the launch
   without nonzero AC values, each beside its bound and its histogram of
   nonzero AC values per block (tools/bench_trellis.py), and of the plain
   version at 14,400;
7. small encodes: GopEncoder(device="cuda") at 64x48 for pixel formats
   0, 2 and 3, every packet's SHA-256 against the list the JAX
   TpuGopEncoder made (testdata/make_hd720_enc.py);
8. real-size encode, the main path: 16 frames of the 1280x720 clip at
   q48, a keyframe every 8 frames, clip_batch 8, every packet's SHA-256
   against the JAX encoder's list; the closed-loop reconstruction of the
   first GOP against BatchDecoder(device="cuda") on its packets; a warm
   encode_clip pass timed with the K1, K2 and KT launch counts reset just
   before it (KT must launch once per plane per frame: 48), and its PSNR
   against the source.

Then one JSON line listing the three kernels, the card's name and power limit
from nvidia-smi, and {"ok": true, "device": {...}}. Imports nothing of
JAX or theora_tpu.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import importlib.util
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
# int32 operations per 8x8 block in csrc/fdct_quant.cu: 16 1-D fDCTs of
# 119 ops (8 input adds, 6 butterflies, 2 x 9 for the t5/t6 rotations,
# 15 for y0/y4, 3 x 16 for y2/y6, y5/y3, y1/y7, 8 wraps of 3); 64 input
# x4 scalings; 64 output round/shift/wraps (5 ops); 64 quantizations
# (abs, shift, compare, add, double, divide counted as one, sign: 8).
K2_OPS_PER_BLOCK = 16 * 119 + 64 + 64 * 5 + 64 * 8
HD_ENC_NAME = "hd720_q48_k8_enc"


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
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, trellis_cuda

    def timed(fn):
        t0 = time.perf_counter()
        path = fn()
        return path, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        jobs = {"native (g++)": ex.submit(timed, native.build),
                "K1 (nvcc sm_90a)": ex.submit(timed, idct_cuda.build),
                "K2 (nvcc sm_90a)": ex.submit(timed, fdct_cuda.build),
                "KT (nvcc sm_90a, -fmad=false)": ex.submit(
                    timed, trellis_cuda.build)}
        for what, job in jobs.items():
            path, dt = job.result()
            log(f"[build] {what}: {dt:.2f}s -> {os.path.relpath(path, ROOT)}")
    for k, so in (("K1", idct_cuda._SO), ("K2", fdct_cuda._SO),
                  ("KT", trellis_cuda._SO)):
        with open(so + ".log") as f:
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {k} ptxas: {line.strip()}")


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


def _k1_encode_inputs(rng, n, device):
    """K1 inputs as the encode scan builds them for one plane of one
    frame: a [1, 3, 2, 64] table holding the plane's intra and inter rows
    at [0, 0], frame and qii index 0, inter per block, DC from the
    coefficients."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    coeffs = rng.integers(-32768, 32768, (n, 64), dtype=np.int16)
    deq_tab = np.zeros((1, 3, 2, 64), np.int16)
    deq_tab[0, 0] = rng.integers(1, 32768, (2, 64), dtype=np.int16)
    return (
        t(coeffs), t(coeffs[:, 0]), t(deq_tab), t(np.zeros(n, np.int32)),
        t(np.zeros(n, np.uint8)), t(rng.integers(0, 2, n).astype(np.uint8)),
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


def kernel_vs_plain(device) -> dict:
    from theora_tpu_torch.ops import idct_cuda, transforms
    from theora_tpu_torch.tools.bench_trellis import event_ms

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
    # The encode path launches K1 once per plane per frame: 14,400 luma
    # blocks and 3,600 per chroma plane, the last CTA of which is partial.
    for ne in (14400, 3600):
        eargs = _k1_encode_inputs(rng, ne, device)
        got = idct_cuda.dequantize_idct_frames(*eargs)
        want = transforms.dequantize_idct_frames(*eargs)
        torch.cuda.synchronize()
        err = max(err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 != plain on {ne} encode-path blocks "
                                 f"(max |d| {err})")
    vin, vy = _vector_inputs(device)
    vgot = idct_cuda.dequantize_idct_frames(*vin).cpu().numpy()
    vplain = transforms.dequantize_idct_frames(*vin).cpu().numpy()
    if not (np.array_equal(vgot, vy) and np.array_equal(vplain, vy)):
        raise AssertionError("K1 or plain != libtheora idct_cases.bin")
    err = max(err, int(np.abs(vgot.astype(np.int32) - vy).max()))
    log(f"[k1] random 115200, 28800 and {n} blocks (decode shapes), 14400 "
        f"and 3600 blocks (encode shapes): kernel == plain; "
        f"idct_cases.bin {len(vy)} cases: kernel == plain == libtheora; "
        f"max |err| {err} (tolerance 0: exact)")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    ms = event_ms(lambda: idct_cuda.dequantize_idct_frames(*args), 50,
                   flush)
    plain_ms = event_ms(lambda: transforms.dequantize_idct_frames(*args), 5,
                         flush)
    nbytes = sum(a.numel() * a.element_size() for a in args) + n * 64 * 2
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    # What the card's memory actually sustains: one device copy that
    # reads and writes the same number of bytes as K1 moves.
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    copy_ms = event_ms(lambda: dst.copy_(src), 50, flush)
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


def _load_testdata(name: str):
    """A generator module of testdata/ by path (numpy only at import)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TESTDATA, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k2_inputs(rng, n, device):
    """Random K2 inputs: residuals over [-255, 255] with the int16-safe
    extremes (saturated flat, checkerboard and stripe blocks), random
    dequant rows, random frame types."""
    res = rng.integers(-255, 256, (n, 64)).astype(np.int16)
    ext = np.stack([
        np.full(64, 255), np.full(64, -255),
        np.where(np.indices((8, 8)).sum(0) % 2, 255, -255).reshape(64),
        np.where(np.arange(64) % 2, -255, 255),
        np.where(np.arange(64) // 8 % 2, -255, 255),
    ]).astype(np.int16)
    res[:len(ext)] = ext

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(res), t(rng.integers(8, 4097, (2, 64)).astype(np.int16)),
            t(rng.integers(0, 2, n).astype(np.uint8)))


def k2_vs_plain(device) -> dict:
    from theora_tpu_torch.ops import fdct_cuda, transforms
    from theora_tpu_torch.tools.bench_trellis import event_ms

    rng = np.random.default_rng(20261017)
    # The encode path launches K2 once per plane per frame: 14,400 luma
    # and 3,600 blocks per chroma plane at 1280x720 4:2:0; and their sum.
    err = 0
    for n in (14400, 3600, 21600):
        args = _k2_inputs(rng, n, device)
        got = fdct_cuda.fdct_quantize(*args)
        want = transforms.fdct_quantize(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, int((g.int() - w.int()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"K2 != plain on {n} random blocks "
                                     f"(max |d| {err})")
    rec = np.dtype([("x", "<i2", 64), ("y", "<i2", 64)])
    cases = np.fromfile(os.path.join(TESTDATA, "vectors", "fdct_cases.bin"),
                        dtype=rec)
    vin = (torch.from_numpy(cases["x"].copy()).to(device),
           torch.full((2, 64), 8, dtype=torch.int16, device=device),
           torch.zeros(len(cases), dtype=torch.uint8, device=device))
    vq, vd = fdct_cuda.fdct_quantize(*vin)
    pq, pd = transforms.fdct_quantize(*vin)
    vd = vd.cpu().numpy()
    if not (np.array_equal(vd, cases["y"]) and torch.equal(vq, pq)
            and np.array_equal(pd.cpu().numpy(), cases["y"])):
        raise AssertionError("K2 or plain != libtheora fdct_cases.bin")
    err = max(err, int(np.abs(vd.astype(np.int32) - cases["y"]).max()))
    log(f"[k2] random 14400, 3600 and {n} blocks: kernel == plain "
        f"(quantized and DCT); fdct_cases.bin {len(cases)} cases: kernel "
        f"DCT == plain == libtheora; max |err| {err} (tolerance 0: exact)")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    ms = event_ms(lambda: fdct_cuda.fdct_quantize(*args), 50, flush)
    plain_ms = event_ms(lambda: transforms.fdct_quantize(*args), 5, flush)
    # Each input read once, each output written once: residuals, frame
    # types and the two dequant rows in; quantized and DCT blocks out.
    nbytes = sum(a.numel() * a.element_size() for a in args) + 2 * n * 128
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    copy_ms = event_ms(lambda: dst.copy_(src), 50, flush)
    ops_ms = n * K2_OPS_PER_BLOCK / INT32_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[k2] time at {n} blocks: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms; bound {bound_ms:.4f} ms ({nbytes} B -> {bytes_ms:.4f} ms at "
        f"3.35 TB/s; {n * K2_OPS_PER_BLOCK} int32 ops -> {ops_ms:.4f} ms); "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved; a device copy of "
        f"the same bytes takes {copy_ms:.4f} ms "
        f"({nbytes / (copy_ms * 1e-3) / 1e9:.1f} GB/s); no single PyTorch "
        f"call computes this integer fDCT + quantizer (library_ms null)")
    return {
        "name": "fdct_quant", "route": "cuda",
        "source": "theora_tpu_torch/csrc/fdct_quant.cu",
        "replaces": "theora_tpu/ops/pallas_kernels.py:194",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def _kt_cases(device):
    """(label, KT arguments, timed) for one launch each: K2's outputs on
    random residuals at the encode path's per-plane shapes, an intra and an
    inter frame each (tools/bench_trellis.py:k2_cases); the 720p clip's
    first frame, luma and chroma; the edge classes; a launch of blocks with
    no nonzero AC value; coefficients up to +-32767; the prefix-sum order
    cases, one launch per (qi, frame type)."""
    from theora_tpu_torch import tables
    from theora_tpu_torch.ops import fdct_cuda, transforms
    from theora_tpu_torch.tools import bench_trellis as bt

    for label, args in bt.k2_cases(device):
        yield label, args, args[0].shape[0] in (14400, 3600) and \
            "inter" in label
    for label, args in bt.first_frame_cases(device):
        yield label, args, True
    dq, nb, lam_tab = bt.kt_tables()
    nb = torch.from_numpy(nb).to(device)
    rng = np.random.default_rng(20261019)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def launch(dct, qi, qti, inter=None):
        """KT arguments for [N, 64] DCT rows of one frame type at qi; the
        round-to-nearest values from the plain quantizer, as K2 makes
        them."""
        n = len(dct)
        if inter is None:
            inter = np.full(n, qti, np.uint8)
        deq = dq[qi, 0].astype(np.int16)
        q = transforms.quantize(
            t(dct.astype(np.int32)),
            t(deq.astype(np.int32)[inter.astype(np.int64)]))
        return (q.to(torch.int16), t(dct.astype(np.int16)), t(deq), t(inter),
                lam_tab[qti, qi], nb)

    # Edge classes among K2's outputs, a frame of each type at one qi: no
    # nonzero AC value (a fixed result), one nonzero value at position 63
    # (its combos wrap to position 0) or at position 1 (the first step's
    # headroom), dense +-32767.
    qi, n = 36, 2000
    rows = dq[qi, 0].astype(np.int32)
    for qti in (0, 1):
        inter = (np.zeros(n, np.uint8) if qti == 0
                 else rng.integers(0, 2, n).astype(np.uint8))
        res = rng.integers(-255, 256, (n, 64)) // rng.integers(1, 40, (n, 1))
        _, d = fdct_cuda.fdct_quantize(t(res.astype(np.int16)),
                                       t(rows.astype(np.int16)), t(inter))
        dct = d.cpu().numpy().astype(np.int32)
        r = rows[inter.astype(np.int64)]
        sign = rng.choice([-1, 1], (n, 64))
        k = np.arange(0, 400, 4)
        dct[k, 1:] = sign[k, 1:] * (r[k, 1:] // 2 - 1)
        dct[k + 1, 1:] = 0
        dct[k + 1, 63] = sign[k + 1, 63] * r[k + 1, 63] * (k % 37 + 1)
        dct[k + 2, 1:] = 0
        dct[k + 2, 1] = sign[k + 2, 1] * r[k + 2, 1] * (k % 37 + 1)
        dct[k + 3] = sign[k + 3] * 32767
        yield (f"edge classes among K2 outputs, {n} blocks, qi {qi}, "
               f"{('intra', 'inter')[qti]} frame",
               launch(dct, qi, qti, inter), False)
    # A whole launch without a nonzero AC value: every block skips the DP.
    dct = rng.integers(-255, 256, (3600, 64))
    dct[:, 1:] //= 64
    yield ("3600 blocks without a nonzero AC value, q48",
           launch(dct, 48, 0), True)
    for qi in (5, 30, 60):
        for qti in (0, 1):
            yield (f"coefficients up to +-32767, 250 blocks, qi {qi}, "
                   f"{('intra', 'inter')[qti]}",
                   launch(rng.integers(-32767, 32768, (250, 64)), qi, qti),
                   False)
    cases = np.load(os.path.join(TESTDATA, "vectors",
                                 "trellis_order_cases.npz"))
    for qi, qti in sorted(set(zip(cases["qi"].tolist(),
                                  cases["qti"].tolist()))):
        sel = (cases["qi"] == qi) & (cases["qti"] == qti)
        yield (f"trellis_order_cases.npz, qi {qi}, qti {qti}, "
               f"{int(sel.sum())} blocks",
               launch(cases["dct"][sel], qi, qti), False)


def kt_vs_plain(device) -> dict:
    from theora_tpu_torch.ops import transforms, trellis_cuda
    from theora_tpu_torch.tools import bench_trellis as bt

    err = 0
    n_order = n_launches = 0
    timed = []
    for label, args, is_timed in _kt_cases(device):
        got = trellis_cuda.trellis_quantize(*args)
        want = transforms.trellis_quantize(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, int((g.int() - w.int()).abs().max()))
            if not torch.equal(g, w):
                bad = int((g != w).reshape(len(g), -1).any(dim=1).sum())
                raise AssertionError(f"KT != plain on {label}: {bad} blocks "
                                     f"differ (max |d| {err})")
        n_launches += 1
        if label.startswith("trellis_order_cases"):
            n_order += len(want[0])
            continue
        moved = int((want[0] != args[0]).any(dim=1).sum())
        log(f"[kt] {label}: kernel == plain (values, counts, DC-only flags); "
            f"the trellis changed {moved} of {len(want[0])} blocks' "
            f"round-to-nearest values; {int(want[2].sum())} blocks DC-only")
        if is_timed:
            timed.append((label, args))
    log(f"[kt] trellis_order_cases.npz: {n_order} blocks, kernel == plain "
        f"in every (qi, frame type) launch; {n_launches} launches in all; "
        f"max |err| {err} (tolerance 0: exact)")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    for i, (label, args) in enumerate(timed):
        ms = bt.event_ms(lambda: trellis_cuda.trellis_quantize(*args), 50,
                         flush)
        b = bt.kt_bound(args)
        hist = bt.nonzero_histogram(args[0].cpu().numpy())
        log(f"[kt] time, {label}: kernel {ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']} B -> "
            f"{b['bytes_ms']:.4f} ms at 3.35 TB/s; {b['ops']} float32 ops "
            f"that these inputs need -> {b['ops_ms']:.4f} ms at 67 TFLOP/s);"
            f" kernel at {100 * b['bound_ms'] / ms:.2f}% of its bound; "
            f"blocks by nonzero AC values {hist}")
        if i == 0:  # 14,400 blocks of K2's outputs: one 720p luma plane
            head, head_ms, head_bound = label, ms, b
            plain_ms = bt.event_ms(
                lambda: transforms.trellis_quantize(*args), 5, flush)
    log(f"[kt] {head}: plain {plain_ms:.4f} ms; no single PyTorch call "
        f"computes this trellis (library_ms null)")
    return {
        "name": "trellis", "route": "cuda",
        "source": "theora_tpu_torch/csrc/trellis.cu",
        "replaces": "theora_tpu/ops/transforms_jax.py:300",
        "launches": None, "max_abs_err": err, "ms": head_ms,
        "plain_ms": plain_ms, "bound_ms": head_bound["bound_ms"],
        "bound_by": head_bound["bound_by"], "library_ms": None,
    }


def _encoder(w, h, fmt, qi):
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo

    return GopEncoder(TheoraInfo(frame_width=w, frame_height=h,
                                 pic_width=w, pic_height=h, quality=qi,
                                 pixel_fmt=fmt), qi=qi, device="cuda")


def _packet_hashes(pkts) -> list[str]:
    return [hashlib.sha256(p.data).hexdigest() for p in pkts]


def small_encodes() -> None:
    mk = _load_testdata("make_hd720_enc")
    with open(os.path.join(TESTDATA, "enc64x48.sha256")) as f:
        want = f.read().split()
    got = []
    for fmt in mk.SMALL_FORMATS:
        frames = mk.moving_frames(64, 48, fmt, mk.SMALL_FRAMES, 11 + fmt)
        got += _packet_hashes(_encoder(64, 48, fmt, mk.SMALL_QI).encode_clip(
            frames, keyframe_freq=mk.SMALL_KF, clip_batch=8))
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"64x48 encode: packets {bad} differ from the "
                             f"JAX encoder's")
    log(f"[enc64x48] formats {mk.SMALL_FORMATS}: all {len(got)} packets "
        f"equal the JAX TpuGopEncoder's (SHA-256)")


def _psnr(frames, outs) -> float:
    se = n = 0
    for src, dec in zip(frames, outs):
        for a, b in zip(src, dec):
            d = a.astype(np.int64) - b.astype(np.int64)
            se += int((d * d).sum())
            n += d.size
    return 10 * np.log10(255.0 ** 2 * n / max(se, 1))


def real_size_encode(smi: str) -> tuple[int, int]:
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, trellis_cuda

    mk = _load_testdata("make_hd720_enc")
    frames = mk.hd_frames()
    with open(os.path.join(TESTDATA, f"{HD_ENC_NAME}.sha256")) as f:
        want = f.read().split()

    def encode(enc):
        return enc.encode_clip(frames, keyframe_freq=mk.HD_KF, clip_batch=8)

    def check(pkts, what):
        got = _packet_hashes(pkts)
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if len(got) != len(want) or bad:
            raise AssertionError(f"{HD_ENC_NAME} {what}: packets {bad} "
                                 f"differ from the JAX encoder's")

    check(encode(_encoder(1280, 720, 0, mk.HD_QI)), "first pass")
    # Closed loop: the first GOP's carried reconstruction against the
    # port's decoder on its packets.
    enc = _encoder(1280, 720, 0, mk.HD_QI)
    datas, recon = enc.encode_gop(frames[:mk.HD_KF], want_recon=True)
    hdr = enc.flush_headers()
    info, setup = parse_info_header(hdr[0].data), parse_setup_header(
        hdr[2].data)
    outs = BatchDecoder(info, setup, device="cuda").decode_clip(datas,
                                                                batch=8)
    g = enc.g
    for f, out in enumerate(outs):
        for pli in range(3):
            vpad, hpad = g.plane_padding(pli)
            h, w = g.plane_shape(pli)
            if not np.array_equal(
                    recon[pli][f][vpad:vpad + h, hpad:hpad + w][::-1],
                    out[pli]):
                raise AssertionError(f"720p closed loop: frame {f} plane "
                                     f"{pli} recon != decode")
    log(f"[enc720p] closed loop: the first GOP's {len(outs)} reconstructed "
        f"frames equal BatchDecoder(device='cuda') on its packets")

    # Warm pass, the main path: launch counts from 0 just before it.
    enc = _encoder(1280, 720, 0, mk.HD_QI)
    enc.device_spans = []
    torch.cuda.synchronize()
    idct_cuda.dequantize_idct_frames.launches = 0
    fdct_cuda.fdct_quantize.launches = 0
    trellis_cuda.trellis_quantize.launches = 0
    t0 = time.perf_counter()
    pkts = encode(enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, kt = (idct_cuda.dequantize_idct_frames.launches,
                  fdct_cuda.fdct_quantize.launches,
                  trellis_cuda.trellis_quantize.launches)
    check(pkts, "warm pass")
    # One launch of each per plane per frame.
    if k1 == 0 or k2 == 0 or kt != 3 * len(frames):
        raise AssertionError(f"encode path launches: K1 {k1}, K2 {k2}, KT "
                             f"{kt}; K1 and K2 must run, KT "
                             f"{3 * len(frames)} times")
    dev_s = sum(a.elapsed_time(b) for a, b in enc.device_spans) / 1e3
    outs = BatchDecoder(info, setup, device="cuda").decode_clip(
        [p.data for p in pkts[3:]], batch=8)
    nf = len(frames)
    mpix = nf * 1280 * 720 * 1.5 / 1e6
    log(f"[enc720p] {nf} frames, all {len(want)} packet SHA-256 equal the "
        f"JAX encoder's; {sum(len(p.data) for p in pkts[3:])} bytes; warm "
        f"pass {wall:.4f} s = {nf / wall:.2f} frames/s = {mpix / wall:.2f} "
        f"Mpix/s; host mode decision {enc.host_decide_s:.4f} s, host "
        f"packing {enc.host_pack_s:.4f} s; device spans (CUDA events, ME "
        f"and plane encodes) {dev_s:.4f} s; PSNR {_psnr(frames, outs):.3f} "
        f"dB against the source; launches K1 {k1}, K2 {k2}, KT {kt} | "
        f"{smi}")
    return k1, k2, kt


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    name, smi = card()
    build()
    dev = torch.device("cuda")
    k1 = kernel_vs_plain(dev)
    golden_streams()
    k1_decode = real_size(smi)
    k2 = k2_vs_plain(dev)
    kt = kt_vs_plain(dev)
    small_encodes()
    k1_encode, k2["launches"], kt["launches"] = real_size_encode(smi)
    # K1 runs on both main paths: the decode's and the encode's.
    k1["launches"] = k1_decode + k1_encode
    k1["launches_by_path"] = {"decode": k1_decode, "encode": k1_encode}
    k2["launches_by_path"] = {"encode": k2["launches"]}
    kt["launches_by_path"] = {"encode": kt["launches"]}
    print(json.dumps({"kernels": [k1, k2, kt]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
