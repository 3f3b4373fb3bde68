"""Kernel KM's inputs, bound and time on the card.

Usage: python -m theora_tpu_torch.tools.bench_me [--old-src PATH]

Checks KM (csrc/me.cu, ops/me_cuda.py:plan_with_gold) against its plain
version (ops/me.py:plan_with_gold) on every case of cases(): all 11
outputs equal, exactly. Then times it with CUDA events over 20 calls, L2
flushed before each, on the 1280x720 luma of an encode_clip chunk (8
frames, 7 rows) and of the mesh's 24 frames at gop axis 3 (23 rows),
beside its bound (km_bound) and the plain version, with each of its three
launches timed alone. No single PyTorch call computes the plan, so there
is no library time. simd_rates() measures the issue rates of the byte
SIMD instructions KM is built on (csrc/simd_rate.cu), and km_bound_at()
gives the bound at those rates beside km_bound's.

With --old-src, a me.cu of the same C interface (an earlier design) is
built beside it; its 11 outputs must equal the tree's on every case, and
both are timed in turns, old, new, new, old, at 7 and 23 rows, each
launch alone too. Needs a CUDA card. Prints one JSON summary as its last
line.
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

from theora_tpu_torch.tools.bench_fdct import INT32_OPS_S
from theora_tpu_torch.tools.bench_trellis import HBM_BYTES_S, event_ms

SEED = 20261025
ITERS = 20  # timed calls per reading
KF = 8      # the encoder's keyframe spacing in the 720p cases

# Absolute differences per macroblock and reference of one search (the
# plain version computes every cell of every grid, masked or not): the
# coarse 225 candidates x 64 pyramid pixels, the 25 full-pel cells x 256,
# the 9 half-pel positions x 256, the SAD at offset 0.
COARSE_AD, FULL_AD, HALF_AD, NOMV_AD = 225 * 64, 25 * 256, 9 * 256, 256
# Against prev only: the 4MV refine (4 blocks x (25 full-pel + 9
# half-pel) x 64) and the 16 candidate SADs x 256.
BLOCK_FULL_AD, BLOCK_HALF_AD, CAND_AD = 4 * 25 * 64, 4 * 9 * 64, 16 * 256
# Instructions, each counted at the int32 rate. Hopper's SIMD video
# instructions take the absolute difference of 4 packed bytes and add it
# to an accumulator in one (VABSDIFF4, __vsadu4), of 2 packed 16-bit
# pyramid values (at most 1,020 each) in one (__vsadu2). A two-tap
# prediction of 4 bytes costs one more, the truncating per-byte average
# (__vhaddu4). Each candidate's key is a multiply-add and a minimum (2).
# Should the SIMD forms issue slower than int32 adds, the card's least
# time lies above this bound, never below it.
AD_PER_OP, PYR_AD_PER_OP, HALF_OPS_PER_4, KEY_OPS = 4, 2, 2, 2
KEYS_MB = 225 + 25 + 9           # keyed candidates per search
KEYS_4MV = 4 * (25 + 9)


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


def km_ops(rows: int, h: int, w: int) -> int:
    """Instructions of the ME plan (km_op_mix), all at the int32 rate."""
    return sum(km_op_mix(rows, h, w).values())


def km_bytes(frames: int, h: int, w: int) -> int:
    """Bytes the plan must move: the frames read once, gold_idx read once
    and the 11 int32 outputs written once (per row and MB: mv, gmv and
    2 x 4 bmv components, 6 SADs, 16 candidate SADs; per row 16 candidate
    vectors)."""
    rows, n = frames - 1, (h // 16) * (w // 16)
    return frames * h * w + 8 * rows + 4 * rows * (n * (4 + 8 + 6 + 16)
                                                   + 32)


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


def km_bound_at(ys, rates: dict) -> dict:
    """KM's least time for ys at the issue rates simd_rates() measured:
    each kind of km_op_mix over its own rate (the int32 ops at the
    multiply-add's; a pyramid pair at the best of one __vsadu2, two scalar
    half-selector vabsdiff and one min.u16x2, the form KM takes: sum |a -
    b| = sum a + sum b - 2 sum min(a, b), the sums counted free), against
    km_bytes over the memory rate. Kinds are taken one after another,
    none overlapping another."""
    f, h, w = ys.shape
    mix = km_op_mix(f - 1, h, w)
    pairs = mix.pop("vsadu2")
    ops_s = min(pairs / rates["vsadu2"]["per_s"],
                2 * pairs / rates["vabsdiff_h"]["per_s"],
                pairs / rates["min_u16x2"]["per_s"])
    ops_s += sum(mix[k] / rates[k]["per_s"] for k in mix)
    bytes_ms = km_bytes(f, h, w) / HBM_BYTES_S * 1e3
    return {"ops_ms": ops_s * 1e3, "bound_ms": max(bytes_ms, ops_s * 1e3),
            "bound_by": "bytes" if bytes_ms >= ops_s * 1e3
            else "operations"}


# th_simd_rate's ops, in order: __vsadu4 and __vsadu2 with their
# accumulates, __vhaddu4, the int32 multiply-add, the scalar vabsdiff on
# one 16-bit half, min.u16x2.
SIMD_OPS = ("vsadu4", "vsadu2", "vhaddu4", "int32", "vabsdiff_h",
            "min_u16x2")
SIMD_ITERS = 4096


def simd_build() -> str:
    """Compile csrc/simd_rate.cu into csrc/build/ when missing or older
    than its source; returns the library path."""
    from theora_tpu_torch.ops import me_cuda
    from theora_tpu_torch.ops.cuda_build import nvcc_build

    src = os.path.join(os.path.dirname(me_cuda._SRC), "simd_rate.cu")
    return nvcc_build(src, me_cuda._SO.replace("libtheora_me",
                                               "libtheora_simd_rate"))


def simd_rates(device) -> dict:
    """{op: {"per_sm_clock", "per_s"}}: the issue rates of SIMD_OPS on
    the card (csrc/simd_rate.cu): per SM per clock from the SM clock
    (the median over one CTA per SM), per second from CUDA events over
    the whole launch."""
    lib = ctypes.CDLL(simd_build())
    lib.th_simd_rate.restype = ctypes.c_int
    lib.th_simd_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    ctas = torch.cuda.get_device_properties(device).multi_processor_count
    cycles = torch.empty(ctas, dtype=torch.int64, device=device)
    sink = torch.empty(ctas * 1024, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    for op, name in enumerate(SIMD_OPS):
        def launch():
            err = lib.th_simd_rate(op, SIMD_ITERS, ctas, cycles.data_ptr(),
                                   sink.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"simd_rate {name}: CUDA error {err}")

        launch()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        launch()
        e1.record()
        e1.synchronize()
        ops = 1024 * 8 * SIMD_ITERS
        out[name] = {
            "per_sm_clock": ops / float(cycles.double().median()),
            "per_s": ctas * ops / (e0.elapsed_time(e1) * 1e-3)}
    return out


def gop_gold(frames: int, kf: int = KF) -> np.ndarray:
    """gold_idx of GOP-major frames, a keyframe every kf: each row's
    golden reference is its GOP's first frame (a keyframe row's is
    itself), as encode/gop.py:dispatch_me builds it."""
    return np.array([(f // kf) * kf for f in range(1, frames)], np.int64)


def hd720_luma(n: int) -> np.ndarray:
    """[n, 720, 1280] uint8: the luma of the first n frames of the 720p
    test clip (tools/profile_encode.py:hd720_frames), flipped bottom-up as
    the encoder uploads it."""
    from theora_tpu_torch.tools.profile_encode import hd720_frames

    return np.stack([np.ascontiguousarray(fr[0][::-1])
                     for fr in hd720_frames(n)])


def synthetic(h: int, w: int, seed: int) -> dict:
    """{label: [F, h, w] uint8} frames built to tie, to saturate and to
    reach the packed-byte arithmetic's hazards: flat, period-4 stripes and
    their one-pixel roll, noise and noise rolled by (2, -5); noise rolled
    by (+-20, +-17), which drives MB vectors to the +-15 clamp and block
    vectors to the +-13 one; byte extremes, a 0/255 checkerboard then its
    inverse and an all-0 frame then an all-255 one (MB SADs near 65,280,
    pyramid differences of 1,020); word alignment, noise and its rolls by
    (0, 1), (0, 2), (0, 3), (1, -1), (-2, -2) and (3, -3) in turns, which
    put the vectors and the candidates at every residue of dx mod 4, in
    both directions."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w)).astype(np.uint8)
    flat = np.full((h, w), 77, np.uint8)
    stripes = (np.indices((h, w))[1] % 4 * 60).astype(np.uint8)
    ties = [flat, flat, stripes, np.roll(stripes, 1, 1), noise,
            np.roll(noise, (2, -5), (0, 1))]
    sat = [noise] + [np.roll(noise, (sy * 20, sx * 17), (0, 1))
                     for sy in (1, -1) for sx in (1, -1)]
    checker = (np.indices((h, w)).sum(0) % 2 * 255).astype(np.uint8)
    extremes = [checker, 255 - checker, np.zeros((h, w), np.uint8),
                np.full((h, w), 255, np.uint8)]
    align = [noise]
    for sh in ((0, 1), (0, 2), (0, 3), (1, -1), (-2, -2), (3, -3)):
        align += [np.roll(noise, sh, (0, 1)), noise]
    return {"ties": np.stack(ties), "saturating": np.stack(sat),
            "extremes": np.stack(extremes), "alignment": np.stack(align)}


def cases(device, hd: np.ndarray | None = None):
    """(label, ys, gold_idx) on device: the 720p luma as encode_clip
    chunks it (8 frames, 7 rows, gold the keyframe) and the mesh's 24
    frames at gop axis 3 (one plan call of 23 rows, GOP-major gold; the
    rows whose cur frame is a keyframe are computed too); at 720p, 176x144
    (an odd number of MB rows) and 64x48 (every MB touches an edge) the
    synthetic() frames, gold frame 0 for the first half of the rows and
    frame 2 for the rest. hd: the 24 720p luma frames, if already made."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    hd = hd720_luma(24) if hd is None else hd
    yield f"720p chunk, {KF - 1} rows", t(hd[:KF]), t(gop_gold(KF))
    yield (f"720p mesh batch, {len(hd) - 1} rows", t(hd),
           t(gop_gold(len(hd))))
    for h, w in ((720, 1280), (144, 176), (48, 64)):
        for label, ys in synthetic(h, w, SEED + h).items():
            rows = len(ys) - 1
            gold = np.where(np.arange(rows) < rows // 2, 0, 2)
            yield f"{w}x{h} {label}, {rows} rows", t(ys), t(gold)


def same(got, want) -> tuple[bool, int]:
    """(all 11 outputs equal, the largest |difference|)."""
    err = max(int((g.long() - w.long()).abs().max()) for g, w in
              zip(got, want))
    return all(torch.equal(g, w) for g, w in zip(got, want)), err


def time_case(ys, gold, flush) -> dict:
    """KM's time on (ys, gold) beside its bound and its plain version."""
    from theora_tpu_torch.ops import me, me_cuda

    return {"frames": int(ys.shape[0]), "rows": int(ys.shape[0]) - 1,
            "ms": event_ms(lambda: me_cuda.plan_with_gold(ys, gold), ITERS,
                           flush),
            "plain_ms": event_ms(lambda: me.plan_with_gold(ys, gold), 3,
                                 flush),
            **km_bound(ys)}


def launcher(lib, ys, gold):
    """(launch, outputs): launch() runs the plan's three stages from lib
    (me_cuda.bind) into preallocated outputs, raising on a CUDA error; no
    launch is counted."""
    from theora_tpu_torch.ops import me_cuda

    f, h, w = ys.shape
    out = me_cuda.outputs(f - 1, h // 16, w // 16, ys.device)

    def launch():
        for stage in me_cuda.STAGES:
            err = me_cuda.launch(lib, stage, ys, gold, out)
            if err != 0:
                raise RuntimeError(f"KM {stage}: CUDA error {err}")

    return launch, out


def stage_ms(lib, ys, gold, flush) -> dict:
    """Each of the plan's three launches timed alone (CUDA events, L2
    flushed before each), on the outputs of the earlier ones."""
    from theora_tpu_torch.ops import me_cuda

    full, out = launcher(lib, ys, gold)
    full()
    ms = {}
    for stage in me_cuda.STAGES:
        def one(stage=stage):
            err = me_cuda.launch(lib, stage, ys, gold, out)
            if err != 0:
                raise RuntimeError(f"KM {stage}: CUDA error {err}")

        ms[stage] = event_ms(one, ITERS, flush)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--old-src", default=None,
                    help="an earlier me.cu to check and time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_me: needs a CUDA card", file=sys.stderr)
        return 2
    from theora_tpu_torch.ops import me, me_cuda
    from theora_tpu_torch.ops.cuda_build import nvcc_build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    new = me_cuda.bind(me_cuda.build())
    old = None
    if args.old_src:
        old = me_cuda.bind(nvcc_build(args.old_src, me_cuda._SO.replace(
            ".so", "_old.so")))
        print(f"[old] {args.old_src}", flush=True)
    hd = hd720_luma(24)
    err = 0
    for label, ys, gold in cases(dev, hd):
        got = me_cuda.plan_with_gold(ys, gold)
        ok, e = same(got, me.plan_with_gold(ys, gold))
        err = max(err, e)
        line = f"[km] {label}: kernel {'==' if ok else '!='} plain (max " \
               f"|err| {e})"
        if old is not None:
            run, out = launcher(old, ys, gold)
            run()
            torch.cuda.synchronize()
            ok_old = same(out, got)[0]
            line += f"; old {'==' if ok_old else '!='} new"
            ok = ok and ok_old
        print(line, flush=True)
        if not ok:
            return 1
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rates = simd_rates(dev)
    for name, r in rates.items():
        print(f"[simd] {name}: {r['per_sm_clock']:.2f} per SM per clock, "
              f"{r['per_s'] / 1e12:.3f} T/s | {smi}", flush=True)
    rows = []
    for nf in (KF, 24):
        ys = torch.from_numpy(hd[:nf]).to(dev)
        gold = torch.from_numpy(gop_gold(nf)).to(dev)
        r = time_case(ys, gold, flush)
        r["stages_ms"] = stage_ms(new, ys, gold, flush)
        r["at_measured_rates"] = km_bound_at(ys, rates)
        if old is not None:
            r["old_stages_ms"] = stage_ms(old, ys, gold, flush)
            fns = {"old": launcher(old, ys, gold)[0],
                   "new": launcher(new, ys, gold)[0]}
            for who in ("old", "new", "new", "old"):
                r.setdefault(f"turns_{who}_ms", []).append(
                    event_ms(fns[who], ITERS, flush))
        at = r["at_measured_rates"]
        print(f"[km] 720p, {r['rows']} rows: kernel {r['ms']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in r["stages_ms"].items())
              + f"), plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f}"
              f" ms by {r['bound_by']} ({r['ops']} ops at the int32 rate, "
              f"{r['bytes']} B), {at['bound_ms']:.4f} ms at the measured "
              f"rates; kernel at {100 * r['bound_ms'] / r['ms']:.2f}% / "
              f"{100 * at['bound_ms'] / r['ms']:.2f}% | {smi}", flush=True)
        if old is not None:
            print(f"[km] 720p, {r['rows']} rows, in turns: old "
                  f"{r['turns_old_ms']} ms, new {r['turns_new_ms']} ms; old "
                  "launches " + ", ".join(
                      f"{k} {v:.4f}" for k, v in r["old_stages_ms"].items()),
                  flush=True)
        rows.append(r)
    print(json.dumps({"card": smi, "iters": ITERS, "max_abs_err": err,
                      "simd_rates": rates, "cases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
