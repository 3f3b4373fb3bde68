"""Kernel KM's inputs, bound and time on the card.

Usage: python -m theora_tpu_torch.tools.bench_me

Checks KM (csrc/me.cu, ops/me_cuda.py:plan_with_gold) against its plain
version (ops/me.py:plan_with_gold) on every case of cases(): all 11
outputs equal, exactly. Then times it with CUDA events over 20 calls, L2
flushed before each, on the 1280x720 luma of an encode_clip chunk (8
frames, 7 rows) and of the mesh's 24 frames at gop axis 3 (23 rows),
beside its bound (km_bound) and the plain version. No single PyTorch call
computes the plan, so there is no library time. Needs a CUDA card.
Prints one JSON summary as its last line.
"""
from __future__ import annotations

import json
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


def km_ops(rows: int, h: int, w: int) -> int:
    """Instructions of the ME plan of `rows` rows of h x w luma, byte
    SIMD counted as above: per macroblock two searches and, against prev,
    the 4MV refine, sad_intra (per 4 pixels a sum and a deviation from the
    block mean, one __vsadu4 each) and the candidate SADs; per row the 2x2
    pyramids of cur and both references (3 adds per pyramid pixel), the
    histogram (1 per MB) and the top-16 selection (16 passes over 3,969
    bins, 2 ops each)."""
    n = (h // 16) * (w // 16)

    def two_tap(ad):
        return ad // 4 * HALF_OPS_PER_4

    search = (COARSE_AD // PYR_AD_PER_OP + (FULL_AD + NOMV_AD) // AD_PER_OP
              + two_tap(HALF_AD) + KEYS_MB * KEY_OPS)
    prev_only = (BLOCK_FULL_AD // AD_PER_OP + two_tap(BLOCK_HALF_AD + CAND_AD)
                 + 256 // 4 * 2 + KEYS_4MV * KEY_OPS)
    per_row = (n * (2 * search + prev_only) + 3 * (h * w // 4) * 3 + n
               + 16 * 63 * 63 * 2)
    return rows * per_row


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
    """{label: [F, h, w] uint8} frames built to tie and to saturate the
    search: flat, period-4 stripes and their one-pixel roll, noise and
    noise rolled by (2, -5); noise rolled by (+-20, +-17), which drives
    MB vectors to the +-15 clamp and block vectors to the +-13 one."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w)).astype(np.uint8)
    flat = np.full((h, w), 77, np.uint8)
    stripes = (np.indices((h, w))[1] % 4 * 60).astype(np.uint8)
    ties = [flat, flat, stripes, np.roll(stripes, 1, 1), noise,
            np.roll(noise, (2, -5), (0, 1))]
    sat = [noise] + [np.roll(noise, (sy * 20, sx * 17), (0, 1))
                     for sy in (1, -1) for sx in (1, -1)]
    return {"ties": np.stack(ties), "saturating": np.stack(sat)}


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


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_me: needs a CUDA card", file=sys.stderr)
        return 2
    from theora_tpu_torch.ops import me, me_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    hd = hd720_luma(24)
    err = 0
    for label, ys, gold in cases(dev, hd):
        ok, e = same(me_cuda.plan_with_gold(ys, gold),
                     me.plan_with_gold(ys, gold))
        err = max(err, e)
        print(f"[km] {label}: kernel {'==' if ok else '!='} plain (max "
              f"|err| {e})", flush=True)
        if not ok:
            return 1
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for nf in (KF, 24):
        ys = torch.from_numpy(hd[:nf]).to(dev)
        r = time_case(ys, torch.from_numpy(gop_gold(nf)).to(dev), flush)
        print(f"[km] 720p, {r['rows']} rows: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['ops']} ops at the int32 rate, "
              f"{r['bytes']} B) | {smi}", flush=True)
        rows.append(r)
    print(json.dumps({"card": smi, "iters": ITERS, "max_abs_err": err,
                      "cases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
