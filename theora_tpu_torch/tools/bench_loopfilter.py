"""Kernel KL's cases, bound and time on the card.

Usage: python -m theora_tpu_torch.tools.bench_loopfilter

Holds the loop filter's kernel (ops/loopfilter_cuda.py:loop_filter_plane,
csrc/loopfilter.cu) against its plain version (ops/loopfilter.py:
loop_filter_plane) byte for byte, one launch per call and the input
untouched (check), on cases(): the 1280x720 planes (4:2:0
luma and chroma, a 4:2:2 and a 4:4:4 chroma plane), a one-row and a
one-column grid, limits 1, 2, 15 (the default table's largest) and 63,
coded densities 0, 0.3, 0.6 and 1 and patterns built to reach the corner
writes (vE and vL on neighbouring columns, single coded blocks at the
four corners, a checkerboard), 0/255 pixels, and three planes in one
launch with limits [5, 0, 31]. Then times with CUDA events over 50
launches, L2 flushed before each, at the 720p shapes (each plane, and a
frame's three planes as the decode step launches them), the pixels
low-contrast noise and 60% of the blocks coded: the kernel, its plain
version, a device copy of the same bytes, beside its bound (kl_bound).
Needs a CUDA card. Prints one JSON summary as its last line.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from theora_tpu_torch.tools.bench_fdct import INT32_OPS_S
from theora_tpu_torch.tools.bench_trellis import HBM_BYTES_S, ITERS, event_ms

SEED = 20261017
# int32 operations per pixel line of a filtered edge: f = p0 - p3 +
# 3 (p2 - p1) (3), the response (+4, >> 3, |R|, L2 - |R|, min, max, the
# sign: 8), the two outputs with their clamps (6).
OPS_PER_LINE = 17
# (label, nv, nh, pad_y, pad_x) of the 1280x720 planes.
HD_PLANES = (("720p luma", 90, 160, 16, 16), ("720p 4:2:0 chroma", 45, 80,
                                                8, 8))
HD_422 = ("720p 4:2:2 chroma", 90, 80, 16, 8)
HD_444 = ("720p 4:4:4 chroma", 90, 160, 16, 16)
LIMITS = (1, 2, 15, 63)


def plane_shape(nv: int, nh: int, pad_y: int, pad_x: int) -> tuple:
    return 8 * nv + 2 * pad_y, 8 * nh + 2 * pad_x


def kl_edges(coded: np.ndarray) -> int:
    """Edges the filter applies for coded [..., nv, nh]: an h edge where
    either block beside it is coded, a v edge where either block above
    or below it is (libtheora filters each once)."""
    c = np.asarray(coded, bool)
    return int((c[..., :, 1:] | c[..., :, :-1]).sum()
               + (c[..., 1:, :] | c[..., :-1, :]).sum())


def kl_bound(args) -> dict:
    """KL's least time for one call's arguments (plane, coded, limit, nv,
    nh, pad_y, pad_x), as the wrapper takes them: every plane read once
    and written once, the coded flags and a limit tensor read once, over
    the memory rate; OPS_PER_LINE int32 operations per pixel line of the
    edges this call's coded flags fire in the planes whose limit is above
    0 (kl_edges), over the int32 rate. The larger binds. Copies coded
    and a limit tensor to the host."""
    plane, coded, limit = args[:3]
    nbytes = 2 * plane.numel() + coded.numel()
    c = coded.cpu().numpy().reshape((-1,) + tuple(coded.shape[-2:]))
    if isinstance(limit, torch.Tensor):
        nbytes += 4 * limit.numel()
        live = limit.cpu().numpy().reshape(-1) > 0
    else:
        live = np.array([int(limit) > 0])
    ops = OPS_PER_LINE * 8 * kl_edges(c[live])
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / INT32_OPS_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def patterns(nv: int, nh: int, rng) -> dict:
    """Coded-flag patterns [nv, nh] bool: the densities, and the ones
    built to reach the corner writes of the edge order."""
    r, c = np.meshgrid(np.arange(nv), np.arange(nh), indexing="ij")
    out = {f"density {d}": rng.random((nv, nh)) < d for d in (0.3, 0.6)}
    out["density 0"] = np.zeros((nv, nh), bool)
    out["density 1"] = np.ones((nv, nh), bool)
    out["checkerboard"] = (r + c) % 2 == 0
    # A vE (coded above, uncoded below) beside a vL (uncoded above, coded
    # below) at every fragment-row boundary, in pairs of columns.
    out["vE beside vL"] = (c // 2 + r) % 2 == 0
    out["stairs"] = c >= r
    corners = np.zeros((nv, nh), bool)
    for y, x in ((0, 0), (0, nh - 1), (nv - 1, 0), (nv - 1, nh - 1)):
        one = np.zeros((nv, nh), bool)
        one[y, x] = True
        out[f"one block at ({y}, {x})"] = one
        corners[y, x] = True
    out["four corners"] = corners
    return out


def pixels(rng, shape, kind: str) -> np.ndarray:
    """uint8 pixels: "noise" uniform, "low contrast" noise of +-12 around a
    level (most edges then filter), "0/255" the byte extremes."""
    if kind == "noise":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "0/255":
        return rng.choice(np.array([0, 255], np.uint8), shape)
    level = rng.integers(13, 243, shape[:-2] + (1, 1))
    return (level + rng.integers(-12, 13, shape)).astype(np.uint8)


def one_plane(rng, nv, nh, pad_y, pad_x, coded, limit, kind, device):
    """The wrapper's 2-D form: (plane, coded, limit, nv, nh, pad_y,
    pad_x) with limit an int."""
    shape = plane_shape(nv, nh, pad_y, pad_x)
    return (torch.from_numpy(pixels(rng, shape, kind)).to(device),
            torch.from_numpy(coded).to(device), int(limit), nv, nh, pad_y,
            pad_x)


def stack(rng, nv, nh, pad_y, pad_x, coded, limits, kind, device):
    """The wrapper's [G, Hp, Wp] form, coded [G, nv, nh], limits a [G]
    int32 tensor."""
    g = len(limits)
    shape = (g,) + plane_shape(nv, nh, pad_y, pad_x)
    return (torch.from_numpy(pixels(rng, shape, kind)).to(device),
            torch.from_numpy(np.ascontiguousarray(coded)).to(device),
            torch.tensor(limits, dtype=torch.int32, device=device), nv, nh,
            pad_y, pad_x)


def cases(device, seed: int = SEED):
    """(label, args) for the wrapper: every pattern at every limit on the
    720p luma and chroma planes, the 4:2:2 and 4:4:4 chroma planes, a
    one-row (nv = 1) and a one-column (nh = 1) grid, over the three pixel
    kinds in turn; three planes in one launch with limits [5, 0, 31]."""
    rng = np.random.default_rng(seed)
    kinds = ("low contrast", "noise", "0/255")
    shapes = HD_PLANES + (HD_422, HD_444, ("one row", 1, 37, 8, 8),
                          ("one column", 23, 1, 16, 8))
    i = 0
    for label, nv, nh, py, px in shapes:
        for name, coded in patterns(nv, nh, rng).items():
            for limit in LIMITS:
                kind = kinds[i % len(kinds)]
                i += 1
                yield (f"{label}, {name}, limit {limit}, {kind}",
                       one_plane(rng, nv, nh, py, px, coded, limit, kind,
                                 device))
    label, nv, nh, py, px = HD_PLANES[1]
    for kind in kinds:
        coded = np.stack([patterns(nv, nh, rng)[k] for k in (
            "density 0.6", "checkerboard", "vE beside vL")])
        yield (f"3 x {label} in one launch, limits [5, 0, 31], {kind}",
               stack(rng, nv, nh, py, px, coded, [5, 0, 31], kind, device))


def check(device) -> tuple[int, int]:
    """The kernel against its plain version on every case of cases(), one
    launch per call, byte for byte, the input left as it was; raises on
    a difference. Returns (cases, largest |difference|)."""
    from theora_tpu_torch.ops import loopfilter, loopfilter_cuda

    n = err = 0
    for label, args in cases(device):
        before = args[0].clone()
        launches = loopfilter_cuda.loop_filter_plane.launches
        got = loopfilter_cuda.loop_filter_plane(*args)
        want = loopfilter.loop_filter_plane(*args)
        torch.cuda.synchronize()
        err = max(err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:4].tolist()
            raise AssertionError(f"KL != plain on {label}: at {bad}")
        if not torch.equal(args[0], before):
            raise AssertionError(f"KL wrote its input on {label}")
        if loopfilter_cuda.loop_filter_plane.launches != launches + 1:
            raise AssertionError(f"KL did not launch once on {label}")
        n += 1
    return n, err


def frame_args(device, seed: int = SEED, limit: int = 15) -> list:
    """The three 1280x720 4:2:0 planes of one frame as the decode step
    filters them (low-contrast pixels, 60% of the blocks coded)."""
    rng = np.random.default_rng(seed)
    out = []
    for _, nv, nh, py, px in (HD_PLANES[0], HD_PLANES[1], HD_PLANES[1]):
        coded = rng.random((nv, nh)) < 0.6
        out.append(one_plane(rng, nv, nh, py, px, coded, limit,
                             "low contrast", device))
    return out


def time_calls(calls: list, flush) -> dict:
    """CUDA-event times of the kernel, the plain version and a device copy
    of the same bytes over the calls (each a wrapper's argument tuple),
    all calls in one timed span, beside the summed bound."""
    from theora_tpu_torch.ops import loopfilter, loopfilter_cuda

    outs = [torch.empty_like(a[0]) for a in calls]
    launches = loopfilter_cuda.loop_filter_plane.launches

    def kernel():
        for a in calls:
            loopfilter_cuda.loop_filter_plane(*a)

    def plain():
        for a in calls:
            loopfilter.loop_filter_plane(*a)

    def copy():
        for a, o in zip(calls, outs):
            o.copy_(a[0])

    bounds = [kl_bound(a) for a in calls]
    row = {"ms": event_ms(kernel, ITERS, flush),
           "plain_ms": event_ms(plain, 3, flush),
           "copy_ms": event_ms(copy, ITERS, flush)}
    loopfilter_cuda.loop_filter_plane.launches = launches
    for key in ("bytes", "bytes_ms", "ops", "ops_ms", "bound_ms"):
        row[key] = sum(b[key] for b in bounds)
    row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] \
        else "operations"
    return row


def timed_shapes(device, flush) -> dict:
    """{label: time_calls row} at the 720p shapes: luma, a 4:2:0 chroma
    plane, and a frame's three planes (three launches)."""
    frame = frame_args(device)
    return {"720p luma": time_calls(frame[:1], flush),
            "720p 4:2:0 chroma": time_calls(frame[1:2], flush),
            "720p frame (3 launches)": time_calls(frame, flush)}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_loopfilter: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    n, _ = check(dev)
    print(f"[kl] {n} cases: kernel == plain byte for byte | {smi}",
          flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = timed_shapes(dev, flush)
    for label, r in rows.items():
        print(f"[kl] {label}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, device copy of the same bytes "
              f"{r['copy_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['bytes']} B -> {r['bytes_ms']:.4f} ms, "
              f"{r['ops']} int32 ops -> {r['ops_ms']:.4f} ms); kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.2f}% of it | {smi}",
              flush=True)
    print(json.dumps({"card": smi, "cases": n, "timed": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
