"""Kernel KP's cases, bound and time on the card.

Usage: python -m theora_tpu_torch.tools.bench_pp

Holds the postprocessor's kernels (ops/postproc_cuda.py:
postprocess_plane, csrc/postproc.cu) against their plain version
(ops/postproc.py:postprocess_plane, run on the same inputs copied to the
CPU) byte for byte (check), on cases(): random 1280x720 planes (4:2:0
luma and chroma, a 4:2:2 and a 4:4:4 chroma plane) at every pp level's
plane and strength choice (luma: deblock, + dering, + strong dering;
chroma: the same at levels 5, 6, 7), one-row and one-column planes, and
grids whose deblock variances lie on each dering threshold and one either
side of it (threshold_plane); the postprocessed output written into a
row-strided padded plane's image as the decoder hands it over. Then
CUDA-event times over 20 calls, L2 flushed before each, at the 720p luma
and 4:2:0 chroma shapes of a decoded-like frame: the deblock launch, the
dering launch and both, the plain version, a device copy of the same
bytes, beside the bound (kp_bound: the call's own bytes, or the
dering's dependency chain at the measured latency of one pixel update,
measure_step_ns, whichever is longer). Needs a CUDA card. Prints one JSON
summary as its last line.
"""
from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys

import numpy as np
import torch

from theora_tpu_torch.ops import postproc
from theora_tpu_torch.tools.bench_trellis import HBM_BYTES_S, event_ms

SEED = 20261018
TIMED_ITERS = 20
# (label, nv, nh, pli) of the 1280x720 planes.
HD_PLANES = (("720p luma", 90, 160, 0), ("720p 4:2:0 chroma", 45, 80, 1),
             ("720p 4:2:2 chroma", 90, 80, 1),
             ("720p 4:4:4 chroma", 90, 160, 2))
# (dering, strong) of the pp levels that filter a plane: luma at levels
# 2, 3, 4 (and above), chroma at 5, 6, 7.
LEVEL_CHOICES = {0: {2: (False, False), 3: (True, False), 4: (True, True)},
                 1: {5: (False, False), 6: (True, False), 7: (True, True)}}
THRESHOLDS = (postproc.T1, postproc.T2, postproc.T3, postproc.T4)


def pp_tables(qinfo=None) -> tuple[np.ndarray, np.ndarray]:
    """(dc_scale, sharp) [64] int32 of a setup's quant parameters (the
    default ones unless given), as the decoder builds them."""
    from theora_tpu_torch import tables
    from theora_tpu_torch.quant import dequant_tables_init, \
        pp_dc_scale_init, pp_sharp_mod

    q = tables.DEF_QUANT_INFO if qinfo is None else qinfo
    return pp_dc_scale_init(q), pp_sharp_mod(dequant_tables_init(q))


def kp_bytes(h: int, w: int, dering: bool) -> list[int]:
    """Bytes each launch of one call moves, its scratch included: the
    deblock reads the plane, the [nv, nh] DC qi bytes and the [64] int32
    table and writes the deblocked plane (twice when the dering follows:
    its input and the output's unfiltered blocks) and the int32
    variances; the dering reads the deblocked plane, the variances, the qi
    bytes and two tables and writes the output plane."""
    nb = (h >> 3) * (w >> 3)
    out = [(3 if dering else 2) * h * w + nb + 4 * nb + 256]
    if dering:
        out.append(2 * h * w + nb + 4 * nb + 512)
    return out


def call_bytes(h: int, w: int, dering: bool) -> int:
    """Bytes postprocess_plane itself must move: src read and out written
    once, the DC qi grid and the dc_scale table, and with the dering the
    qi grid and the sharp table; nothing that passes between the two
    launches."""
    nb = (h >> 3) * (w >> 3)
    return 2 * h * w + nb + 256 + (nb + 256 if dering else 0)


def kp_bound(h: int, w: int, dering: bool, steps: int = 0,
             step_ns: float = 0.0) -> dict:
    """KP's least time for one call at (h, w): the larger of its bytes
    (call_bytes) over the memory rate and its dependency chain, steps
    pixel updates (dependency_steps of this call's plan) each taking
    step_ns (measure_step_ns). The filter's integer work over the card's
    peak rate lies far below both."""
    nbytes = call_bytes(h, w, dering)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    chain_ms = steps * step_ns * 1e-6
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "chain_steps": steps,
            "step_ns": step_ns, "chain_ms": chain_ms,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "bytes" if bytes_ms >= chain_ms else "operations"}


def critical_path(npass: np.ndarray) -> int:
    """The dering's path in pixel steps in the kernel's block order: the
    longest chain of blocks down and right (the order the kernel's warps
    and their waits impose), each filtered block weighing passes x 15
    anti-diagonal steps."""
    nv, nh = npass.shape
    best = np.zeros(nh + 1, np.int64)
    for by in range(nv):
        for bx in range(nh):
            best[bx + 1] = 15 * int(npass[by, bx]) + max(best[bx],
                                                         best[bx + 1])
    return int(best.max())


def dependency_steps(npass: np.ndarray) -> int:
    """The dering's dependency chain in pixel updates, whatever order a
    kernel takes them in: the longest path through updates that each need
    another's result first. The update of pixel (y, x) in pass p of a
    block needs, from pass p, its N and W pixels (in a block's top row and
    left column the N and W blocks' final pixels, or at the plane's top
    and left edges the replicated border, which is pass p - 1's); and from
    pass p - 1 (its weights, its centre, S and E) the pixel and its four
    neighbours, where the S and E blocks' pixels are pre-dering, ready at
    0, and the plane's bottom and right edges replicate pass p - 1's. An
    unfiltered block's pixels are ready at 0. Blocks on one anti-diagonal
    are taken together."""
    npass = np.asarray(npass)
    nv, nh = npass.shape
    final = np.zeros((8 * nv, 8 * nh), np.int64)
    r8 = np.arange(8)
    for k in range(nv + nh - 1):
        by = np.arange(max(0, k - nh + 1), min(k, nv - 1) + 1)
        bx = k - by
        keep = npass[by, bx] > 0
        by, bx = by[keep], bx[keep]
        if by.size == 0:
            continue
        npb = npass[by, bx]
        top, left = by == 0, bx == 0
        bottom, right = by == nv - 1, bx == nh - 1
        north = np.where(top[:, None], 0, final[
            np.maximum(8 * by - 1, 0)[:, None], 8 * bx[:, None] + r8])
        west = np.where(left[:, None], 0, final[
            8 * by[:, None] + r8, np.maximum(8 * bx - 1, 0)[:, None]])
        prev = np.zeros((by.size, 8, 8), np.int64)
        for p in range(1, int(npb.max()) + 1):
            g = np.zeros((by.size, 10, 10), np.int64)
            g[:, 1:9, 1:9] = prev
            again = p > 1
            g[:, 0, 1:9] = np.where(top[:, None],
                                    prev[:, 0] if again else 0, north)
            g[:, 1:9, 0] = np.where(left[:, None],
                                    prev[:, :, 0] if again else 0, west)
            if again:
                g[:, 9, 1:9] = np.where(bottom[:, None], prev[:, 7], 0)
                g[:, 1:9, 9] = np.where(right[:, None], prev[:, :, 7], 0)
            dep = np.maximum.reduce([
                g[:, 1:9, 1:9], g[:, 0:8, 1:9], g[:, 2:10, 1:9],
                g[:, 1:9, 0:8], g[:, 1:9, 2:10]])
            # t[:, y + 1, x + 1]: pass p's pixel (y, x); row and column 0
            # hold the N and W borders of the top row and left column.
            t = np.zeros((by.size, 9, 9), np.int64)
            t[:, 0, 1:] = g[:, 0, 1:9]
            t[:, 1:, 0] = g[:, 1:9, 0]
            for d in range(15):
                ys = np.arange(max(0, d - 7), min(d, 7) + 1)
                xs = d - ys
                t[:, ys + 1, xs + 1] = 1 + np.maximum(
                    dep[:, ys, xs], np.maximum(t[:, ys, xs + 1],
                                               t[:, ys + 1, xs]))
            prev = np.where((npb >= p)[:, None, None], t[:, 1:, 1:], prev)
        final[8 * by[:, None, None] + r8[:, None],
              8 * bx[:, None, None] + r8] = prev
    return int(final.max())


def wavefront(args) -> dict:
    """The dering plan of one call's arguments on the CPU: blocks by
    passes, the longest chain of filtered neighbours (the plain version's
    waves), the path in the kernel's block order and the dependency
    chain."""
    src, dcq, _, scale, _, dering, strong, pli = cpu_args(args)[:8]
    _, var = postproc.deblock_plane(src, dcq, scale)
    npass, _ = postproc.dering_plan(var, strong, pli)
    npass = npass.numpy() if dering else np.zeros_like(npass.numpy())
    waves = postproc.dering_waves(npass)
    return {"blocks": int(npass.size), "one_pass": int((npass == 1).sum()),
            "three_pass": int((npass == 3).sum()),
            "longest_chain": int(waves.max()) + 1,
            "block_order_steps": critical_path(npass),
            "dependency_steps": dependency_steps(npass)}


def threshold_plane(targets: np.ndarray) -> np.ndarray:
    """A plane whose deblock variances equal targets [nv, nh] when no
    boundary filters (DC scale 0): in each block row r of pixel row y the
    columns step by a at column 3 (counted by the boundary on the left) and
    by b at column 5 (by the one on the right), so the block's sum is
    sum(a + b) over its rows; a block at the left or right edge has one
    boundary only. With nv > 1 the rows of a block row band are equal (the
    horizontal boundaries then see no activity), so targets must be
    multiples of 8 there; a one-row plane takes any target."""
    nv, nh = targets.shape
    plane = np.zeros((8 * nv, 8 * nh), np.uint8)
    for by in range(nv):
        for bx in range(nh):
            t = int(targets[by, bx])
            if nv > 1 and t % 8:
                raise ValueError("targets must be multiples of 8 when nv > 1")
            sides = (bx > 0) + (bx < nh - 1)
            if t > 8 * 255 * sides:
                raise ValueError(f"target {t} out of reach at {bx}")
            for r in range(8):
                v = t // 8 + (r < t % 8)
                a = min(v, 255) if bx > 0 else 0
                b = v - a
                row = np.zeros(8, np.int32)
                row[3:] = a
                row[5:] = a - b if bx > 0 else b
                plane[8 * by + r, 8 * bx:8 * bx + 8] = row
    return plane


def _threshold_targets(rng, nv: int, nh: int) -> np.ndarray:
    step = 1 if nv == 1 else 8
    vals = [t + d for t in THRESHOLDS for d in (-step, 0, step)]
    out = np.zeros((nv, nh), np.int64)
    for by in range(nv):
        for bx in range(nh):
            sides = (bx > 0) + (bx < nh - 1)
            ok = [v for v in vals if v <= 8 * 255 * sides] or [0]
            out[by, bx] = ok[rng.integers(len(ok))]
    return out


def _args(src, dcq, qi, tabs, dering, strong, pli, device):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(src), t(dcq.astype(np.uint8)), t(qi.astype(np.uint8)),
            t(tabs[0].astype(np.int32)), t(tabs[1].astype(np.int32)),
            dering, strong, pli)


def cases(device, seed: int = SEED) -> list:
    """[(label, args)]: postprocess_plane's arguments on the device."""
    rng = np.random.default_rng(seed)
    default = pp_tables()
    out = []

    def add(label, src, dering, strong, pli, tabs=default, qlo=0):
        nv, nh = src.shape[0] >> 3, src.shape[1] >> 3
        dcq = rng.integers(qlo, 64, (nv, nh))
        qi = rng.integers(qlo, 64, (nv, nh))
        out.append((label, _args(src, dcq, qi, tabs, dering, strong, pli,
                                 device)))

    for label, nv, nh, pli in HD_PLANES:
        kind = min(pli, 1)
        noisy = rng.integers(0, 256, (8 * nv, 8 * nh))
        low = (rng.integers(0, 24, (8 * nv, 8 * nh))
               + np.repeat(np.repeat(rng.integers(0, 200, (nv, nh)), 8, 0),
                           8, 1))
        choices = LEVEL_CHOICES[kind]
        if label in ("720p 4:2:2 chroma", "720p 4:4:4 chroma"):
            choices = {7: choices[7], 5: choices[5]}
        for lvl, (dering, strong) in choices.items():
            src = (noisy if lvl % 2 else low).astype(np.uint8)
            add(f"{label}, level {lvl}", src, dering, strong, pli)
    for nv, nh in ((1, 160), (90, 1), (1, 1), (2, 3)):
        for pli, (lvl, (dering, strong)) in ((0, (4, LEVEL_CHOICES[0][4])),
                                             (1, (7, LEVEL_CHOICES[1][7]))):
            src = rng.integers(0, 256, (8 * nv, 8 * nh)).astype(np.uint8)
            add(f"{nv}x{nh} blocks, pli {pli}, level {lvl}", src, dering,
                strong, pli)
    # Variances on each threshold and one (one-row) or eight either side,
    # no boundary filtered (DC scale 0 at qi 0), dering strengths from qi
    # 1..63; random tables with large sharpening weights too.
    zero0 = (np.concatenate([[0], default[0][1:]]), default[1])
    rough = (np.concatenate([[0], rng.integers(1, 400, 63)]),
             -rng.integers(0, 800, 64))
    grids = [((1, 40), pli, strong, tabs) for pli in (0, 1)
             for strong in (False, True) for tabs in (zero0, rough)]
    grids += [((6, 12), *g[1:]) for g in grids]
    grids += [((45, 80), 0, True, rough), ((45, 80), 1, True, zero0)]
    for (nv, nh), pli, strong, tabs in grids:
        src = threshold_plane(_threshold_targets(rng, nv, nh))
        out.append((f"thresholds {nv}x{nh}, pli {pli}, strong {strong}",
                    _args(src, np.zeros((nv, nh)),
                          rng.integers(1, 64, (nv, nh)), tabs, True, strong,
                          pli, device)))
    return out


def cpu_args(args) -> tuple:
    return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)


def plain(args) -> torch.Tensor:
    """The plain version on the same inputs, on the CPU."""
    return postproc.postprocess_plane(*cpu_args(args))


def padded_view(src: torch.Tensor, pad: int = 16) -> torch.Tensor:
    """src as the decoder hands it over: the image of a padded plane (a
    row-strided view)."""
    h, w = src.shape
    big = torch.full((h + 2 * pad, w + 2 * pad), 77, dtype=torch.uint8,
                     device=src.device)
    big[pad:pad + h, pad:pad + w] = src
    return big[pad:pad + h, pad:pad + w]


def plain_all(args_list: list, workers: int = 8) -> list:
    """The plain version of every call, on the CPU in up to workers spawned
    processes of one torch thread each (the dering's wave loop is host
    bound: small ops, and the 720p cases take seconds each)."""
    cpu = [cpu_args(a) for a in args_list]
    n = max(1, min(workers, os.cpu_count() or 1, len(cpu)))
    with concurrent.futures.ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("spawn"),
            initializer=torch.set_num_threads, initargs=(1,)) as ex:
        return list(ex.map(plain, cpu))


def check(device, todo=None, wants=None) -> tuple[int, int]:
    """Every (label, args) of todo (by default cases()) through the
    kernel, contiguous and as a padded plane's view into a strided output,
    against the plain version (wants, computed here unless given) byte for
    byte; the inputs left as they were. Returns (cases, max |err|)."""
    from theora_tpu_torch.ops import postproc_cuda

    n = 0
    todo = cases(device) if todo is None else todo
    if wants is None:
        wants = plain_all([args for _, args in todo])
    for (label, args), want in zip(todo, wants):
        before = [a.clone() for a in args[:5]]
        launches = postproc_cuda.postprocess_plane.launches
        got = postproc_cuda.postprocess_plane(*args)
        h, w = args[0].shape
        out = torch.zeros((h + 8, w + 24), dtype=torch.uint8, device=device)
        got2 = postproc_cuda.postprocess_plane(
            padded_view(args[0]), *args[1:], out=out[4:4 + h, 8:8 + w])
        torch.cuda.synchronize()
        nl = postproc_cuda.postprocess_plane.launches - launches
        if nl != 2 * (1 + bool(args[5])):
            raise AssertionError(f"{label}: {nl} launches for two calls")
        for what, g in (("contiguous", got), ("padded view", got2)):
            if not torch.equal(g.cpu(), want):
                bad = (g.cpu() != want).nonzero()[:4].tolist()
                raise AssertionError(f"KP != plain, {label}, {what}: {bad}")
        if out[:4].any() or out[4 + h:].any() or out[:, :8].any() \
                or out[:, 8 + w:].any():
            raise AssertionError(f"{label}: KP wrote outside its output")
        for a, b in zip(args[:5], before):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: KP changed an input")
        n += 1
    return n, 0


def gen_frames(nframes: int = 1):
    """The first nframes of the JAX package's 720p benchmark clip (a copy
    of bench.py:gen_frames: a detailed static scene, three textured
    movers, a film-grain panel refreshed every frame, mostly static
    chroma with coloured movers), as [(y, u, v)] uint8 4:2:0 planes."""
    W, H = 1280, 720
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:H, 0:W]
    tex = rng.randint(-40, 41, size=(H, W)).astype(np.int32)
    bg = (
        128
        + 50 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
        + 30 * np.sin((xx + 2 * yy) / 61.0)
        + tex * 0.5
    ).clip(0, 255).astype(np.uint8)
    movers = [
        (rng.randint(0, 256, size=(96, 128)).astype(np.uint8), 9, 2, 60, 40),
        (rng.randint(0, 256, size=(64, 64)).astype(np.uint8), -5, 4, 400, 900),
        ((128 + 90 * np.sin(np.arange(80)[:, None] / 3.0)).astype(np.uint8)
         * np.ones((1, 112), np.uint8), 3, -3, 520, 300),
    ]
    ug = (128 + 40 * np.sin(xx[::2, ::2] / 37.0)).astype(np.uint8)
    vg = (128 + 40 * np.cos(yy[::2, ::2] / 29.0)).astype(np.uint8)
    frames = []
    for t in range(nframes):
        y = bg.copy()
        u = ug.copy()
        v = vg.copy()
        for mi, (patch, dx, dy, x0, y0) in enumerate(movers):
            ph, pw = patch.shape
            py = (y0 + dy * t) % (H - ph)
            px = (x0 + dx * t) % (W - pw)
            y[py:py + ph, px:px + pw] = patch
            u[py // 2:(py + ph) // 2, px // 2:(px + pw) // 2] = 80 + 50 * mi
            v[py // 2:(py + ph) // 2, px // 2:(px + pw) // 2] = 190 - 40 * mi
        y[H - 256:, W - 256:] = rng.randint(0, 256, size=(256, 256)).astype(
            np.uint8)
        frames.append((y, u, v))
    return frames


def measure_step_ns(device, steps: int = 1 << 16, reps: int = 5) -> float:
    """One dering pixel update's latency on the card, in ns: the CUDA-event
    time of th_pp_step_probe (csrc/postproc.cu: the dering's own update,
    kp_pixel, on two pixels that are each other's N and W, in registers)
    at 2 x steps updates less that at steps, the least of reps each, over
    steps, so that the launch drops out."""
    from theora_tpu_torch.ops import postproc_cuda

    lib = postproc_cuda._load()
    inp = torch.tensor([3, 200, 17, 250, 90, 9, 7, 11, 5], dtype=torch.int32,
                       device=device)
    res = torch.empty(2, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run(n):
        err = lib.th_pp_step_probe(inp.data_ptr(), res.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"KP step probe launch failed: CUDA error "
                               f"{err}")

    run(steps)
    t = {n: min(once_ms(lambda: run(n)) for _ in range(reps))
         for n in (steps, 2 * steps)}
    return (t[2 * steps] - t[steps]) * 1e6 / steps


def time_call(args, flush, step_ns: float) -> dict:
    """CUDA-event times of one call's launches: the deblock alone (the
    call at dering off), the dering launch alone (its counters zeroed in
    the same timed span, as the deblock launch zeroes them), both (the
    call), the plain version on the card (one call: it takes seconds) and
    a device copy of the plane; beside kp_bound, whose dependency chain is
    this call's (wavefront) at step_ns per update, and the bytes each
    launch moves (kp_bytes)."""
    from theora_tpu_torch.ops import postproc_cuda

    src, dcq, qi, scale, sharp, dering, strong, pli = args
    h, w = src.shape
    nv, nh = h >> 3, w >> 3
    wf = wavefront(args)
    launches = postproc_cuda.postprocess_plane.launches
    out = torch.empty_like(src)
    row = {"deblock_ms": event_ms(
        lambda: postproc_cuda.postprocess_plane(
            src, dcq, qi, scale, sharp, False, strong, pli, out=out),
        TIMED_ITERS, flush)}
    row["deblock_bound"] = kp_bound(h, w, False)
    row["launch_bytes"] = kp_bytes(h, w, dering)
    if dering:
        # The dering launch on the deblock's own scratch.
        lib = postproc_cuda._load()
        stream = torch.cuda.current_stream(src.device).cuda_stream
        var = torch.empty((nv, nh), dtype=torch.int32, device=src.device)
        counters = torch.zeros(1 + nv, dtype=torch.int32, device=src.device)
        deb = torch.empty_like(src)
        lib.th_pp_deblock(src.data_ptr(), src.stride(0), deb.data_ptr(), w,
                          out.data_ptr(), w, dcq.data_ptr(),
                          scale.data_ptr(), var.data_ptr(),
                          counters.data_ptr(), h, w, stream)

        def dering_launch():
            counters.zero_()
            lib.th_pp_dering(deb.data_ptr(), w, out.data_ptr(), w,
                             var.data_ptr(), qi.data_ptr(), scale.data_ptr(),
                             sharp.data_ptr(), counters.data_ptr(), nv, nh,
                             int(strong), pli, stream)

        row["dering_ms"] = event_ms(dering_launch, TIMED_ITERS, flush)
    row["ms"] = event_ms(lambda: postproc_cuda.postprocess_plane(
        src, dcq, qi, scale, sharp, dering, strong, pli, out=out),
        TIMED_ITERS, flush)
    row.update(kp_bound(h, w, dering, wf["dependency_steps"], step_ns))
    row["wavefront"] = wf
    row["plain_ms"] = once_ms(lambda: postproc.postprocess_plane(*args))
    row["copy_ms"] = event_ms(lambda: out.copy_(src), TIMED_ITERS, flush)
    postproc_cuda.postprocess_plane.launches = launches
    return row


def once_ms(fn) -> float:
    """CUDA-event time of one call of fn."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def describe(label: str, r: dict) -> str:
    s = (f"{label}: deblock {r['deblock_ms']:.4f} ms (bound "
         f"{r['deblock_bound']['bound_ms']:.4f}, by bytes)")
    if "dering_ms" in r:
        s += f", dering {r['dering_ms']:.4f} ms (the counters' reset included)"
    return (s + f", the call {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']} (the call's {r['bytes']} B -> "
            f"{r['bytes_ms']:.4f} ms; the dependency chain "
            f"{r['chain_steps']} updates x {r['step_ns']:.2f} ns -> "
            f"{r['chain_ms']:.4f} ms), the call at "
            f"{100 * r['bound_ms'] / r['ms']:.2f}% of it; bytes per launch "
            f"{r['launch_bytes']}; plain {r['plain_ms']:.4f} ms, device copy "
            f"of the plane {r['copy_ms']:.4f} ms; no single PyTorch call "
            f"computes the filter (library_ms null); dering plan "
            f"{r['wavefront']}")


def frame_calls(frame, device, qi: int = 5) -> dict:
    """{label: args} of a display-orientation 4:2:0 frame's luma and Cb
    planes, flipped to bitstream orientation, at pp level 7 with every
    block's DC qi and qi at qi (the default tables)."""
    tabs = pp_tables()
    out = {}
    for label, plane, pli in (("720p luma", frame[0], 0),
                              ("720p 4:2:0 chroma", frame[1], 1)):
        p = np.ascontiguousarray(plane[::-1])
        nv, nh = p.shape[0] >> 3, p.shape[1] >> 3
        q = np.full((nv, nh), qi)
        out[label] = _args(p, q, q, tabs, True, True, pli, device)
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_pp: needs a CUDA card", file=sys.stderr)
        return 2
    from theora_tpu_torch.ops import postproc_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with open(postproc_cuda.build() + ".log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[kp] ptxas: {line.strip()}", flush=True)
    n, err = check(dev)
    print(f"[kp] {n} cases: kernel == plain byte for byte | {smi}",
          flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    step = measure_step_ns(dev)
    print(f"[kp] one dering pixel update on the chain: {step:.3f} ns | "
          f"{smi}", flush=True)
    rows = {}
    for label, args in frame_calls(gen_frames(1)[0], dev).items():
        rows[label] = time_call(args, flush, step)
        print(f"[kp] {describe(label, rows[label])} | {smi}", flush=True)
    print(json.dumps({"card": smi, "cases": n, "step_ns": step,
                      "timed": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
