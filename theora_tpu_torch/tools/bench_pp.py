"""Kernel KP's cases, bound and time on the card.

Usage: python -m theora_tpu_torch.tools.bench_pp

Holds the postprocessor's kernels (ops/postproc_cuda.py, csrc/
postproc.cu: postprocess_plane, one frame, and postprocess_frames, a
plane's frames of a batch in two launches) against their plain version
(ops/postproc.py:postprocess_plane, run on the same inputs copied to the
CPU) byte for byte (check), on cases(): random 1280x720 planes (4:2:0
luma and chroma, a 4:2:2 and a 4:4:4 chroma plane) at every pp level's
plane and strength choice (luma: deblock, + dering, + strong dering;
chroma: the same at levels 5, 6, 7), one-row and one-column planes, and
grids whose deblock variances lie on each dering threshold and one either
side of it (threshold_plane); the postprocessed output written into a
row-strided padded plane's image as the decoder hands it over; and on
frame_cases(): batches of 1, 3 and 8 frames mixing dering off, on and
strong, a frame without pp between postprocessed ones, padded planes'
views as sources, 720p luma and 4:2:0, 4:2:2, 4:4:4 chroma. Prints each
kernel's ptxas report (registers, shared memory, spills), the tree's and
the earlier design's (tools/kp_block_serial.cu, parent_kernel). Then
CUDA-event times over 20 calls, L2 flushed before each, in turns with the
earlier design, at the 720p luma and 4:2:0 chroma shapes of a raw frame
(gen_frames) at pp 7, qi 5: the deblock launch, the dering launch and
both; the plain version, a device copy of the same bytes and the call's
empty launches, beside the bound (kp_bound: the call's own bytes, or the
dering's dependency chain at the measured latency of one pixel update,
measure_step_ns, whichever is longer); and an 8-frame luma batch through
postprocess_frames, postprocess_plane frame by frame and the earlier
design, beside kp_bound_batch. Needs a CUDA card. Prints one JSON
summary as its last line.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import multiprocessing
import os
import re
import subprocess
import sys

import numpy as np
import torch

from theora_tpu_torch.ops import postproc
from theora_tpu_torch.tools.bench_trellis import HBM_BYTES_S, event_ms

SEED = 20261018
# KP's earlier design (one frame per call), the yardstick of its redesign.
PARENT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "kp_block_serial.cu")
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


def kp_bound_batch(h: int, w: int, derings: list, steps: list,
                   step_ns: float) -> dict:
    """KP's least time for one batch call over frames of one plane at
    (h, w): the larger of all frames' own bytes (call_bytes of each, by
    its dering flag) over the memory rate and the longest frame's
    dependency chain (steps per frame, dependency_steps) at step_ns per
    update: the frames' chains run side by side."""
    nbytes = sum(call_bytes(h, w, d) for d in derings)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    chain = max(steps) if steps else 0
    chain_ms = chain * step_ns * 1e-6
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "chain_steps": chain,
            "step_ns": step_ns, "chain_ms": chain_ms,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "bytes" if bytes_ms >= chain_ms else "operations"}


def frames_bound(args, step_ns: float | None = None) -> dict:
    """kp_bound_batch of one postprocess_frames call's arguments: each
    frame's dependency chain from its plan on the CPU, at step_ns per
    update (by default measure_step_ns on the call's device, once)."""
    srcs, frames, _, ppq, scale, sharp, dering, strong, pli = args
    if step_ns is None:
        if not hasattr(frames_bound, "step_ns"):
            frames_bound.step_ns = measure_step_ns(srcs[0].device)
        step_ns = frames_bound.step_ns
    steps = [wavefront((src, ppq[f, 0], ppq[f, 1], scale, sharp, d, s, pli))[
        "dependency_steps"] for src, f, d, s in zip(srcs, frames, dering,
                                                    strong)]
    h, w = srcs[0].shape
    return kp_bound_batch(h, w, list(dering), steps, step_ns)


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


def frame_cases(device, seed: int = SEED) -> list:
    """[(label, case)]: postprocess_frames' arguments on the device, case
    a dict of srcs (padded planes' images, row-strided views), frames (the
    indices into out), F, ppq [F, 2, nv, nh], tabs, dering, strong, pli:
    F = 1, 3 and 8; frames mixing dering off, on and strong; a frame of
    out without pp between postprocessed ones; 720p luma and 4:2:0, 4:2:2
    and 4:4:4 chroma planes. Noisy planes dering most blocks, so rows wait
    on filtered blocks above them (north_waits counts those blocks)."""
    rng = np.random.default_rng(seed + 1)
    default = pp_tables()
    mix = ((False, False), (True, False), (True, True))
    shapes = {0: (90, 160), 1: (45, 80), "4:2:2": (90, 80),
              "4:4:4": (90, 160)}
    out = []

    def add(label, shape, pli, F, frames, flags):
        nv, nh = shape
        srcs = []
        for k, _ in enumerate(frames):
            if k % 2:
                a = rng.integers(0, 256, (8 * nv, 8 * nh))
            else:
                a = (rng.integers(0, 24, (8 * nv, 8 * nh))
                     + np.repeat(np.repeat(rng.integers(0, 200, (nv, nh)),
                                           8, 0), 8, 1))
            srcs.append(padded_view(torch.from_numpy(
                a.astype(np.uint8)).to(device)))
        ppq = rng.integers(0, 64, (F, 2, nv, nh)).astype(np.uint8)
        out.append((label, {
            "srcs": srcs, "frames": list(frames), "F": F,
            "ppq": torch.from_numpy(ppq).to(device),
            "tabs": tuple(torch.from_numpy(t.astype(np.int32)).to(device)
                          for t in default),
            "dering": [d for d, _ in flags], "strong": [s for _, s in flags],
            "pli": pli}))

    add("F 1, 720p luma, strong dering", shapes[0], 0, 1, [0], [mix[2]])
    add("F 3, 720p luma, off / on / strong", shapes[0], 0, 3, [0, 1, 2],
        mix)
    add("F 3, 720p luma, frame 1 without pp", shapes[0], 0, 3, [2, 0],
        [mix[2], mix[1]])
    add("F 8, 720p 4:2:0 chroma, mixed, frame 5 without pp", shapes[1], 1,
        8, [0, 1, 2, 3, 4, 6, 7],
        [mix[k % 3] for k in (2, 0, 1, 2, 2, 1, 2)])
    add("F 3, 720p 4:2:2 chroma, strong / off / on", shapes["4:2:2"], 1, 3,
        [0, 1, 2], [mix[2], mix[0], mix[1]])
    add("F 3, 720p 4:4:4 chroma, strong", shapes["4:4:4"], 2, 3, [0, 1, 2],
        [mix[2]] * 3)
    return out


def north_waits(case) -> int:
    """Filtered blocks, over a frame case's dering frames, whose block
    above is filtered too: where the dering's rows wait on each other."""
    n = 0
    for src, f, d, s in zip(case["srcs"], case["frames"], case["dering"],
                            case["strong"]):
        if not d:
            continue
        _, var = postproc.deblock_plane(src.cpu(), case["ppq"][f, 0].cpu(),
                                        case["tabs"][0].cpu())
        npass = postproc.dering_plan(var, s, case["pli"])[0].numpy()
        n += int(((npass[1:] > 0) & (npass[:-1] > 0)).sum())
    return n


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


def plain_frames(case) -> list:
    """The plain version of a frame case's calls, on the CPU, in order."""
    ppq = case["ppq"].cpu()
    tabs = [t.cpu() for t in case["tabs"]]
    return [postproc.postprocess_plane(src.cpu(), ppq[f, 0], ppq[f, 1], *tabs,
                                       d, s, case["pli"])
            for src, f, d, s in zip(case["srcs"], case["frames"],
                                    case["dering"], case["strong"])]


def _plain_any(item):
    return plain_frames(item) if isinstance(item, dict) else plain(item)


def _cpu_item(item):
    if isinstance(item, dict):
        return {k: ([t.cpu() for t in v] if k in ("srcs", "tabs") else
                    v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in item.items()}
    return cpu_args(item)


def plain_all(args_list: list, workers: int = 8) -> list:
    """The plain version of every call (a frame case's: a list, one per
    frame), on the CPU in up to workers spawned processes of one torch
    thread each (the dering's wave loop is host bound: small ops, and the
    720p cases take seconds each)."""
    cpu = [_cpu_item(a) for a in args_list]
    n = max(1, min(workers, os.cpu_count() or 1, len(cpu)))
    with concurrent.futures.ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("spawn"),
            initializer=torch.set_num_threads, initargs=(1,)) as ex:
        return list(ex.map(_plain_any, cpu))


def _check_plane(device, label, args, want) -> None:
    """One postprocess_plane case, contiguous and as a padded plane's view
    into a strided output: two launches per call with dering, one
    without; nothing written outside the output; inputs left as they
    were."""
    from theora_tpu_torch.ops import postproc_cuda

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


def _check_frames(device, label, case, wants) -> None:
    """One postprocess_frames case into a row-strided [F, h, w] view of a
    marked buffer: one deblock launch, one dering launch where a frame
    derings; each listed frame equal to its plain call, the other frames
    and the buffer's margins untouched, the inputs left as they were."""
    from theora_tpu_torch.ops import postproc_cuda

    F, (h, w) = case["F"], case["srcs"][0].shape
    before = [t.clone() for t in case["srcs"]] + [case["ppq"].clone()]
    store = torch.full((F, h + 8, w + 16), 77, dtype=torch.uint8,
                       device=device)
    out = store[:, 4:4 + h, 8:8 + w]
    launches = postproc_cuda.postprocess_frames.launches
    postproc_cuda.postprocess_frames(
        case["srcs"], case["frames"], out, case["ppq"], *case["tabs"],
        case["dering"], case["strong"], case["pli"])
    torch.cuda.synchronize()
    nl = postproc_cuda.postprocess_frames.launches - launches
    if nl != 1 + any(case["dering"]):
        raise AssertionError(f"{label}: {nl} launches for one batch call")
    for f, want in zip(case["frames"], wants):
        if not torch.equal(out[f].cpu(), want):
            bad = (out[f].cpu() != want).nonzero()[:4].tolist()
            raise AssertionError(f"KP batch != plain, {label}, frame {f}: "
                                 f"{bad}")
    keep = torch.ones(F, dtype=torch.bool)
    keep[case["frames"]] = False
    if not (store[keep] == 77).all() or not (store[:, :4] == 77).all() \
            or not (store[:, 4 + h:] == 77).all() \
            or not (store[:, :, :8] == 77).all() \
            or not (store[:, :, 8 + w:] == 77).all():
        raise AssertionError(f"{label}: KP wrote outside its frames")
    for a, b in zip(case["srcs"] + [case["ppq"]], before):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: KP changed an input")


def check(device, todo=None, wants=None) -> tuple[int, int]:
    """Every (label, case) of todo (by default cases() and frame_cases())
    through the kernels against the plain version (wants, computed here
    unless given) byte for byte: postprocess_plane's cases contiguous and
    as a padded plane's view into a strided output, postprocess_frames'
    into a strided [F, h, w] output. Returns (cases, max |err|)."""
    todo = cases(device) + frame_cases(device) if todo is None else todo
    if wants is None:
        wants = plain_all([args for _, args in todo])
    for (label, args), want in zip(todo, wants):
        if isinstance(args, dict):
            _check_frames(device, label, args, want)
        else:
            _check_plane(device, label, args, want)
    return len(todo), 0


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


def parent_kernel(src: str = PARENT_SRC):
    """KP's earlier design (by default tools/kp_block_serial.cu, one frame
    per call through its two-launch C interface), built from src: returns
    launch(args, out, only=None) for postprocess_plane's arguments, which
    writes out; only="deblock" runs its deblock launch alone, only=
    "dering" its dering launch alone on the scratch of the last deblock
    of that shape, its counters zeroed first."""
    from theora_tpu_torch.ops.cuda_build import nvcc_build
    from theora_tpu_torch.ops.postproc_cuda import _SO

    lib = ctypes.CDLL(nvcc_build(src, _SO.replace(".so", "_parent.so")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.th_pp_deblock.restype = i32
    lib.th_pp_deblock.argtypes = [ptr, i32, ptr, i32, ptr, i32] + [
        ptr] * 4 + [i32, i32, ptr]
    lib.th_pp_dering.restype = i32
    lib.th_pp_dering.argtypes = [ptr, i32, ptr, i32] + [ptr] * 5 + [
        i32] * 4 + [ptr]
    scratch = {}

    def launch(args, out, only=None):
        src, dcq, qi, scale, sharp, dering, strong, pli = args
        h, w = src.shape
        nv, nh = h >> 3, w >> 3
        dev = src.device
        if (h, w) not in scratch:
            scratch[h, w] = (
                torch.empty((nv, nh), dtype=torch.int32, device=dev),
                torch.zeros(1 + nv, dtype=torch.int32, device=dev),
                torch.empty((h, w), dtype=torch.uint8, device=dev))
        var, counters, deb = scratch[h, w]
        stream = torch.cuda.current_stream(dev).cuda_stream
        dst = deb if dering else out
        if only != "dering":
            err = lib.th_pp_deblock(
                src.data_ptr(), src.stride(0), dst.data_ptr(),
                dst.stride(0), out.data_ptr() if dering else None,
                out.stride(0), dcq.data_ptr(), scale.data_ptr(),
                var.data_ptr(), counters.data_ptr(), h, w, stream)
            if err != 0:
                raise RuntimeError(f"KP from {src}: CUDA error {err}")
        if dering and only != "deblock":
            if only == "dering":
                counters.zero_()
            err = lib.th_pp_dering(
                deb.data_ptr(), w, out.data_ptr(), out.stride(0),
                var.data_ptr(), qi.data_ptr(), scale.data_ptr(),
                sharp.data_ptr(), counters.data_ptr(), nv, nh, int(strong),
                pli, stream)
            if err != 0:
                raise RuntimeError(f"KP from {src}: CUDA error {err}")
        return out

    launch.so = lib._name
    return launch


def _dering_alone(args, out):
    """The tree's dering launch alone on one call's scratch (a deblock
    launch made here first): returns a function that zeroes the counters,
    as the deblock launch does, and launches the dering."""
    from theora_tpu_torch.ops import postproc_cuda as kp

    src, dcq, qi, scale, sharp, dering, strong, pli = args
    h, w = src.shape
    nv, nh = h >> 3, w >> 3
    dev = src.device
    lib = kp._load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    deb = torch.empty((1, h, w), dtype=torch.uint8, device=dev)
    var = torch.empty((1, nv, nh), dtype=torch.int32, device=dev)
    counters = torch.empty(1, dtype=torch.int32, device=dev)
    mail = torch.empty(2 * nv * nh, dtype=torch.int64, device=dev)
    desc = (kp.KPFrame * 1)(kp.KPFrame(src.data_ptr(), src.stride(0), 0, -1,
                                       1 | int(strong) << 1))
    planes = kp.KPPlanes(out.data_ptr(), out.stride(0), dcq.data_ptr(), 0,
                         qi.data_ptr(), 0, scale.data_ptr(),
                         sharp.data_ptr(), deb.data_ptr(), var.data_ptr(),
                         counters.data_ptr(), mail.data_ptr(), out.stride(0),
                         h, w, nv, nh, pli)
    if lib.th_pp_deblock(desc, 1, ctypes.byref(planes), stream) != 0:
        raise RuntimeError("KP deblock launch failed")

    def run():
        counters.zero_()
        mail.zero_()
        if lib.th_pp_dering(desc, 1, ctypes.byref(planes), stream) != 0:
            raise RuntimeError("KP dering launch failed")

    run.keep = (deb, var, counters, mail, desc, planes)
    return run


def in_turns(fns: dict, flush, iters: int = TIMED_ITERS) -> dict:
    """CUDA-event times of each fn of fns, in turns: the order, then the
    order reversed (parent, new, new, parent for two); {name: [ms, ...]}."""
    order = list(fns) + list(fns)[::-1]
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(event_ms(fns[k], iters, flush))
    return out


def empty_ms(launches: int, flush) -> float:
    """CUDA-event time of as many empty kernel launches
    (torch.cuda._sleep(0)): the launch floor on this timer."""
    def run():
        for _ in range(launches):
            torch.cuda._sleep(0)
    return event_ms(run, TIMED_ITERS, flush)


def time_call(args, flush, step_ns: float, parent) -> dict:
    """CUDA-event times of one postprocess_plane call in turns with the
    earlier design (parent, from parent_kernel): the deblock alone (the
    call at dering off), the dering launch alone (its counters zeroed in
    the same timed span, as the deblock launch zeroes them), the call;
    the plain version on the card (one call: it takes seconds), a device
    copy of the plane and the call's empty launches; beside kp_bound,
    whose dependency chain is this call's (wavefront) at step_ns per
    update, and the bytes each launch moves (kp_bytes). Both designs'
    outputs must be equal."""
    from theora_tpu_torch.ops import postproc_cuda

    src, dcq, qi, scale, sharp, dering, strong, pli = args
    h, w = src.shape
    wf = wavefront(args)
    launches = postproc_cuda.postprocess_plane.launches
    out, pout = torch.empty_like(src), torch.empty_like(src)
    off = (*args[:5], False, strong, pli)
    if not torch.equal(postproc_cuda.postprocess_plane(*args, out=out),
                       parent(args, pout)):
        raise AssertionError("KP != its earlier design")
    row = {"deblock_turns": in_turns({
        "parent": lambda: parent(off, pout),
        "new": lambda: postproc_cuda.postprocess_plane(*off, out=out)},
        flush)}
    row["deblock_bound"] = kp_bound(h, w, False)
    row["launch_bytes"] = kp_bytes(h, w, dering)
    if dering:
        alone = _dering_alone(args, out)
        parent(args, pout, only="deblock")
        row["dering_turns"] = in_turns({
            "parent": lambda: parent(args, pout, only="dering"),
            "new": alone}, flush)
    row["turns"] = in_turns({
        "parent": lambda: parent(args, pout),
        "new": lambda: postproc_cuda.postprocess_plane(*args, out=out)},
        flush)
    for key in ("deblock", "dering", ""):
        t = row.get(f"{key}_turns" if key else "turns")
        if t is not None:
            pre = f"{key}_" if key else ""
            row[f"{pre}ms"] = sum(t["new"]) / len(t["new"])
            row[f"parent_{pre}ms"] = sum(t["parent"]) / len(t["parent"])
    row.update(kp_bound(h, w, dering, wf["dependency_steps"], step_ns))
    row["wavefront"] = wf
    row["plain_ms"] = once_ms(lambda: postproc.postprocess_plane(*args))
    row["copy_ms"] = event_ms(lambda: out.copy_(src), TIMED_ITERS, flush)
    row["empty_ms"] = empty_ms(1 + bool(dering), flush)
    postproc_cuda.postprocess_plane.launches = launches
    return row


def time_batch(calls: list, flush, step_ns: float, parent) -> dict:
    """One plane's frames as the batch decoder hands them to KP (calls:
    postprocess_plane arguments of equal shape and flags), in turns: the
    earlier design frame by frame (parent), postprocess_frames over all
    of them (two launches), postprocess_plane frame by frame; beside
    kp_bound_batch (all frames' bytes, the longest frame's dependency
    chain at step_ns) and the batch's two empty launches. All three
    outputs must be equal."""
    from theora_tpu_torch.ops import postproc_cuda

    srcs = [a[0] for a in calls]
    F, (h, w) = len(calls), srcs[0].shape
    _, _, _, scale, sharp, dering, strong, pli = calls[0]
    ppq = torch.stack([torch.stack([a[1], a[2]]) for a in calls])
    outs = {k: torch.empty((F, h, w), dtype=torch.uint8,
                           device=srcs[0].device)
            for k in ("parent", "batch", "per frame")}
    counts = (postproc_cuda.postprocess_plane.launches,
              postproc_cuda.postprocess_frames.launches)

    def old():
        for k, a in enumerate(calls):
            parent(a, outs["parent"][k])

    def batch():
        postproc_cuda.postprocess_frames(
            srcs, list(range(F)), outs["batch"], ppq, scale, sharp,
            [dering] * F, [strong] * F, pli)

    def per_frame():
        for k, a in enumerate(calls):
            postproc_cuda.postprocess_plane(*a, out=outs["per frame"][k])

    fns = {"parent": old, "batch": batch, "per frame": per_frame}
    for fn in fns.values():
        fn()
    if not (torch.equal(outs["batch"], outs["parent"])
            and torch.equal(outs["batch"], outs["per frame"])):
        raise AssertionError("KP's batch != frame by frame")
    turns = in_turns(fns, flush)
    steps = [wavefront(a)["dependency_steps"] for a in calls]
    row = {"frames": F, "turns": turns,
           **{f"{k}_ms": sum(v) / len(v) for k, v in turns.items()},
           "empty_ms": empty_ms(1 + bool(dering), flush),
           "frame_steps": steps}
    row.update(kp_bound_batch(h, w, [dering] * F, steps, step_ns))
    (postproc_cuda.postprocess_plane.launches,
     postproc_cuda.postprocess_frames.launches) = counts
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


def _ms(v) -> str:
    return " / ".join(f"{x:.4f}" for x in v)


def describe(label: str, r: dict) -> str:
    s = (f"{label}: deblock {r['deblock_ms']:.4f} ms (turns "
         f"{_ms(r['deblock_turns']['new'])}; the earlier design "
         f"{_ms(r['deblock_turns']['parent'])}; bound "
         f"{r['deblock_bound']['bound_ms']:.4f}, by bytes)")
    if "dering_ms" in r:
        s += (f", dering {r['dering_ms']:.4f} ms (turns "
              f"{_ms(r['dering_turns']['new'])}; the earlier design "
              f"{_ms(r['dering_turns']['parent'])}; the counters' reset "
              f"included)")
    return (s + f", the call {r['ms']:.4f} ms (turns "
            f"{_ms(r['turns']['new'])}; the earlier design "
            f"{_ms(r['turns']['parent'])}); bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']} (the call's {r['bytes']} B -> "
            f"{r['bytes_ms']:.4f} ms; the dependency chain "
            f"{r['chain_steps']} updates x {r['step_ns']:.2f} ns -> "
            f"{r['chain_ms']:.4f} ms), the call at "
            f"{100 * r['bound_ms'] / r['ms']:.2f}% of it (the earlier "
            f"design {100 * r['bound_ms'] / r['parent_ms']:.2f}%); its empty "
            f"launches {r['empty_ms']:.4f} ms; bytes per launch "
            f"{r['launch_bytes']}; plain {r['plain_ms']:.4f} ms, device copy "
            f"of the plane {r['copy_ms']:.4f} ms; no single PyTorch call "
            f"computes the filter (library_ms null); dering plan "
            f"{r['wavefront']}")


def describe_batch(label: str, r: dict) -> str:
    return (f"{label}, {r['frames']} frames: postprocess_frames "
            f"{r['batch_ms']:.4f} ms (turns {_ms(r['turns']['batch'])}), "
            f"postprocess_plane frame by frame {r['per frame_ms']:.4f} "
            f"({_ms(r['turns']['per frame'])}), the earlier design frame by "
            f"frame {r['parent_ms']:.4f} ({_ms(r['turns']['parent'])}); "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} (all frames' "
            f"{r['bytes']} B -> {r['bytes_ms']:.4f} ms; the longest frame's "
            f"chain {r['chain_steps']} updates x {r['step_ns']:.2f} ns -> "
            f"{r['chain_ms']:.4f} ms; chains {r['frame_steps']}), the batch "
            f"at {100 * r['bound_ms'] / r['batch_ms']:.2f}% of it; its two "
            f"empty launches {r['empty_ms']:.4f} ms")


def ptxas_report(log_path: str) -> list[str]:
    """Each kernel's registers, shared memory, barriers and spills from a
    build's ptxas log (cuda_build.nvcc_build keeps it beside the
    library)."""
    out, name = [], None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = re.search(r"th_pp_\w+?_kernel", m.group(1))
                name = name.group(0) if name else m.group(1)
                spill = ""
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line and name:
                out.append(f"{name}: {line.split(':', 1)[1].strip()}; "
                           f"{spill}")
                name = None
    return out


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
    parent = parent_kernel()
    for what, so in (("KP", postproc_cuda.build()),
                     ("the earlier design", parent.so)):
        for line in ptxas_report(so + ".log"):
            print(f"[kp] ptxas, {what}: {line}", flush=True)
    n, err = check(dev)
    print(f"[kp] {n} cases (postprocess_plane and postprocess_frames): "
          f"kernels == plain byte for byte | {smi}", flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    step = measure_step_ns(dev)
    print(f"[kp] one dering pixel update on the chain: {step:.3f} ns | "
          f"{smi}", flush=True)
    raw = gen_frames(8)
    rows = {}
    for label, args in frame_calls(raw[0], dev).items():
        rows[label] = time_call(args, flush, step, parent)
        print(f"[kp] {describe(label, rows[label])} | {smi}", flush=True)
    batch = time_batch([frame_calls(f, dev)["720p luma"] for f in raw],
                       flush, step, parent)
    print(f"[kp] {describe_batch('720p luma batch', batch)} | {smi}",
          flush=True)
    print(json.dumps({"card": smi, "cases": n, "step_ns": step,
                      "timed": rows, "batch": batch}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
