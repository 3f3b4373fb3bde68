"""Kernel KS's cases, bound and time on the card.

Usage: python -m theora_tpu_torch.tools.bench_mc

Holds each entry of the MC / skip / plane-assembly kernel
(ops/mc_cuda.py, csrc/mc.cu) against its plain version (ops/mc.py, the
entry of the same name) byte for byte, every output and the planes'
padding included, one launch per call and the inputs untouched (check),
on cases(): the 1280x720 4:2:0 planes, a 4:2:2 and a 4:4:4 chroma plane,
3 mesh segments, a frag group's fragment-id subsets and the split form
(skip_rows on each rank's share, the gather, place_rows), with MVs at the
extremes of the padding in every corner (side_rows), every reference and
half-pel flag, keyframe and inter steps, skip-test ties (16 ssd_unc == 16
ssd_rec + lamterm: the block skips) and lambdas one float32 ulp from
the value whose product is an integer, unfiltered steps (the borders)
and filtered ones (zero padding), prev and gold one buffer. Then times
with CUDA events over 50 launches, L2 flushed before each, at the 720p
luma and 4:2:0 chroma shapes: each entry, its plain version, a device copy
moving the same bytes and an empty kernel's launch, beside its bound
(ks_bound). Then KS fused into the encode scan's kernels: K2's and KR's
entries with KS's MC as their head (fdct_cuda.mc_fdct_quantize,
qrd_cuda.mc_fdct_quantize_rd) and K1's with KS's MC, skip test and plane
assembly (idct_cuda.mc_idct_recon_skip) against their plain chains and
the kernel chains they replaced, byte for byte (check_fused, on
fused_cases: the same planes, G = 1 and 3, prev and gold one buffer, a
frag group's share, K = 1-3, the trellis and the R/D path, key and inter
steps, borders on and off, blocks whose skip test ties and turns on one
float32 ulp), and timed at the 720p luma and chroma shapes in turns with
those chains beside fused_bound (timed_fused). Needs a CUDA card. Prints
one JSON summary as its last line.

The generators (side_rows, residual_inputs, skip_inputs, recon_inputs)
return numpy arrays from a seed; the CPU tests feed the same arrays to
the JAX package's steps.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from theora_tpu_torch.tools.bench_fdct import INT32_OPS_S
from theora_tpu_torch.tools.bench_trellis import HBM_BYTES_S, ITERS, event_ms

SEED = 20261018
# (label, nv, nh, pad_y, pad_x) of the 1280x720 planes.
HD_PLANES = (("720p luma", 90, 160, 16, 16),
             ("720p 4:2:0 chroma", 45, 80, 8, 8))
HD_422 = ("720p 4:2:2 chroma", 90, 80, 16, 8)
HD_444 = ("720p 4:4:4 chroma", 90, 160, 16, 16)
# int32 operations per pixel: MC (the half-pel average, the select), the
# residual or the clamped sum, the SSD's square and sum.
OPS_PER_PIXEL = 6


def plane_shape(nv: int, nh: int, pad_y: int, pad_x: int) -> tuple:
    return 8 * nv + 2 * pad_y, 8 * nh + 2 * pad_x


def mv_limit(pad: int) -> int:
    """The largest full-pel offset on an axis with this padding: +-16 on
    a 16-pixel border (luma), +-8 on an 8-pixel one (4:2:0 chroma)."""
    return 16 if pad >= 16 else 8


def shard(n: int, size: int, index: int) -> np.ndarray:
    """The int32 fragment ids of frag index `index` of `size`
    (parallel/ranks.py:FragGroup.shard: pads clamp onto fragment n - 1)."""
    nl = -(-n // size)
    return np.minimum(index * nl + np.arange(nl), n - 1).astype(np.int32)


def side_rows(rng, nv: int, nh: int, pad_y: int, pad_x: int,
              frags: np.ndarray) -> np.ndarray:
    """[6, len(frags)] int8 rows rs, y1, x1, y2, x2, u2 (ops/mc.py:
    SIDE_ROWS) for the blocks of fragments frags: every reference and
    half-pel flag, offsets anywhere in the axis' range, the second offset
    within one of the first; a corner fragment points both offsets at its
    corner's far end of the padding."""
    k = len(frags)
    ly, lx = mv_limit(pad_y), mv_limit(pad_x)
    rs = rng.choice(3, k, p=(0.2, 0.5, 0.3))
    y1 = rng.integers(-ly, ly + 1, k)
    x1 = rng.integers(-lx, lx + 1, k)
    y2 = np.clip(y1 + rng.integers(-1, 2, k), -ly, ly)
    x2 = np.clip(x1 + rng.integers(-1, 2, k), -lx, lx)
    u2 = rng.random(k) < 0.5
    r, c = frags // nh, frags % nh
    corner = ((r == 0) | (r == nv - 1)) & ((c == 0) | (c == nh - 1))
    oy = np.where(r == 0, -ly, ly)
    ox = np.where(c == 0, -lx, lx)
    rs[corner] = np.where(rng.random(corner.sum()) < 0.5, 1, 2)
    y1[corner] = y2[corner] = oy[corner]
    x1[corner] = x2[corner] = ox[corner]
    return np.stack((rs, y1, x1, y2, x2, u2)).astype(np.int8)


def residual_inputs(rng, G: int, nv: int, nh: int, pad_y: int, pad_x: int,
                    fid=None, same_gold: bool = False) -> dict:
    """mc_residual's inputs as numpy: prev, gold [G, Hp, Wp] uint8 (gold
    prev itself with same_gold), cur [N, 64] uint8, side [6, N] int8, fid
    None or [nl] int32."""
    hp, wp = plane_shape(nv, nh, pad_y, pad_x)
    prev = rng.integers(0, 256, (G, hp, wp), dtype=np.uint8)
    gold = prev if same_gold else rng.integers(0, 256, (G, hp, wp),
                                               dtype=np.uint8)
    frags = np.tile(np.arange(nv * nh) if fid is None else fid, G)
    return {"prev": prev, "gold": gold,
            "cur": rng.integers(0, 256, (len(frags), 64), dtype=np.uint8),
            "side": side_rows(rng, nv, nh, pad_y, pad_x, frags), "fid": fid}


def ulp_lambdas(m: int, t: int) -> list:
    """Float32 lambdas one ulp below, at and one ulp above 16 m / t: their
    products with t lie within an ulp of the integer 16 m, so one
    rounding decides lamterm."""
    lam = np.float32(16 * m) / np.float32(t)
    return [np.nextafter(lam, np.float32(0)), lam,
            np.nextafter(lam, np.float32(np.inf))]


def skip_inputs(rng, G: int, N: int, cnt_ulp: int = 3, m: int = 7) -> dict:
    """The skip test's inputs as numpy for N = G nl blocks: recon [N, 64]
    uint8, q16 [N, 64] int16, ssd_rec, ssd_unc, cnt [N] int32, ms [N] bool,
    lam [G] float32. Segment g % 3 == 0 takes a lambda that is a multiple
    of 8, so that every lamterm is a multiple of 16, and a quarter of its
    blocks tie (16 ssd_unc == 16 ssd_rec + lamterm: they skip); the
    others take the lambda one ulp below (g % 3 == 1) or above (2) those
    of ulp_lambdas(m, 6 cnt_ulp + 2), and a quarter of their blocks have
    cnt_ulp nonzero values and ssd_unc - ssd_rec = m, so that the decision
    falls on whether the product rounds up to 16 m."""
    nl = N // G
    ulp = ulp_lambdas(m, 6 * cnt_ulp + 2)
    lam = np.array([8.0 * rng.integers(1, 60) if g % 3 == 0
                    else ulp[0] if g % 3 == 1 else ulp[2]
                    for g in range(G)], np.float32)
    cnt = rng.integers(0, 65, N).astype(np.int32)
    ssd_unc = rng.integers(0, 64 * 255 * 255 + 1, N).astype(np.int32)
    ssd_unc[rng.random(N) < 0.1] = 0
    lt = (lam.repeat(nl) * (np.float32(6) * cnt.astype(np.float32)
                            + np.float32(2))).astype(np.int32)
    ssd_rec = np.maximum(ssd_unc - lt // 16 + rng.integers(-2, 3, N),
                         0).astype(np.int32)
    special = rng.random(N) < 0.25
    tie = special & (np.arange(N) // nl % 3 == 0)
    ssd_rec[tie] = ssd_unc[tie] - lt[tie] // 16
    near = special & ~tie
    cnt[near] = cnt_ulp
    ssd_unc[near] = np.maximum(ssd_unc[near], m)
    ssd_rec[near] = ssd_unc[near] - m
    q16 = rng.integers(-40, 41, (N, 64)).astype(np.int16)
    q16[rng.random((N, 64)) < 0.7] = 0
    q16[:2, :2] = (-32768, 32767)
    return {"recon": rng.integers(0, 256, (N, 64), dtype=np.uint8),
            "q16": q16, "ssd_rec": np.maximum(ssd_rec, 0), "ssd_unc": ssd_unc,
            "cnt": cnt, "ms": rng.random(N) < 0.7, "lam": lam}


def recon_inputs(rng, nv: int, nh: int, pad_y: int, pad_x: int,
                 same_gold: bool = False) -> dict:
    """mc_recon's inputs as numpy: prev, gold [Hp, Wp] uint8, resid [nv
    nh, 64] int16 (mostly within +-300, some int16 extremes), side [6, nv
    nh] int8."""
    hp, wp = plane_shape(nv, nh, pad_y, pad_x)
    n = nv * nh
    prev = rng.integers(0, 256, (hp, wp), dtype=np.uint8)
    resid = rng.integers(-300, 301, (n, 64)).astype(np.int16)
    resid[rng.random((n, 64)) < 0.01] = 32767
    resid[rng.random((n, 64)) < 0.01] = -32768
    return {"prev": prev,
            "gold": prev if same_gold else rng.integers(
                0, 256, (hp, wp), dtype=np.uint8),
            "resid": resid,
            "side": side_rows(rng, nv, nh, pad_y, pad_x, np.arange(n))}


def _t(a, device):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(
        a)).to(device)


def _planes(d: dict, device) -> tuple:
    prev = _t(d["prev"], device)
    return prev, prev if d["gold"] is d["prev"] else _t(d["gold"], device)


def residual_args(d: dict, geom: tuple, device) -> tuple:
    """mc_residual's arguments on device from residual_inputs."""
    prev, gold = _planes(d, device)
    return (prev, gold, _t(d["cur"], device), _t(d["side"], device), *geom,
            _t(d["fid"], device))


def skip_args(rng, G: int, geom: tuple, fid, intra: bool, borders: bool,
              device) -> tuple:
    """skip_place's arguments (skip_rows' with fid) on device: prev as
    residual_inputs makes it, the skip test's inputs, fresh qout and
    coded."""
    nv, nh, pad_y, pad_x = geom
    d = residual_inputs(rng, G, nv, nh, pad_y, pad_x, fid)
    N = d["cur"].shape[0]
    s = skip_inputs(rng, G, N)
    head = (_t(d["prev"], device),) + tuple(
        _t(s[k], device) for k in ("recon", "q16", "ssd_rec", "ssd_unc",
                                   "cnt", "ms", "lam"))
    out = (torch.full((N, 64), 7, dtype=torch.int16, device=device),
           torch.zeros(N, dtype=torch.bool, device=device))
    return head + (intra,) + out + geom + (
        borders if fid is None else _t(fid, device),)


def recon_args(d: dict, geom: tuple, borders: bool, device) -> tuple:
    """mc_recon's arguments on device from recon_inputs, with a picture
    output on an unfiltered step."""
    nv, nh = geom[:2]
    prev, gold = _planes(d, device)
    pic = torch.zeros((8 * nv, 8 * nh), dtype=torch.uint8, device=device) \
        if borders else None
    return (prev, gold, _t(d["resid"], device), _t(d["side"], device),
            *geom, borders, pic)


def cases(device, seed: int = SEED) -> list:
    """[(label, entry name, argument tuple)] for check(): the 720p planes
    and the other chroma layouts, 3 segments, frag subsets, every skip
    flavour, unfiltered and filtered steps. place_rows' cases come from
    the split form in check()."""
    rng = np.random.default_rng(seed)
    geoms = [g[1:] for g in HD_PLANES + (HD_422, HD_444)]
    out = []
    for geom, label in zip(geoms, [g[0] for g in HD_PLANES + (HD_422,
                                                             HD_444)]):
        nv, nh = geom[:2]
        n = nv * nh
        for G, fid, same in ((1, None, False), (3, None, True),
                             (3, shard(n, 2, 1), False)):
            what = f"{label}, G {G}" + ("" if fid is None else
                                        f", fragments {len(fid)} of {n}")
            out.append((f"{what}{', gold = prev' if same else ''}",
                        "mc_residual", residual_args(residual_inputs(
                            rng, G, *geom, fid, same), geom, device)))
            for intra in (False, True):
                for borders in (True, False):
                    if fid is not None and borders:
                        continue
                    out.append((f"{what}, {'key' if intra else 'inter'} "
                                f"step, borders {borders}",
                                "skip_rows" if fid is not None
                                else "skip_place",
                                skip_args(rng, G, geom, fid, intra, borders,
                                          device)))
        for borders in (True, False):
            out.append((f"{label}, borders {borders}", "mc_recon",
                        recon_args(recon_inputs(rng, *geom, same_gold=not
                                                borders), geom, borders,
                                   device)))
    return out


# The arguments an entry writes in place, by position.
_IN_PLACE = {"skip_place": (9, 10), "skip_rows": (9, 10), "mc_recon": (9,)}


def _outputs(entry: str, args: tuple, fn) -> list:
    """Every output of one call of fn (the wrapper or the plain version),
    those written in place included: fn writes fresh copies of them."""
    args = list(args)
    inplace = [i for i in _IN_PLACE.get(entry, ()) if args[i] is not None]
    for i in inplace:
        args[i] = args[i].clone()
    res = fn(*args)
    return (list(res) if isinstance(res, tuple) else [res]) + [
        args[i] for i in inplace]


def _same(got, want, what: str, label: str) -> int:
    """Every tensor of got equal to want's; returns the largest
    |difference| (0)."""
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        err = max(err, int((g.int() - w.int()).abs().max()) if g.numel()
                  else 0)
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:4].tolist()
            raise AssertionError(f"{label}: != {what}, output {i} at {bad}")
    return err


def _refs(side) -> int:
    """Reference rows the data make MC read: one per block with rs != 0,
    a second where u2."""
    s = side.cpu().numpy()
    return int((s[0] != 0).sum() + ((s[0] != 0) & (s[5] != 0)).sum())


def check_one(label: str, entry: str, args: tuple) -> int:
    """One KS entry against its plain version on args: every output equal,
    one launch, the inputs untouched; returns the largest |difference|."""
    from theora_tpu_torch.ops import mc, mc_cuda

    wrapper = getattr(mc_cuda, entry)
    before = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    launches = wrapper.launches
    got = _outputs(entry, args, wrapper)
    want = _outputs(entry, args, getattr(mc, entry))
    torch.cuda.synchronize()
    err = _same(got, want, "plain", f"KS {entry} on {label}")
    for a, b in zip(args, before):
        if isinstance(a, torch.Tensor) and not torch.equal(a, b):
            raise AssertionError(f"KS {entry} wrote an input on {label}")
    if wrapper.launches != launches + 1:
        raise AssertionError(f"KS {entry} did not launch once on {label}")
    return err


def split_form(device, seed: int = SEED) -> tuple:
    """The frag group's split form on the 720p luma plane over 3 segments
    and 2 ranks: skip_rows on each rank's share against its plain version,
    the gather (FragGroup.whole's order), then place_rows against its
    plain version, unfiltered and filtered; and the result equal to
    skip_place over every fragment. Returns (calls checked, largest
    |difference|)."""
    from theora_tpu_torch.ops import mc_cuda

    rng = np.random.default_rng(seed + 1)
    nv, nh, pad_y, pad_x = HD_PLANES[0][1:]
    geom = (nv, nh, pad_y, pad_x)
    n, G, size = nv * nh, 3, 2
    whole = skip_args(rng, G, geom, None, False, True, device)
    prev, rest = whole[0], whole[1:9]
    calls = err = 0
    parts = []
    for r in range(size):
        fid = torch.from_numpy(shard(n, size, r)).to(device)
        nl = fid.shape[0]
        # Rank r's blocks of each segment: segment g's rows g n + fid.
        pick = (torch.arange(G, device=device)[:, None] * n
                + fid.long()[None]).reshape(-1)
        args = (prev,) + tuple(t[pick] if isinstance(t, torch.Tensor)
                               and t.shape[0] == G * n else t
                               for t in rest) + (
            torch.empty((G * nl, 64), dtype=torch.int16, device=device),
            torch.empty(G * nl, dtype=torch.bool, device=device)) + geom + (
            fid,)
        err = max(err, check_one(f"split form, rank {r}", "skip_rows",
                                 args))
        parts.append(mc_cuda.skip_rows(*args).view(G, nl, 65))
        calls += 1
    rows = torch.stack(parts).movedim(0, 1).reshape(G, -1, 65)[:, :n] \
        .reshape(G * n, 65).contiguous()
    for borders in (True, False):
        err = max(err, check_one(f"split form, place, borders {borders}",
                                 "place_rows", (rows, G, *geom, borders)))
        calls += 1
        plane, _ = mc_cuda.place_rows(rows, G, *geom, borders)
        full = list(whole)
        full[-1] = borders
        if not torch.equal(plane, mc_cuda.skip_place(*full)):
            raise AssertionError("KS split form != skip_place")
    return calls, err


def check(device) -> tuple[int, int]:
    """Every case of cases() and the split form; raises on a difference.
    Returns (calls checked, largest |difference|)."""
    n = err = 0
    for label, entry, args in cases(device):
        err = max(err, check_one(label, entry, args))
        n += 1
    calls, e = split_form(device)
    return n + calls, max(err, e)


def ks_bound(entry: str, args) -> dict:
    """KS's least time for one call of `entry` with the wrapper's
    arguments, after the call (the skip entries' coded flags are read):
    the bytes it must move, each input read once and each output written
    once, over the memory rate, and OPS_PER_PIXEL int32 operations per
    pixel over the int32 rate. Data decide the bytes: a reference block is
    read only where rs != 0, a second one only there where u2; the skip
    test reads recon and q16 of a coded block, prev's block of a skipped
    one, and its decision inputs only on an inter step. Bytes bind. Copies
    the side rows and coded flags to the host."""
    if entry in ("mc_residual", "mc_recon"):
        refs = _refs(args[3])
        n = args[3].shape[1]
        if entry == "mc_residual":
            fid = args[8]
            nbytes = n * (6 + 64 + 64 + 256 + 128 + 4) + 64 * refs + (
                0 if fid is None else 4 * fid.numel())
        else:
            pic = args[9]
            nbytes = n * (6 + 128) + 64 * refs + args[0].numel() + (
                0 if pic is None else pic.numel())
    elif entry == "place_rows":
        rows = args[0]
        G, nv, nh, pad_y, pad_x = args[1:6]
        n = rows.shape[0]
        nbytes = n * (65 + 1) + G * np.prod(plane_shape(nv, nh, pad_y, pad_x))
    else:
        prev, intra, coded = args[0], args[8], args[10]
        n = coded.numel()
        nc = int(coded.sum())
        nbytes = nc * (64 + 128) + (n - nc) * 64 + n * (128 + 1) + (
            0 if intra else n * 13 + 4 * prev.shape[0])
        nbytes += prev.numel() if entry == "skip_place" else 65 * n
    ops = OPS_PER_PIXEL * 64 * n
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / INT32_OPS_S * 1e3
    return {"bytes": int(nbytes), "bytes_ms": bytes_ms, "ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def timed_entries(device, flush, seed: int = SEED) -> dict:
    """{label: row} at the 720p luma and 4:2:0 chroma shapes, G = 1, as
    the encode scan and the decode step launch the entries (an inter step
    with borders; the decode's unfiltered step with its picture output):
    CUDA-event times of the kernel (twice, "ms_runs", "ms" their mean),
    its plain version, a device copy moving the same bytes (half read,
    half written) and an empty kernel's launch, beside ks_bound."""
    from theora_tpu_torch.ops import mc, mc_cuda

    rng = np.random.default_rng(seed + 2)
    rows = {}
    for label, *geom in HD_PLANES:
        geom = tuple(geom)
        nv, nh = geom[:2]
        calls = {
            "mc_residual": residual_args(residual_inputs(
                rng, 1, *geom), geom, device),
            "skip_place": skip_args(rng, 1, geom, None, False, True, device),
            "mc_recon": recon_args(recon_inputs(rng, *geom), geom, True,
                                   device)}
        for entry, args in calls.items():
            wrapper, plain = getattr(mc_cuda, entry), getattr(mc, entry)
            launches = wrapper.launches
            wrapper(*args)
            b = ks_bound(entry, args)
            half = max(b["bytes"] // 2, 1)
            src = torch.empty(half, dtype=torch.uint8, device=device)
            dst = torch.empty_like(src)
            row = {"ms_runs": [event_ms(lambda: wrapper(*args), ITERS, flush)
                               for _ in range(2)]}
            row["ms"] = sum(row["ms_runs"]) / 2
            row["plain_ms"] = event_ms(lambda: plain(*args), 3, flush)
            row["copy_ms"] = event_ms(lambda: dst.copy_(src), ITERS, flush)
            row["floor_ms"] = event_ms(lambda: torch.cuda._sleep(0), ITERS,
                                       flush)
            row.update(b)
            wrapper.launches = launches
            rows[f"{entry}, {label} ({nv * nh} blocks)"] = row
    return rows


def describe(label: str, r: dict) -> str:
    """One line of a timed_entries row."""
    return (f"{label}: kernel {[round(x, 5) for x in r['ms_runs']]} ms; "
            f"plain {r['plain_ms']:.4f} ms, device copy of the same bytes "
            f"{r['copy_ms']:.4f} ms, empty launch {r['floor_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bytes']}"
            f" B -> {r['bytes_ms']:.5f} ms, {r['ops']} int32 ops -> "
            f"{r['ops_ms']:.5f} ms); kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.2f}% of it")


# ----------------------------------------------------------------------
# KS fused into the encode scan's kernels: K2's and KR's entries with its
# MC as their head (fdct_cuda.mc_fdct_quantize, qrd_cuda.
# mc_fdct_quantize_rd) and K1's entry with its MC, skip test and plane
# assembly around the chooser (idct_cuda.mc_idct_recon_skip).

# The skip test's lambda on the engineered blocks of fused_inputs: a
# multiple of 8, so that lam * (6 * 0 + 2) is the integer 16.
TIE_LAM = np.float32(8.0)


def fused_inputs(rng, G: int, nv: int, nh: int, pad_y: int, pad_x: int,
                 K: int, fid=None, same_gold: bool = False,
                 scales: bool = True) -> dict:
    """The fused entries' inputs as numpy for N = G nl blocks of one
    plane at one frame step: residual_inputs' planes, source and side rows
    (MVs at the padding's far corners), then per segment g the qi rows of
    bench_segments.QIS[g % 4][:K] (dequant rows deq [G, K, 2, 64] int16 of
    plane 0 where pad_x is 16, else 1; the trellis' lambdas lam_t [G, K]
    and the R/D quantizer's lam_q [G, K, 2]; the bit table nb), the
    chooser's and skip test's lambda lam [G]: TIE_LAM, one float32 ulp
    below it and one above, by g % 3, per-block lambda scales lam_sc [N]
    in [0.1, 8] with `scales`, the may-skip flags ms [N] and the inter
    flags (rs != 0). About a fifth of the blocks whose fragment appears
    once and is no corner are engineered ("tie" [N] bool): gold's block
    there is the source block, which the block predicts from gold at zero
    motion, so that its residual and every qi row's values are 0, and
    prev's block there is the source with one pixel one level off (with
    same_gold, the source itself), so that the skip test compares 16 x 1
    with lamterm = trunc(lam * 2): a tie that skips at TIE_LAM, a block
    that is coded one ulp below and skips one ulp above."""
    from theora_tpu_torch.tools import bench_fdct as bf
    from theora_tpu_torch.tools import bench_segments as bs
    from theora_tpu_torch.tools.bench_qrd import lam_q_rows
    from theora_tpu_torch.tools.bench_trellis import kt_tables

    d = residual_inputs(rng, G, nv, nh, pad_y, pad_x, fid, same_gold)
    prev, gold, side, cur = d["prev"], d["gold"], d["side"], d["cur"]
    n = nv * nh
    frags = np.arange(n) if fid is None else np.asarray(fid)
    nl = len(frags)
    N = G * nl
    r, c = frags // nh, frags % nh
    corner = ((r == 0) | (r == nv - 1)) & ((c == 0) | (c == nh - 1))
    once = np.zeros(nl, bool)
    once[np.unique(frags, return_index=True)[1]] = True
    once &= np.bincount(frags, minlength=n)[frags] == 1
    tie = np.zeros(N, bool)
    for g in range(G):
        for j in np.nonzero(once & ~corner & (rng.random(nl) < 0.2))[0]:
            b = g * nl + j
            y, x = pad_y + 8 * r[j], pad_x + 8 * c[j]
            blk = cur[b].reshape(8, 8)
            gold[g, y:y + 8, x:x + 8] = blk
            if gold is not prev:
                prev[g, y:y + 8, x:x + 8] = blk
                prev[g, y + rng.integers(8), x + rng.integers(8)] ^= 1
            side[:, b] = (2, 0, 0, 0, 0, 0)
            tie[b] = True
    pli = 0 if pad_x >= 16 else 1
    qis = [bs.QIS[g % len(bs.QIS)][:K] for g in range(G)]
    _, nb, rdl = kt_tables()
    ms = rng.random(N) < 0.7
    ms[tie] = True
    ulp = (TIE_LAM, np.nextafter(TIE_LAM, np.float32(0)),
           np.nextafter(TIE_LAM, np.float32(np.inf)))
    return dict(
        d, tie=tie, inter=(side[0] != 0).astype(np.uint8), ms=ms,
        deq=np.stack([bf.triple_rows(q, pli) for q in qis]),
        lam_t=np.array([[rdl[1][q] for q in qs] for qs in qis], np.float32),
        lam_q=np.stack([lam_q_rows(qs, pli) for qs in qis]), nb=nb,
        lam=np.array([ulp[g % 3] for g in range(G)], np.float32),
        lam_sc=(rng.uniform(0.1, 8.0, N).astype(np.float32) if scales
                else None))


def fused_tensors(d: dict, device) -> dict:
    """fused_inputs' arrays as tensors on device (gold is prev where
    d["gold"] is d["prev"])."""
    prev, gold = _planes(d, device)
    out = {k: _t(v, device) if isinstance(v, np.ndarray) else v
           for k, v in d.items() if k not in ("prev", "gold")}
    return dict(out, prev=prev, gold=gold)


def _mc_in(t: dict) -> tuple:
    return t["prev"], t["gold"], t["cur"], t["side"]


def head_args(t: dict, geom: tuple, path: str) -> tuple:
    """The fused head's arguments: mc_fdct_quantize's (path "trellis")
    or mc_fdct_quantize_rd's (path "rd")."""
    lam = () if path == "trellis" else (t["lam_q"],)
    return (*_mc_in(t), t["deq"], t["inter"], *lam, *geom, t["fid"])


def head_chain(t: dict, geom: tuple, path: str, plain: bool):
    """What the fused head replaced on the same inputs: KS's mc_residual,
    then K2 (trellis) or KR's fused entry (rd), as kernels or (plain) as
    their plain versions."""
    from theora_tpu_torch.ops import fdct_cuda, mc, mc_cuda, qrd_cuda, \
        transforms

    _, res, _ = (mc.mc_residual if plain else mc_cuda.mc_residual)(
        *_mc_in(t), *geom, t["fid"])
    if path == "trellis":
        fn = transforms.fdct_quantize if plain else fdct_cuda.fdct_quantize
        return fn(res, t["deq"], t["inter"])
    fn = transforms.fdct_quantize_rd if plain else qrd_cuda.fdct_quantize_rd
    return fn(res, t["deq"], t["inter"], t["lam_q"])


def head(t: dict, geom: tuple, path: str):
    """The fused head (a launch on the card)."""
    from theora_tpu_torch.ops import fdct_cuda, qrd_cuda

    fn = (fdct_cuda.mc_fdct_quantize if path == "trellis"
          else qrd_cuda.mc_fdct_quantize_rd)
    return fn(*head_args(t, geom, path))


def quantized(t: dict, geom: tuple, path: str) -> tuple:
    """The quantizer's outputs (values, counts, DC-only flags) K1's fused
    entry reads: the fused head's, then the trellis (kernel KT, by its
    wrapper) on the trellis path."""
    from theora_tpu_torch.ops import trellis_cuda

    out = head(t, geom, path)
    if path == "rd":
        return out
    return trellis_cuda.trellis_quantize(out[0], out[1], t["deq"],
                                         t["inter"], t["lam_t"], t["nb"],
                                         t["lam_sc"])


def tail_outputs(t: dict) -> tuple:
    """Fresh in-place outputs of K1's fused entry (qout, coded, qii),
    filled with values no step writes."""
    N = t["cur"].shape[0]
    dev = t["cur"].device
    return (torch.full((N, 64), 7, dtype=torch.int16, device=dev),
            torch.zeros(N, dtype=torch.bool, device=dev),
            torch.full((N,), 9, dtype=torch.uint8, device=dev))


def tail_args(t: dict, geom: tuple, q: tuple, intra: bool, borders: bool,
              out: tuple) -> tuple:
    """mc_idct_recon_skip's positional arguments on the quantizer's
    outputs q and the in-place outputs out."""
    q16, cnt, dc_only = q
    return (q16, dc_only, cnt, t["deq"], t["inter"], *_mc_in(t), t["ms"],
            t["lam"], t["lam_sc"], intra, *out, *geom, borders, t["fid"])


def tail_chain(t: dict, geom: tuple, q: tuple, intra: bool, borders: bool,
               out: tuple, plain: bool):
    """What K1's fused entry replaced on the same inputs, writing out in
    place: KS's mc_residual, K1's encode entry, then KS's skip_place (or
    skip_rows with fid), as kernels or (plain) as their plain versions.
    Returns the plane (or rows)."""
    from theora_tpu_torch.ops import idct_cuda, mc, mc_cuda, transforms

    q16, cnt, dc_only = q
    ks = mc if plain else mc_cuda
    choose = (transforms.idct_recon_choose if plain
              else idct_cuda.idct_recon_choose)
    pred, _, unc = ks.mc_residual(*_mc_in(t), *geom, t["fid"])
    recon, ssd, qii, qk, ck = choose(q16, dc_only, cnt, t["deq"],
                                     t["inter"], pred, t["cur"], t["lam"],
                                     t["lam_sc"])
    qout, coded, qii_out = out
    qii_out.copy_(qii)
    skip = (t["prev"], recon, qk, ssd, unc, ck, t["ms"], t["lam"], intra,
            qout, coded, *geom)
    if t["fid"] is None:
        return ks.skip_place(*skip, borders)
    return ks.skip_rows(*skip, t["fid"])


def fused_cases(device, seed: int = SEED) -> list:
    """[(label, tensors, geom, K, path, intra, borders)] for check_fused:
    the 1280x720 4:2:0 planes and a 4:2:2 and a 4:4:4 chroma plane; on
    each G = 1, 3 segments with prev and gold one buffer, and 3 segments
    of a frag group's share (rank 1 of 2: rows in place of the plane); K
    = 1, 2 and 3 on each, on the trellis and on the R/D path; key and
    inter steps, borders on and off (the frag share writes rows: no
    borders) in turn."""
    rng = np.random.default_rng(seed + 3)
    out = []
    turn = 0
    for label, *geom in HD_PLANES + (HD_422, HD_444):
        geom = tuple(geom)
        nv, nh = geom[:2]
        n = nv * nh
        for G, fid, same in ((1, None, False), (3, None, True),
                             (3, shard(n, 2, 1), False)):
            for K in (1, 2, 3):
                t = fused_tensors(fused_inputs(
                    rng, G, *geom, K, fid, same, scales=K != 2), device)
                for path in ("trellis", "rd"):
                    intra = turn % 3 == 2
                    borders = fid is None and turn % 2 == 0
                    turn += 1
                    what = (f"{label}, G {G}"
                            + ("" if fid is None else
                               f", fragments {len(fid)} of {n}")
                            + (", gold = prev" if same else "")
                            + f", K {K}, {path}, "
                            + ("key" if intra else "inter")
                            + f" step, borders {borders}")
                    out.append((what, t, geom, K, path, intra, borders))
    return out


def check_fused_one(label: str, t: dict, geom: tuple, path: str,
                    intra: bool, borders: bool) -> tuple:
    """One case: the fused head against its plain chain and its kernel
    chain, every output; the quantizer on the head's outputs; K1's fused
    entry against its plain chain and its kernel chain, every output (the
    plane with its padding, or the rows; qout, coded, qii); one launch
    each on the card, the inputs untouched. Returns (largest |difference|, coded
    flags)."""
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, qrd_cuda

    inputs = [v for v in (*_mc_in(t), t["deq"], t["inter"]) if v is not None]
    before = [v.clone() for v in inputs]
    step = 1 if t["cur"].is_cuda else 0  # the CPU path launches nothing
    fused = (fdct_cuda.mc_fdct_quantize if path == "trellis"
             else qrd_cuda.mc_fdct_quantize_rd)
    launches = fused.launches
    got = head(t, geom, path)
    if fused.launches != launches + step:
        raise AssertionError(f"{label}: the fused head did not launch once")
    err = 0
    for plain in (True, False):
        err = max(err, _same(got, head_chain(t, geom, path, plain),
                             "its plain chain" if plain
                             else "its kernel chain", f"{label}, head"))
    q = quantized(t, geom, path)
    launches = idct_cuda.mc_idct_recon_skip.launches
    out = tail_outputs(t)
    kept = idct_cuda.mc_idct_recon_skip(*tail_args(t, geom, q, intra,
                                                   borders, out))
    if idct_cuda.mc_idct_recon_skip.launches != launches + step:
        raise AssertionError(f"{label}: K1's fused entry did not launch "
                             f"once")
    for plain in (True, False):
        ref = tail_outputs(t)
        want = tail_chain(t, geom, q, intra, borders, ref, plain)
        err = max(err, _same((kept, *out), (want, *ref),
                             "its plain chain" if plain
                             else "its kernel chain", f"{label}, tail"))
    for a, b in zip(inputs, before):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: a fused entry wrote an input")
    return err, out[1]


def check_fused(device) -> tuple[int, int]:
    """Every case of fused_cases; raises on a difference. Returns (cases
    checked, largest |difference|)."""
    err = n = 0
    for label, t, geom, _, path, intra, borders in fused_cases(device):
        e, coded = check_fused_one(label, t, geom, path, intra, borders)
        err = max(err, e)
        n += 1
        if not intra and t["fid"] is None and t["gold"] is not t["prev"]:
            # The engineered blocks: skipped at TIE_LAM (a tie) and one
            # ulp above, coded one ulp below.
            G = t["lam"].shape[0]
            seg = torch.arange(coded.numel(), device=device) // (
                coded.numel() // G) % 3
            tie = t["tie"]
            if coded[tie & (seg != 1)].any() or not coded[
                    tie & (seg == 1)].all():
                raise AssertionError(f"{label}: the skip test's ties and "
                                     f"ulp lambdas did not decide")
    return n, err


def fused_bound(entry: str, args) -> dict:
    """The least time of one call of a fused entry with the wrapper's
    arguments, after the call (K1's coded flags are read), with
    mc_residual's and skip_place's counting rules (ks_bound): each input
    read once where the data need it (a reference row only for rs != 0, a
    second where u2; prev's uncoded block on an inter step), each output
    written once (qout, coded, qii and the plane or the rows); nothing
    in between (the prediction, the residual, the reconstruction) reaches
    memory. Operations: the kernel's own (bench_fdct.k2_ops, bench_qrd's
    R/D count, bench_idct.k1_ops) plus OPS_PER_PIXEL per pixel of MC, at
    the int32 and float32 rates. Entries: "mc_fdct_quantize",
    "mc_fdct_quantize_rd", "mc_idct_recon_skip"."""
    from theora_tpu_torch.tools.bench_fdct import k2_ops
    from theora_tpu_torch.tools.bench_idct import FP32_OPS_S, k1_ops
    from theora_tpu_torch.tools.bench_qrd import OPS_PER_POSITION

    def nb(*ts):
        return sum(x.numel() * x.element_size() for x in ts
                   if isinstance(x, torch.Tensor))

    if entry == "mc_idct_recon_skip":
        (q16, dc_only, cnt, deq, inter, prev, gold, cur, side, ms, lam,
         lam_sc, intra, qout, coded, qii) = args[:16]
        fid = args[21] if len(args) > 21 else None
        k, n = q16.shape[:2]
        nbytes = (nb(q16, dc_only, cnt, deq, inter, cur, side, ms, lam,
                      lam_sc, fid, qout, coded, qii) + 64 * _refs(side)
                  + (0 if intra else 64 * n)
                  + (prev.numel() if fid is None else 65 * n))
        iops, fops = k1_ops("encode", (q16, dc_only, cnt, deq, inter, None,
                                       cur, lam, lam_sc))
        fops += 2 * n  # the skip test's product and conversion
    else:
        prev, gold, cur, side, deq, inter = args[:6]
        rd = entry == "mc_fdct_quantize_rd"
        fid = args[11 if rd else 10]
        n, k = cur.shape[0], deq.shape[-3]
        nbytes = (nb(cur, side, deq, inter, fid, *(args[6:7] if rd else ()))
                  + 64 * _refs(side)
                  + (k * n * (128 + 4 + 1) if rd else n * 128 * (1 + k)))
        iops = k2_ops(n, k)
        fops = k * n * (63 * OPS_PER_POSITION + 2) if rd else 0
    iops += OPS_PER_PIXEL * 64 * n
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = max(iops / INT32_OPS_S, (iops + fops) / FP32_OPS_S) * 1e3
    return {"bytes": int(nbytes), "bytes_ms": bytes_ms, "int32_ops": iops,
            "float32_ops": fops, "ops": iops + fops, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def timed_fused(device, flush, seed: int = SEED) -> dict:
    """{label: row} at the 720p luma and 4:2:0 chroma shapes, G = 1, K =
    1 (the q48 encode's), an inter step with borders: each fused entry
    and the chain it replaced, timed in turns (fused, chain, chain, fused;
    CUDA-event means over ITERS, L2 flushed before each): mc_fdct_quantize
    against mc_residual -> K2, mc_fdct_quantize_rd against mc_residual ->
    KR's fused entry, mc_idct_recon_skip against K1's encode entry ->
    skip_place (their inputs made once, outside the timing); beside
    fused_bound, an empty kernel's launch and the plain chain."""
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, mc_cuda, \
        qrd_cuda

    rng = np.random.default_rng(seed + 4)
    rows = {}
    for label, *geom in HD_PLANES:
        geom = tuple(geom)
        nv, nh = geom[:2]
        t = fused_tensors(fused_inputs(rng, 1, *geom, 1, scales=False),
                          device)
        mc_in = (*_mc_in(t), *geom, None)
        pred, res, unc = mc_cuda.mc_residual(*mc_in)
        q = quantized(t, geom, "trellis")
        out = tail_outputs(t)
        targs = tail_args(t, geom, q, False, True, out)

        def k1_chain():
            recon, ssd, _, qk, ck = idct_cuda.idct_recon_choose(
                q[0], q[2], q[1], t["deq"], t["inter"], pred, t["cur"],
                t["lam"], t["lam_sc"])
            return mc_cuda.skip_place(t["prev"], recon, qk, ssd, unc, ck,
                                      t["ms"], t["lam"], False, *out[:2],
                                      *geom, borders=True)

        entries = {
            "mc_fdct_quantize": (
                head_args(t, geom, "trellis"),
                lambda: fdct_cuda.mc_fdct_quantize(
                    *head_args(t, geom, "trellis")),
                lambda: fdct_cuda.fdct_quantize(
                    mc_cuda.mc_residual(*mc_in)[1], t["deq"], t["inter"]),
                lambda: head_chain(t, geom, "trellis", True)),
            "mc_fdct_quantize_rd": (
                head_args(t, geom, "rd"),
                lambda: qrd_cuda.mc_fdct_quantize_rd(
                    *head_args(t, geom, "rd")),
                lambda: qrd_cuda.fdct_quantize_rd(
                    mc_cuda.mc_residual(*mc_in)[1], t["deq"], t["inter"],
                    t["lam_q"]),
                lambda: head_chain(t, geom, "rd", True)),
            "mc_idct_recon_skip": (
                targs,
                lambda: idct_cuda.mc_idct_recon_skip(*targs),
                k1_chain,
                lambda: tail_chain(t, geom, q, False, True, tail_outputs(t),
                                   True)),
        }
        for entry, (args, fused, chain, plain) in entries.items():
            counts = {w: w.launches for w in (
                fdct_cuda.mc_fdct_quantize, fdct_cuda.fdct_quantize,
                qrd_cuda.mc_fdct_quantize_rd, qrd_cuda.fdct_quantize_rd,
                idct_cuda.mc_idct_recon_skip, idct_cuda.idct_recon_choose,
                *mc_cuda.ENTRIES)}
            fused()
            torch.cuda.synchronize()
            row = {"ms_runs": [], "chain_ms_runs": []}
            for who in ("fused", "chain", "chain", "fused"):
                fn = fused if who == "fused" else chain
                row["ms_runs" if who == "fused" else "chain_ms_runs"].append(
                    event_ms(fn, ITERS, flush))
            row["ms"] = sum(row["ms_runs"]) / 2
            row["chain_ms"] = sum(row["chain_ms_runs"]) / 2
            row["plain_ms"] = event_ms(plain, 3, flush)
            row["floor_ms"] = event_ms(lambda: torch.cuda._sleep(0), ITERS,
                                       flush)
            row.update(fused_bound(entry, args))
            for w, c in counts.items():
                w.launches = c
            rows[f"{entry}, {label} ({nv * nh} blocks)"] = row
    return rows


def describe_fused(label: str, r: dict) -> str:
    """One line of a timed_fused row."""
    return (f"{label}: fused {[round(x, 5) for x in r['ms_runs']]} ms, the "
            f"chain it replaced {[round(x, 5) for x in r['chain_ms_runs']]}"
            f" ms (in turns); plain {r['plain_ms']:.4f} ms, empty launch "
            f"{r['floor_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({r['bytes']} B -> {r['bytes_ms']:.5f} ms, "
            f"{r['ops']} ops -> {r['ops_ms']:.5f} ms); fused at "
            f"{100 * r['bound_ms'] / r['ms']:.2f}% of it")


def ptxas(so: str) -> list[str]:
    """The registers and spills lines of a build's ptxas report."""
    with open(so + ".log") as f:
        return [ln.strip() for ln in f.read().splitlines()
                if "registers" in ln or "spill" in ln]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_mc: needs a CUDA card", file=sys.stderr)
        return 2
    from theora_tpu_torch.ops import mc_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, qrd_cuda

    for so in (mc_cuda.build(), fdct_cuda.build(), qrd_cuda.build(),
               idct_cuda.build()):
        for line in ptxas(so):
            print(f"[ks] ptxas {so.rsplit('/', 1)[-1]}: {line}", flush=True)
    n, err = check(dev)
    print(f"[ks] {n} calls: kernel == plain byte for byte (max |err| "
          f"{err}) | {smi}", flush=True)
    nf, errf = check_fused(dev)
    print(f"[ks] {nf} fused cases: mc_fdct_quantize, mc_fdct_quantize_rd "
          f"and mc_idct_recon_skip == their plain and kernel chains byte "
          f"for byte (max |err| {errf}) | {smi}", flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = timed_entries(dev, flush)
    for label, r in rows.items():
        print(f"[ks] {describe(label, r)} | {smi}", flush=True)
    fused = timed_fused(dev, flush)
    for label, r in fused.items():
        print(f"[ks] {describe_fused(label, r)} | {smi}", flush=True)
    print(json.dumps({"card": smi, "calls": n, "fused_cases": nf,
                      "timed": rows, "timed_fused": fused}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
