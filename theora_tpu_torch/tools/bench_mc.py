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
(ks_bound). Needs a CUDA card. Prints one JSON summary as its last line.

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
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        err = max(err, int((g.int() - w.int()).abs().max()))
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:4].tolist()
            raise AssertionError(f"KS {entry} != plain on {label}: output "
                                 f"{i} at {bad}")
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
        side = args[3].cpu().numpy()
        refs = int((side[0] != 0).sum() + ((side[0] != 0) & (side[5] != 0))
                   .sum())
        n = side.shape[1]
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
    for line in ptxas(mc_cuda.build()):
        print(f"[ks] ptxas: {line}", flush=True)
    n, err = check(dev)
    print(f"[ks] {n} calls: kernel == plain byte for byte (max |err| "
          f"{err}) | {smi}", flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = timed_entries(dev, flush)
    for label, r in rows.items():
        print(f"[ks] {describe(label, r)} | {smi}", flush=True)
    print(json.dumps({"card": smi, "calls": n, "timed": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
