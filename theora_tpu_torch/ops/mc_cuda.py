"""Kernel KS: the hand-written CUDA MC, skip test and plane assembly
(csrc/mc.cu).

Replaces the steps of the JAX scans that XLA compiles on the TPU (no
Pallas kernel) around the transform kernels: the encode scan's MC and
residual (theora_tpu/encode/tpu_gop.py:182-200, ops/mc_jax.py:38
block_neighborhoods, :72 mc_select2), its R/D skip test and the plane's
assembly with the UMV borders (tpu_gop.py:286-313, mc_jax.py:107
blocks_to_plane, theora_tpu/pipeline.py:122 fill_borders), and the decode
step's reconstruction (theora_tpu/decode/tpu_batch.py:114-128). Entries,
one launch each: `mc_residual` (MC before K2 or KR), `skip_place` (the
skip test and the plane after K1; over a frag group `skip_rows` before
the all-gather and `place_rows` after it) and `mc_recon` (per plane per
decoded frame), in place of the ~50 PyTorch launches of the plain chains.
8 lanes per fragment, a lane per row; bytes bound it
(tools/bench_mc.py:ks_bound; see the source's note). The encode scan
launches only `place_rows` of them, after a frag group's gather: KS's row
core (csrc/mc_core.cuh) runs inside K2's and KR's fused entries
(fdct_cuda.mc_fdct_quantize, qrd_cuda.mc_fdct_quantize_rd) and K1's
(idct_cuda.mc_idct_recon_skip, which writes the skip_rows form over a
frag group); `mc_residual`, `skip_place` and `skip_rows` stay as the
chain those entries replaced and its test hooks.

Each output must equal the plain version's (ops/mc.py, the entry of the
same name) byte for byte, the planes' padding included. The library is
compiled with nvcc for sm_90a at first use into ``csrc/build/`` and bound
with ctypes. A wrapper runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. Each counts its
launches (`<entry>.launches`).
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import mc
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import MC_CORE, _COUNT_LOCK, _aligned, \
    _check

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "mc.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_mc.so")
# The most blocks one launch takes (8 lanes each in a 32-bit index).
MAX_BLOCKS = 1 << 27

_lib = None


def build() -> str:
    """Compile csrc/mc.cu when the library is missing or older than its
    source or csrc/mc_core.cuh; returns the library path."""
    return nvcc_build(_SRC, _SO, deps=(MC_CORE,))


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.th_mc_residual.restype = i32
        lib.th_mc_residual.argtypes = [ptr] * 5 + [i32] * 8 + [ptr] * 4
        lib.th_skip.restype = i32
        lib.th_skip.argtypes = [ptr] * 8 + [i32, ptr] + [i32] * 8 + \
            [ptr] * 4 + [i32, ptr]
        lib.th_place.restype = i32
        lib.th_place.argtypes = [ptr] + [i32] * 7 + [ptr] * 2 + [i32, ptr]
        lib.th_mc_recon.restype = i32
        lib.th_mc_recon.argtypes = [ptr] * 4 + [i32] * 6 + [ptr] * 2 + \
            [i32, ptr]
        _lib = lib
    return _lib


def _planes(prev, gold, nv: int, nh: int, pad_y: int, pad_x: int,
            dims: int) -> tuple:
    """Checks the reference planes ([G, Hp, Wp] at dims 3, [Hp, Wp] at
    2) and the geometry; returns (G, Hp, Wp, device)."""
    if not isinstance(prev, torch.Tensor) or prev.dim() != dims:
        raise ValueError(f"prev: expected a {dims}-d uint8 plane tensor")
    hp, wp = prev.shape[-2:]
    if (nv < 1 or nh < 1 or pad_y < 2 or pad_x < 8 or pad_x % 8
            or hp != 8 * nv + 2 * pad_y or wp != 8 * nh + 2 * pad_x):
        raise ValueError(f"plane {tuple(prev.shape)} is not a {nv} x {nh} "
                         f"fragment grid padded by ({pad_y}, {pad_x})")
    dev = prev.device
    _check(prev, "prev", torch.uint8, tuple(prev.shape), dev)
    _check(gold, "gold", torch.uint8, tuple(prev.shape), dev)
    G = prev.shape[0] if dims == 3 else 1
    return G, hp, wp, dev


def _fragments(fid, G: int, n: int, dev) -> int:
    """The blocks per plane of an encode launch: n, or fid's length."""
    if fid is None:
        nl = n
    else:
        if not isinstance(fid, torch.Tensor) or fid.dim() != 1:
            raise ValueError("fid: expected an [nl] int32 tensor")
        nl = fid.shape[0]
        _check(fid, "fid", torch.int32, (nl,), dev)
        if not 1 <= nl <= n:
            raise ValueError(f"fid: {nl} fragment ids for {n} fragments")
    if G * nl > MAX_BLOCKS:
        raise ValueError(f"{G * nl} blocks in one launch; at most "
                         f"{MAX_BLOCKS}")
    return nl


def _device(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"KS {entry} launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def mc_residual(prev, gold, cur, side, nv: int, nh: int, pad_y: int,
                pad_x: int, fid=None):
    """The encode scan's MC step: (pred [N, 64] int32, res [N, 64] int16,
    ssd_unc [N] int32) for N = G nl blocks; ops/mc.py:mc_residual's
    contract, which is the CPU path. prev, gold [G, Hp, Wp] uint8 (gold
    may be prev), cur [N, 64] uint8, side [6, N] int8, fid None or [nl]
    int32. Hp = 8 nv + 2 pad_y, Wp = 8 nh + 2 pad_x, pad_x a multiple of 8
    from 8 on, pad_y >= 2. An offset that reads outside its padded plane
    traps the kernel (the CPU path's indexing raises)."""
    G, hp, wp, dev = _planes(prev, gold, nv, nh, pad_y, pad_x, 3)
    nl = _fragments(fid, G, nv * nh, dev)
    N = G * nl
    _check(cur, "cur", torch.uint8, (N, 64), dev)
    _check(side, "side", torch.int8, (6, N), dev)
    if dev.type == "cpu":
        return mc.mc_residual(prev, gold, cur, side, nv, nh, pad_y, pad_x,
                              fid)
    _device(dev)
    for t, name, a in ((prev, "prev", 8), (gold, "gold", 8), (cur, "cur", 8)):
        _aligned(t, name, a)
    pred = torch.empty((N, 64), dtype=torch.int32, device=dev)
    res = torch.empty((N, 64), dtype=torch.int16, device=dev)
    ssd = torch.empty((N,), dtype=torch.int32, device=dev)
    _raise(_load().th_mc_residual(
        prev.data_ptr(), gold.data_ptr(), cur.data_ptr(), side.data_ptr(),
        _ptr(fid), nl, G, hp, wp, nv, nh, pad_y, pad_x, pred.data_ptr(),
        res.data_ptr(), ssd.data_ptr(), _stream(dev)), "mc_residual")
    with _COUNT_LOCK:
        mc_residual.launches += 1
    return pred, res, ssd


def _skip_inputs(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam, qout,
                 coded, nv, nh, pad_y, pad_x, fid):
    G, hp, wp, dev = _planes(prev, prev, nv, nh, pad_y, pad_x, 3)
    nl = _fragments(fid, G, nv * nh, dev)
    N = G * nl
    for t, name, dtype, shape in (
            (recon, "recon", torch.uint8, (N, 64)),
            (q16, "q16", torch.int16, (N, 64)),
            (ssd_rec, "ssd_rec", torch.int32, (N,)),
            (ssd_unc, "ssd_unc", torch.int32, (N,)),
            (cnt, "cnt", torch.int32, (N,)),
            (ms, "ms", torch.bool, (N,)),
            (lam, "lam", torch.float32, (G,)),
            (qout, "qout", torch.int16, (N, 64)),
            (coded, "coded", torch.bool, (N,))):
        _check(t, name, dtype, shape, dev)
    if dev.type != "cpu":
        _device(dev)
        for t, name, a in ((prev, "prev", 8), (recon, "recon", 8),
                           (q16, "q16", 16), (qout, "qout", 16)):
            _aligned(t, name, a)
    return G, hp, wp, nl, N, dev


def _launch_skip(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam, intra,
                 fid, nl, G, hp, wp, nv, nh, pad_y, pad_x, qout, coded,
                 plane, rows, borders, dev, entry):
    _raise(_load().th_skip(
        prev.data_ptr(), recon.data_ptr(), q16.data_ptr(),
        ssd_rec.data_ptr(), ssd_unc.data_ptr(), cnt.data_ptr(),
        ms.data_ptr(), lam.data_ptr(), int(bool(intra)), _ptr(fid), nl, G,
        hp, wp, nv, nh, pad_y, pad_x, qout.data_ptr(), coded.data_ptr(),
        _ptr(plane), _ptr(rows), int(bool(borders)), _stream(dev)), entry)


def skip_place(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam,
               intra: bool, qout, coded, nv: int, nh: int, pad_y: int,
               pad_x: int, borders: bool):
    """The encode scan's R/D skip test and the new [G, Hp, Wp] plane of
    the kept blocks, its padding the UMV borders when borders (a step no
    GOP filters), else zeros (KL fills them); writes qout and coded in
    place. ops/mc.py:skip_place's contract, which is the CPU path; the
    blocks are every fragment of prev's G planes (N = G nv nh)."""
    G, hp, wp, nl, N, dev = _skip_inputs(
        prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam, qout, coded, nv,
        nh, pad_y, pad_x, None)
    if dev.type == "cpu":
        return mc.skip_place(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms,
                             lam, intra, qout, coded, nv, nh, pad_y, pad_x,
                             borders)
    plane = torch.empty_like(prev)
    _launch_skip(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam, intra,
                 None, nl, G, hp, wp, nv, nh, pad_y, pad_x, qout, coded,
                 plane, None, borders, dev, "skip_place")
    with _COUNT_LOCK:
        skip_place.launches += 1
    return plane


def skip_rows(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam,
              intra: bool, qout, coded, nv: int, nh: int, pad_y: int,
              pad_x: int, fid=None):
    """skip_place's decision form, for a frag group's share (fid): writes
    qout and coded in place and returns the [N, 65] uint8 rows of the
    kept blocks and their coded flags, the all-gather's input.
    ops/mc.py:skip_rows's contract, which is the CPU path."""
    G, hp, wp, nl, N, dev = _skip_inputs(
        prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam, qout, coded, nv,
        nh, pad_y, pad_x, fid)
    if dev.type == "cpu":
        return mc.skip_rows(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms,
                            lam, intra, qout, coded, nv, nh, pad_y, pad_x,
                            fid)
    rows = torch.empty((N, 65), dtype=torch.uint8, device=dev)
    _launch_skip(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam, intra,
                 fid, nl, G, hp, wp, nv, nh, pad_y, pad_x, qout, coded, None,
                 rows, False, dev, "skip_rows")
    with _COUNT_LOCK:
        skip_rows.launches += 1
    return rows


def place_rows(rows, G: int, nv: int, nh: int, pad_y: int, pad_x: int,
               borders: bool):
    """skip_place's place form: the gathered [G nv nh, 65] rows -> (a new
    [G, Hp, Wp] plane, coded [G nv nh] bool). ops/mc.py:place_rows's
    contract, which is the CPU path."""
    if not isinstance(rows, torch.Tensor):
        raise TypeError("rows: expected a tensor")
    if G < 1 or nv < 1 or nh < 1 or pad_y < 2 or pad_x < 8 or pad_x % 8:
        raise ValueError(f"{G} planes of {nv} x {nh} fragments padded by "
                         f"({pad_y}, {pad_x})")
    N = G * nv * nh
    if N > MAX_BLOCKS:
        raise ValueError(f"{N} blocks in one launch; at most {MAX_BLOCKS}")
    dev = rows.device
    _check(rows, "rows", torch.uint8, (N, 65), dev)
    if dev.type == "cpu":
        return mc.place_rows(rows, G, nv, nh, pad_y, pad_x, borders)
    _device(dev)
    hp, wp = 8 * nv + 2 * pad_y, 8 * nh + 2 * pad_x
    plane = torch.empty((G, hp, wp), dtype=torch.uint8, device=dev)
    coded = torch.empty((N,), dtype=torch.bool, device=dev)
    _raise(_load().th_place(
        rows.data_ptr(), G, hp, wp, nv, nh, pad_y, pad_x, plane.data_ptr(),
        coded.data_ptr(), int(bool(borders)), _stream(dev)), "place_rows")
    with _COUNT_LOCK:
        place_rows.launches += 1
    return plane, coded


def mc_recon(prev, gold, resid, side, nv: int, nh: int, pad_y: int,
             pad_x: int, borders: bool, pic=None):
    """The decode step of one plane of a frame: the new [Hp, Wp] plane of
    clamp(resid + prediction, 0, 255), its padding the UMV borders when
    borders (a frame that is not filtered), else zeros (KL fills them);
    with pic, [8 nv, 8 nh] uint8, also the picture region into it.
    ops/mc.py:mc_recon's contract, which is the CPU path. prev, gold [Hp,
    Wp] uint8, resid [nv nh, 64] int16, side [6, nv nh] int8."""
    _, hp, wp, dev = _planes(prev, gold, nv, nh, pad_y, pad_x, 2)
    n = nv * nh
    if n > MAX_BLOCKS:
        raise ValueError(f"{n} blocks in one launch; at most {MAX_BLOCKS}")
    _check(resid, "resid", torch.int16, (n, 64), dev)
    _check(side, "side", torch.int8, (6, n), dev)
    if pic is not None:
        _check(pic, "pic", torch.uint8, (8 * nv, 8 * nh), dev)
    if dev.type == "cpu":
        return mc.mc_recon(prev, gold, resid, side, nv, nh, pad_y, pad_x,
                           borders, pic)
    _device(dev)
    for t, name, a in ((prev, "prev", 8), (gold, "gold", 8),
                       (resid, "resid", 16)):
        _aligned(t, name, a)
    if pic is not None:
        _aligned(pic, "pic", 8)
    plane = torch.empty_like(prev)
    _raise(_load().th_mc_recon(
        prev.data_ptr(), gold.data_ptr(), resid.data_ptr(), side.data_ptr(),
        hp, wp, nv, nh, pad_y, pad_x, plane.data_ptr(), _ptr(pic),
        int(bool(borders)), _stream(dev)), "mc_recon")
    with _COUNT_LOCK:
        mc_recon.launches += 1
    return plane


# Kernel launches made through each wrapper, one per call on the card (CPU
# calls do not count).
mc_residual.launches = 0
skip_place.launches = 0
skip_rows.launches = 0
place_rows.launches = 0
mc_recon.launches = 0
ENTRIES = (mc_residual, skip_place, skip_rows, place_rows, mc_recon)
