"""Kernel KR: the hand-written CUDA R/D quantizer (csrc/quantize_rd.cu).

Replaces the encoder's R/D quantizer, theora_tpu/ops/transforms_jax.py:
quantize_rd (:185), which the JAX encode scan runs in place of the trellis
at speed levels 2-4 and with use_trellis=False (theora_tpu/encode/
tpu_gop.py:230-236); XLA compiles it, it is not a Pallas kernel. Three
entries share one row step (8 lanes per (row, block) pair, the kill
sweeps on 64-bit masks; see the source's note):

- mc_fdct_quantize_rd, the encode scan's: kernel KS's MC row (csrc/
  mc_core.cuh), kernel K2's fDCT and round-to-nearest quantization
  (csrc/fdct_core.cuh) and the row step on the quantized values in
  registers, one launch per plane per frame whatever K is. It reads the
  reference planes, the source and the side rows and writes the values
  with their nonzero counts and DC-only flags, which K1's fused encode
  entry reads; the prediction, the residual and K2's values and DCT
  never reach device memory. fdct_quantize_rd is the same kernel on a
  residual that is given (the chain the fused entry replaced, and its
  test hook; ~133 B per (row, block) pair and 129 B per block).
- quantize_rd, the standalone entry and test hook: the row step on K2's
  outputs as K2 writes them, so that DCT values no residual reaches (the
  FMA near-ties of qrd_fma_cases.npz, the edge classes) test the same
  row step. Off the encode path.

Their results must equal the plain versions' (transforms.fdct_quantize_rd
and transforms.quantize_rd_rows) bit for bit: XLA's three fused
multiply-adds are written out as __fmaf_rn and the source is compiled
with ``-fmad=false``, so nvcc contracts nothing else. The library is
compiled with nvcc for sm_90a at first use into ``csrc/build/`` (again
when the source or csrc/fdct_core.cuh is newer) and bound with ctypes.
The wrappers run the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import mc, transforms
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.fdct_cuda import CORE
from theora_tpu_torch.ops.idct_cuda import MAX_ROWS, MC_CORE, _aligned, \
    _check, segments

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "quantize_rd.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_qrd.so")
# No contraction of a*b + c into a fused multiply-add beyond those the
# source writes out (__fmaf_rn).
NVCC_FLAGS = ("-fmad=false",)

_lib = None


def build() -> str:
    """Compile csrc/quantize_rd.cu when the library is missing or older
    than its source, csrc/fdct_core.cuh or csrc/mc_core.cuh; returns the
    library path."""
    return nvcc_build(_SRC, _SO, NVCC_FLAGS, deps=(CORE, MC_CORE))


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.th_quantize_rd.restype = ctypes.c_int
        lib.th_quantize_rd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.th_fdct_quant_rd.restype = ctypes.c_int
        lib.th_fdct_quant_rd.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.th_mc_fdct_quant_rd.restype = ctypes.c_int
        lib.th_mc_fdct_quant_rd.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_int64] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        _lib = lib
    return _lib


def _outputs(k, n, dev):
    return (torch.empty((k, n, 64), dtype=torch.int16, device=dev),
            torch.empty((k, n), dtype=torch.int32, device=dev),
            torch.empty((k, n), dtype=torch.bool, device=dev))


def quantize_rd(qout, dout, deq, inter, lam_q):
    """The R/D quantizer's values for [N] blocks of one plane of one frame
    at each of K qi rows, from kernel K2's outputs (the standalone entry;
    the encode scan runs fdct_quantize_rd).

    qout: [K, N, 64] int16 zig-zag round-to-nearest values and dout: [N,
    64] int16 unquantized DCT (fdct_cuda.fdct_quantize's outputs); deq:
    [K, 2, 64] int16 dequant rows (per qi row intra, inter), as K2 takes
    them; inter: [N] uint8, nonzero for an inter block; lam_q: [K, 2]
    float32, 8-byte aligned, per qi row the intra and the inter lambda
    (block n takes lam_q[k, inter[n] != 0]). Returns ([K, N, 64] int16
    values, DC passed through; [K, N] int32 nonzero counts; [K, N] bool,
    True where no AC value is nonzero). With G segments (the
    mesh encoder's GOPs at one frame step, idct_cuda.segments): deq [G, K,
    2, 64] and lam_q [G, K, 2], block b taking segment b // (N / G)'s rows
    and lambdas. Same contract as transforms.quantize_rd_rows, which is the
    CPU path.
    """
    k, n = (qout.shape[0], qout.shape[1]) if qout.dim() == 3 else (0, 0)
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"qout: expected [K, N, 64] with K in "
                         f"1..{MAX_ROWS}, got {tuple(qout.shape)}")
    dev = qout.device
    _check(qout, "qout", torch.int16, (k, n, 64), dev)
    _check(dout, "dout", torch.int16, (n, 64), dev)
    deq4, g, kd, nseg = segments(deq, n, dev)
    if kd != k:
        raise ValueError(f"deq: {kd} qi rows for qout's {k}")
    _check(inter, "inter", torch.uint8, (n,), dev)
    _aligned(qout, "qout", 16)
    _aligned(dout, "dout", 16)
    _check(lam_q, "lam_q", torch.float32, tuple(deq.shape[:-2]) + (2,), dev)
    _aligned(lam_q, "lam_q", 8)  # one 8-byte load per (segment, row)
    if dev.type == "cpu":
        return transforms.quantize_rd_rows(qout, dout, deq, inter, lam_q)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    vals, cnt, dc_only = _outputs(k, n, dev)
    if n == 0:
        return vals, cnt, dc_only
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.th_quantize_rd(qout.data_ptr(), dout.data_ptr(),
                             deq4.data_ptr(), inter.data_ptr(),
                             lam_q.data_ptr(), vals.data_ptr(),
                             cnt.data_ptr(), dc_only.data_ptr(), nseg, k, g,
                             stream)
    if err != 0:
        raise RuntimeError(f"KR quantize_rd launch failed: CUDA error {err}")
    quantize_rd.launches += 1
    return vals, cnt, dc_only


# Kernel launches made through the wrapper (CPU calls do not count).
quantize_rd.launches = 0


def fdct_quantize_rd(res, deq, inter, lam_q):
    """Kernel K2's fDCT and quantization of [N] blocks of one plane of one
    frame at each of K qi rows, then the R/D quantizer on them, in one
    launch.

    res: [N, 64] int16 residuals, raster order inside each block, 16-byte
    aligned; deq: [K, 2, 64] int16 zig-zag dequant rows (per qi row intra,
    inter), values in [1, 32767], K in 1..3; inter: [N] uint8; lam_q: [K,
    2] float32, per qi row the intra and the inter lambda (block n takes
    lam_q[k, inter[n] != 0]). With G segments (idct_cuda.segments): deq
    [G, K, 2, 64] and lam_q [G, K, 2], block b taking segment b // (N /
    G)'s rows and lambdas. Returns quantize_rd's ([K, N, 64] int16 values,
    [K, N] int32 nonzero counts, [K, N] bool DC-only flags). Same
    contract as transforms.fdct_quantize_rd, which is the CPU path.
    """
    n = res.shape[0]
    dev = res.device
    _check(res, "res", torch.int16, (n, 64), dev)
    deq4, g, k, nseg = segments(deq, n, dev)
    _check(inter, "inter", torch.uint8, (n,), dev)
    _aligned(res, "res", 16)
    _check(lam_q, "lam_q", torch.float32, tuple(deq.shape[:-2]) + (2,), dev)
    if dev.type == "cpu":
        return transforms.fdct_quantize_rd(res, deq, inter, lam_q)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    vals, cnt, dc_only = _outputs(k, n, dev)
    if n == 0:
        return vals, cnt, dc_only
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.th_fdct_quant_rd(res.data_ptr(), deq4.data_ptr(),
                               inter.data_ptr(), lam_q.data_ptr(),
                               vals.data_ptr(), cnt.data_ptr(),
                               dc_only.data_ptr(), nseg, k, g, stream)
    if err != 0:
        raise RuntimeError(f"KR fdct_quantize_rd launch failed: CUDA error "
                           f"{err}")
    fdct_quantize_rd.launches += 1
    return vals, cnt, dc_only


# Kernel launches made through the wrapper (CPU calls do not count).
fdct_quantize_rd.launches = 0


def mc_fdct_quantize_rd(prev, gold, cur, side, deq, inter, lam_q, nv: int,
                        nh: int, pad_y: int, pad_x: int, fid=None):
    """fdct_quantize_rd of the residuals kernel KS's MC makes, in one
    launch: mc_cuda.mc_residual's inputs in place of res (prev, gold [G,
    Hp, Wp] uint8, gold may be prev; cur [N, 64] uint8; side [6, N] int8;
    fid None or [nl] int32, N = G nl), then fdct_quantize_rd's deq ([G,
    K, 2, 64], or [K, 2, 64] at G = 1), inter [N] uint8 and lam_q ([G, K,
    2] or [K, 2] float32). Returns fdct_quantize_rd's ([K, N, 64] int16
    values, [K, N] int32 counts, [K, N] bool DC-only flags). The CPU path
    is the plain chain: ops/mc.py:mc_residual, then
    transforms.fdct_quantize_rd.
    """
    from theora_tpu_torch.ops import mc_cuda

    G, hp, wp, dev = mc_cuda._planes(prev, gold, nv, nh, pad_y, pad_x, 3)
    nl = mc_cuda._fragments(fid, G, nv * nh, dev)
    N = G * nl
    _check(cur, "cur", torch.uint8, (N, 64), dev)
    _check(side, "side", torch.int8, (6, N), dev)
    deq4, g, k, _ = segments(deq, N, dev)
    if g != G:
        raise ValueError(f"deq: {g} segments for {G} planes")
    _check(inter, "inter", torch.uint8, (N,), dev)
    _check(lam_q, "lam_q", torch.float32, tuple(deq.shape[:-2]) + (2,), dev)
    for t, name in ((prev, "prev"), (gold, "gold"), (cur, "cur")):
        _aligned(t, name, 8)
    if dev.type == "cpu":
        _, res, _ = mc.mc_residual(prev, gold, cur, side, nv, nh, pad_y,
                                   pad_x, fid)
        return transforms.fdct_quantize_rd(res, deq, inter, lam_q)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    vals, cnt, dc_only = _outputs(k, N, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.th_mc_fdct_quant_rd(
        prev.data_ptr(), gold.data_ptr(), cur.data_ptr(), side.data_ptr(),
        None if fid is None else fid.data_ptr(), deq4.data_ptr(),
        inter.data_ptr(), lam_q.data_ptr(), vals.data_ptr(), cnt.data_ptr(),
        dc_only.data_ptr(), nl, k, G, hp, wp, nv, nh, pad_y, pad_x, stream)
    if err != 0:
        raise RuntimeError(f"KR mc_fdct_quantize_rd launch failed: CUDA "
                           f"error {err}")
    mc_fdct_quantize_rd.launches += 1
    return vals, cnt, dc_only


# Kernel launches made through the wrapper (CPU calls do not count).
mc_fdct_quantize_rd.launches = 0
