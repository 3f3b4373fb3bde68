"""Kernel K2: the hand-written CUDA fDCT + quantizer (csrc/fdct_quant.cu).

Replaces the Pallas kernel theora_tpu/ops/pallas_kernels.py:
fdct_quantize_soa, whose function the JAX encode scan computes as
`fdct8x8` + `quantize` (theora_tpu/encode/tpu_gop.py:203-218), once per
qi row with adaptive quantization (:249-264): one launch transforms each
block once and quantizes it with each of the K rows. It also returns the
unquantized DCT the trellis reads. The library is compiled with nvcc for
sm_90a at first use into ``csrc/build/`` and bound with ctypes. The
wrapper runs the plain PyTorch version (ops/transforms.py) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
`mc_fdct_quantize`, the encode scan's entry before the trellis (kernel
KT), is the same kernel with kernel KS's MC as its head (csrc/
mc_core.cuh): it makes each block's residual row from the reference
planes, the source and the side rows in registers, so neither the
prediction nor the residual reaches device memory; `fdct_quantize` on a
residual stays the standalone entry (the test hook, the intra paths). At
speed levels 2-4 the block core runs inside kernel KR's fused entries
instead (ops/qrd_cuda.py).
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import mc, transforms
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import MC_CORE, _aligned, _check, \
    segments

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "fdct_quant.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_fdct_quant.so")
# K2's block core, which kernel KR's fused entries share.
CORE = os.path.join(_CSRC, "fdct_core.cuh")

_lib = None


def build() -> str:
    """Compile csrc/fdct_quant.cu when the library is missing or older
    than its source, csrc/fdct_core.cuh or csrc/mc_core.cuh; returns the
    library path."""
    return nvcc_build(_SRC, _SO, deps=(CORE, MC_CORE))


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.th_fdct_quant.restype = ctypes.c_int
        lib.th_fdct_quant.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.th_mc_fdct_quant.restype = ctypes.c_int
        lib.th_mc_fdct_quant.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int64] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        _lib = lib
    return _lib


def fdct_quantize(res, deq, inter):
    """fDCT of [N] blocks of one plane of one frame, and their
    round-to-nearest quantization with each of K qi rows.

    res: [N, 64] int16 residuals, raster order inside each block, 16-byte
    aligned; deq: [K, 2, 64] int16 zig-zag dequant rows (qi row, then
    intra/inter), values in [1, 32767], K in 1..3; inter: [N] uint8.
    With G segments (the mesh encoder's GOPs at one frame step, idct_cuda.
    segments): deq [G, K, 2, 64], block b quantized with segment b // (N /
    G)'s rows. Returns ([K, N, 64] int16 zig-zag quantized, [N, 64] int16
    zig-zag unquantized DCT). Same contract as transforms.fdct_quantize,
    which is the CPU path.
    """
    n = res.shape[0]
    dev = res.device
    _check(res, "res", torch.int16, (n, 64), dev)
    deq4, g, k, nseg = segments(deq, n, dev)
    _check(inter, "inter", torch.uint8, (n,), dev)
    if res.data_ptr() % 16:  # the kernel loads 16-byte vectors
        raise ValueError("res: must be 16-byte aligned")
    if dev.type == "cpu":
        return transforms.fdct_quantize(res, deq, inter)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    qout = torch.empty((k, n, 64), dtype=torch.int16, device=dev)
    dout = torch.empty((n, 64), dtype=torch.int16, device=dev)
    if n == 0:
        return qout, dout
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.th_fdct_quant(res.data_ptr(), deq4.data_ptr(),
                            inter.data_ptr(), qout.data_ptr(),
                            dout.data_ptr(), nseg, k, g, stream)
    if err != 0:
        raise RuntimeError(f"K2 fdct_quant launch failed: CUDA error {err}")
    fdct_quantize.launches += 1
    return qout, dout


# Kernel launches made through the wrapper (CPU calls do not count).
fdct_quantize.launches = 0


def mc_fdct_quantize(prev, gold, cur, side, deq, inter, nv: int, nh: int,
                     pad_y: int, pad_x: int, fid=None):
    """fdct_quantize of the residuals kernel KS's MC makes, in one launch:
    mc_cuda.mc_residual's inputs in place of res (its contract: prev,
    gold [G, Hp, Wp] uint8, gold may be prev; cur [N, 64] uint8; side [6,
    N] int8; fid None or [nl] int32, N = G nl; block b is fragment fid[b
    % nl] (or b % nl) of plane b // nl), then fdct_quantize's deq ([G, K,
    2, 64], or [K, 2, 64] at G = 1) and inter [N] uint8. Returns
    fdct_quantize's ([K, N, 64] int16 quantized, [N, 64] int16 DCT); the
    prediction and the residual stay in registers. The CPU path is the
    plain chain: ops/mc.py:mc_residual, then transforms.fdct_quantize.
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
    for t, name in ((prev, "prev"), (gold, "gold"), (cur, "cur")):
        _aligned(t, name, 8)
    if dev.type == "cpu":
        _, res, _ = mc.mc_residual(prev, gold, cur, side, nv, nh, pad_y,
                                   pad_x, fid)
        return transforms.fdct_quantize(res, deq, inter)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    qout = torch.empty((k, N, 64), dtype=torch.int16, device=dev)
    dout = torch.empty((N, 64), dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.th_mc_fdct_quant(
        prev.data_ptr(), gold.data_ptr(), cur.data_ptr(), side.data_ptr(),
        None if fid is None else fid.data_ptr(), deq4.data_ptr(),
        inter.data_ptr(), qout.data_ptr(), dout.data_ptr(), nl, k, G, hp, wp,
        nv, nh, pad_y, pad_x, stream)
    if err != 0:
        raise RuntimeError(f"K2 mc_fdct_quant launch failed: CUDA error "
                           f"{err}")
    mc_fdct_quantize.launches += 1
    return qout, dout


# Kernel launches made through the wrapper (CPU calls do not count).
mc_fdct_quantize.launches = 0
