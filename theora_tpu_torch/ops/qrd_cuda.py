"""Kernel KR: the hand-written CUDA R/D quantizer (csrc/quantize_rd.cu).

Replaces the encoder's R/D quantizer, theora_tpu/ops/transforms_jax.py:
quantize_rd (:185), which the JAX encode scan runs in place of the trellis
at speed levels 2-4 and with use_trellis=False (theora_tpu/encode/
tpu_gop.py:230-236); XLA compiles it, it is not a Pallas kernel. It sits
in kernel KT's slot with KT's output contract: it reads kernel K2's
outputs as K2 writes them (int16 rows at each of K qi rows, the [K, 2,
64] dequant rows and the inter flags) with each row's intra and inter
lambda, and writes the values with their nonzero counts and DC-only
flags, which K1's encode entry reads: one launch per plane per frame
whatever K is. Its bound is its ~390 B of memory traffic per (row, block)
pair; 8 lanes per pair decide their positions, and the kill sweeps run on
64-bit masks (see the source's note).

Its results must equal the plain version's (transforms.quantize_rd_rows)
bit for bit: XLA's three fused multiply-adds are written out as
__fmaf_rn and the source is compiled with ``-fmad=false``, so nvcc
contracts nothing else. The library is compiled with nvcc for sm_90a at
first use into ``csrc/build/`` and bound with ctypes. The wrapper runs the
plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import transforms
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import MAX_ROWS, _aligned, _check, \
    segments

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
    than its source; returns the library path."""
    return nvcc_build(_SRC, _SO, NVCC_FLAGS)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.th_quantize_rd.restype = ctypes.c_int
        lib.th_quantize_rd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def quantize_rd(qout, dout, deq, inter, lam_q):
    """The R/D quantizer's values for [N] blocks of one plane of one frame
    at each of K qi rows, from kernel K2's outputs.

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
    vals = torch.empty((k, n, 64), dtype=torch.int16, device=dev)
    cnt = torch.empty((k, n), dtype=torch.int32, device=dev)
    dc_only = torch.empty((k, n), dtype=torch.bool, device=dev)
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
