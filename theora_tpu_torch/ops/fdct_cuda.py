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
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import transforms
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import MAX_ROWS, _check

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "fdct_quant.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_fdct_quant.so")

_lib = None


def build() -> str:
    """Compile csrc/fdct_quant.cu when the library is missing or older
    than its source; returns the library path."""
    return nvcc_build(_SRC, _SO)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.th_fdct_quant.restype = ctypes.c_int
        lib.th_fdct_quant.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def fdct_quantize(res, deq, inter):
    """fDCT of [N] blocks of one plane of one frame, and their
    round-to-nearest quantization with each of K qi rows.

    res: [N, 64] int16 residuals, raster order inside each block, 16-byte
    aligned; deq: [K, 2, 64] int16 zig-zag dequant rows (qi row, then
    intra/inter), values in [1, 32767], K in 1..3; inter: [N] uint8.
    Returns ([K, N, 64] int16 zig-zag quantized, [N, 64] int16 zig-zag
    unquantized DCT). Same contract as transforms.fdct_quantize, which is
    the CPU path.
    """
    n = res.shape[0]
    dev = res.device
    _check(res, "res", torch.int16, (n, 64), dev)
    k = deq.shape[0] if deq.dim() == 3 else 0
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"deq: expected [K, 2, 64] with K in 1..{MAX_ROWS},"
                         f" got {tuple(deq.shape)}")
    _check(deq, "deq", torch.int16, (k, 2, 64), dev)
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
    err = lib.th_fdct_quant(res.data_ptr(), deq.data_ptr(), inter.data_ptr(),
                            qout.data_ptr(), dout.data_ptr(), n, k, stream)
    if err != 0:
        raise RuntimeError(f"K2 fdct_quant launch failed: CUDA error {err}")
    fdct_quantize.launches += 1
    return qout, dout


# Kernel launches made through the wrapper (CPU calls do not count).
fdct_quantize.launches = 0
