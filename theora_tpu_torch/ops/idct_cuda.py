"""Kernel K1: the hand-written CUDA dequant + iDCT (csrc/idct.cu).

Replaces the Pallas kernel theora_tpu/ops/pallas_kernels.py:idct8x8_soa
and the dequant/DC steps around it in the decode scan. The library is
compiled with nvcc for sm_90a at first use into ``csrc/build/`` and bound
with ctypes (plain C interface). The wrapper runs the plain PyTorch
version (ops/transforms.py) only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import transforms
from theora_tpu_torch.ops.cuda_build import nvcc_build

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "idct.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_idct.so")

_lib = None


def build() -> str:
    """Compile csrc/idct.cu when the library is missing or older than its
    source; returns the library path."""
    return nvcc_build(_SRC, _SO)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.th_dequant_idct.restype = ctypes.c_int
        lib.th_dequant_idct.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def dequantize_idct_frames(qz, dc, deq_tab, frame, qii, inter, dc_only):
    """Dequant + iDCT of [N] blocks of F frames of one plane.

    qz: [N, 64] int16 zig-zag (DC slot ignored); dc: [N] int16 predicted
    DC; deq_tab: [F, 3, 2, 64] int16; frame: [N] int32; qii, inter: [N]
    uint8; dc_only: [N] bool. Returns [N, 64] int16 residuals, raster
    order inside each block. Same contract as
    transforms.dequantize_idct_frames, which is the CPU path.
    """
    n = qz.shape[0]
    dev = qz.device
    _check(qz, "qz", torch.int16, (n, 64), dev)
    _check(dc, "dc", torch.int16, (n,), dev)
    if deq_tab.dim() != 4:
        raise ValueError("deq_tab: expected [F, 3, 2, 64]")
    _check(deq_tab, "deq_tab", torch.int16, (deq_tab.shape[0], 3, 2, 64), dev)
    _check(frame, "frame", torch.int32, (n,), dev)
    _check(qii, "qii", torch.uint8, (n,), dev)
    _check(inter, "inter", torch.uint8, (n,), dev)
    _check(dc_only, "dc_only", torch.bool, (n,), dev)
    if dev.type == "cpu":
        return transforms.dequantize_idct_frames(
            qz, dc, deq_tab, frame, qii, inter, dc_only
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    out = torch.empty((n, 64), dtype=torch.int16, device=dev)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.th_dequant_idct(
        qz.data_ptr(), dc.data_ptr(), deq_tab.data_ptr(), frame.data_ptr(),
        qii.data_ptr(), inter.data_ptr(), dc_only.data_ptr(), out.data_ptr(),
        n, stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 dequant_idct launch failed: CUDA error {err}")
    dequantize_idct_frames.launches += 1
    return out


# Kernel launches made through the wrapper (CPU calls do not count).
dequantize_idct_frames.launches = 0
