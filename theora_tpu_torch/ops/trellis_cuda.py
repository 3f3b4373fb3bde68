"""Kernel KT: the hand-written CUDA trellis quantizer (csrc/trellis.cu).

Replaces the encoder's trellis, theora_tpu/ops/transforms_jax.py:
trellis_values (:300), whose forward DP (the lax.scan at :471) and
backtrack (the lax.scan at :527) XLA runs as two 63-step scans; it is not
a Pallas kernel. The plain PyTorch version (ops/transforms.py) runs the
same program as ~6,300 small launches per plane per frame; KT runs it as
one. Its bound is its ~1 KB of memory traffic per block (the float32
work its inputs need, a run ending at each later nonzero position per DP
step, takes less at the card's peak); its design gives each block one
warp, so a step needs no barrier, and keeps the DP's columns in
registers (see the source's note).

Its results must equal the plain version's bit for bit, so every float32
operation is the plain version's, in its order, with XLA's one fused
multiply-add written out as __fmaf_rn; the source is compiled with
``-fmad=false``, so nvcc contracts nothing else. The library is compiled with nvcc for sm_90a
at first use into ``csrc/build/`` and bound with ctypes. The wrapper runs
the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import transforms
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import _check

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "trellis.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_trellis.so")
# No contraction of a*b + c into a fused multiply-add beyond the one the
# source writes out (__fmaf_rn).
NVCC_FLAGS = ("-fmad=false",)

_lib = None


def build() -> str:
    """Compile csrc/trellis.cu when the library is missing or older than
    its source; returns the library path."""
    return nvcc_build(_SRC, _SO, NVCC_FLAGS)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.th_trellis.restype = ctypes.c_int
        lib.th_trellis.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int64, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def trellis_values(dct_zz, qdct_rtn, dequant_zz, lam, nb_full, acmin):
    """The trellis quantizer's chosen values for [N] blocks.

    dct_zz, qdct_rtn, dequant_zz: [N, 64] int32 (unquantized DCT, its
    round-to-nearest quantization, dequant factors; zig-zag); lam: [N]
    float32; nb_full: [64, 32] float32 bits per (position, token); acmin:
    [N] int32. Returns [N, 64] int32 chosen values, DC passed through.
    Same contract as transforms.trellis_values, which is the CPU path.
    """
    n = dct_zz.shape[0]
    dev = dct_zz.device
    _check(dct_zz, "dct_zz", torch.int32, (n, 64), dev)
    _check(qdct_rtn, "qdct_rtn", torch.int32, (n, 64), dev)
    _check(dequant_zz, "dequant_zz", torch.int32, (n, 64), dev)
    _check(lam, "lam", torch.float32, (n,), dev)
    _check(nb_full, "nb_full", torch.float32, (64, 32), dev)
    _check(acmin, "acmin", torch.int32, (n,), dev)
    if dev.type == "cpu":
        return transforms.trellis_values(dct_zz, qdct_rtn, dequant_zz, lam,
                                         nb_full, acmin)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    out = torch.empty((n, 64), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.th_trellis(dct_zz.data_ptr(), qdct_rtn.data_ptr(),
                         dequant_zz.data_ptr(), lam.data_ptr(),
                         nb_full.data_ptr(), acmin.data_ptr(), out.data_ptr(),
                         n, stream)
    if err != 0:
        raise RuntimeError(f"KT trellis launch failed: CUDA error {err}")
    trellis_values.launches += 1
    return out


# Kernel launches made through the wrapper (CPU calls do not count).
trellis_values.launches = 0
