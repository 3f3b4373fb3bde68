"""Kernel KT: the hand-written CUDA trellis quantizer (csrc/trellis.cu).

Replaces the encoder's trellis, theora_tpu/ops/transforms_jax.py:
trellis_values (:300), whose forward DP (the lax.scan at :471) and
backtrack (the lax.scan at :527) XLA runs as two 63-step scans; it is not
a Pallas kernel. It reads kernel K2's outputs as K2 writes them (int16
rows at each of K qi rows, the [K, 2, 64] dequant rows and the inter
flags) with the frame's lambda per qi row and, with adaptive
quantization's activity masking, a lambda scale per block, and writes the
chosen values with their nonzero counts and DC-only flags, which K1 and
the chooser read: one launch per plane per frame whatever K is.
Its bound is its ~390 B of memory traffic per block; its design weighs,
at each DP step, only the positions that can end a run, with 8 lanes per
block (see the source's note).

Its results must equal the plain version's (transforms.trellis_quantize,
the plain trellis_values behind the casts of this interface) bit for bit,
so every float32 operation is the plain version's, in its order, with
XLA's fused multiply-adds written out as __fmaf_rn; the source is
compiled with ``-fmad=false``, so nvcc contracts nothing else. The library
is compiled with nvcc for sm_90a at first use into ``csrc/build/`` and
bound with ctypes. The wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from theora_tpu_torch.ops import transforms
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import MAX_ROWS, _check

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "trellis.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_trellis.so")
# No contraction of a*b + c into a fused multiply-add beyond those the
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
        lib.th_trellis.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_float] * 3 + [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _lambdas(lam, k: int) -> np.ndarray:
    """lam as [k] float32 values, each finite and >= 0."""
    if not isinstance(lam, np.ndarray) or lam.dtype != np.float32:
        raise TypeError(f"lam: expected a float32 numpy array, got "
                        f"{type(lam).__name__} {getattr(lam, 'dtype', '')}")
    if lam.shape != (k,):
        raise ValueError(f"lam: expected shape ({k},), got {lam.shape}")
    if not (np.isfinite(lam).all() and (lam >= 0).all()):
        raise ValueError(f"lam: expected finite values >= 0, got {lam}")
    return lam


def trellis_quantize(qout, dout, deq, inter, lam, nb_full, lam_sc=None):
    """The trellis quantizer's chosen values for [N] blocks of one plane of
    one frame at each of K qi rows, from kernel K2's outputs.

    qout: [K, N, 64] int16 zig-zag round-to-nearest values and dout: [N,
    64] int16 unquantized DCT (fdct_cuda.fdct_quantize's outputs); deq:
    [K, 2, 64] int16 dequant rows (per qi row intra, inter), as K2 takes
    them; inter: [N] uint8, nonzero for an inter block; lam: [K] float32
    numpy array, the frame's lambda per qi row, each finite and >= 0;
    nb_full: [64, 32] float32 bits per (position, token); lam_sc: None or
    [N] float32 lambda scales per block (block n of row k takes the
    float32 product lam[k] * lam_sc[n]). Returns ([K, N, 64] int16 chosen
    values, DC passed through; [K, N] int32 nonzero counts; [K, N] bool,
    True where no AC value is nonzero). Same contract as
    transforms.trellis_quantize, which is the CPU path.
    """
    k, n = (qout.shape[0], qout.shape[1]) if qout.dim() == 3 else (0, 0)
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"qout: expected [K, N, 64] with K in "
                         f"1..{MAX_ROWS}, got {tuple(qout.shape)}")
    dev = qout.device
    _check(qout, "qout", torch.int16, (k, n, 64), dev)
    _check(dout, "dout", torch.int16, (n, 64), dev)
    _check(deq, "deq", torch.int16, (k, 2, 64), dev)
    _check(inter, "inter", torch.uint8, (n,), dev)
    _check(nb_full, "nb_full", torch.float32, (64, 32), dev)
    if lam_sc is not None:
        _check(lam_sc, "lam_sc", torch.float32, (n,), dev)
    for t, name in ((qout, "qout"), (dout, "dout"), (nb_full, "nb_full")):
        if t.data_ptr() % 16:  # the kernel loads 16-byte vectors
            raise ValueError(f"{name}: must be 16-byte aligned")
    lam = _lambdas(lam, k)
    if dev.type == "cpu":
        return transforms.trellis_quantize(qout, dout, deq, inter, lam,
                                           nb_full, lam_sc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    vals = torch.empty((k, n, 64), dtype=torch.int16, device=dev)
    cnt = torch.empty((k, n), dtype=torch.int32, device=dev)
    dc_only = torch.empty((k, n), dtype=torch.bool, device=dev)
    if n == 0:
        return vals, cnt, dc_only
    lams = [float(lam[min(i, k - 1)]) for i in range(MAX_ROWS)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.th_trellis(qout.data_ptr(), dout.data_ptr(), deq.data_ptr(),
                         inter.data_ptr(), *lams,
                         None if lam_sc is None else lam_sc.data_ptr(),
                         nb_full.data_ptr(), vals.data_ptr(), cnt.data_ptr(),
                         dc_only.data_ptr(), n, k, stream)
    if err != 0:
        raise RuntimeError(f"KT trellis launch failed: CUDA error {err}")
    trellis_quantize.launches += 1
    return vals, cnt, dc_only


# Kernel launches made through the wrapper (CPU calls do not count).
trellis_quantize.launches = 0
