"""Kernel KL: the hand-written CUDA loop filter (csrc/loopfilter.cu).

Replaces the in-loop deblocking filter, theora_tpu/ops/loopfilter_jax.py:
loop_filter_plane_jax (:71), which XLA compiles on the TPU (no Pallas
kernel): one launch per plane, or per stack of G planes (the mesh
encoder's GOPs at one frame step), in place of the plain version's ~260
PyTorch launches. One CTA per (fragment row, plane) computes the plain
version's phases B and A for its rows from the pre-filter rows it stages
(see the source's note); a launch's latency, not its bytes, bounds it
(tools/bench_loopfilter.py:kl_bound).

Its output must equal the plain version's (ops/loopfilter.py:
loop_filter_plane) byte for byte. The library is compiled with nvcc for
sm_90a at first use into ``csrc/build/`` and bound with ctypes. The
wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import loopfilter
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import _aligned, _check

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "loopfilter.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_loopfilter.so")

_lib = None


def build() -> str:
    """Compile csrc/loopfilter.cu when the library is missing or older than
    its source; returns the library path."""
    return nvcc_build(_SRC, _SO)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.th_loop_filter.restype = i32
        lib.th_loop_filter.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
        _lib = lib
    return _lib


def loop_filter_plane(plane, coded, limit, nv: int, nh: int, pad_y: int,
                      pad_x: int):
    """The filtered plane, a new tensor: plane [Hp, Wp] uint8, coded [nv,
    nh] bool, limit an int (the frame's loop-filter limit; 0 filters
    nothing); or G planes [G, Hp, Wp], coded [G, nv, nh] and limit a [G]
    int32 tensor on the planes' device, one per plane. The image starts
    at (pad_y, pad_x): pad_x a multiple of 8 from 8 on, pad_y >= 2, Wp a
    multiple of 8 with Wp >= pad_x + 8 nh, Hp >= pad_y + 8 nv + 2. Same
    contract as loopfilter.loop_filter_plane, which is the CPU path."""
    if not isinstance(plane, torch.Tensor) or plane.dim() not in (2, 3):
        raise ValueError("plane: expected an [Hp, Wp] or [G, Hp, Wp] tensor")
    dev = plane.device
    G = plane.shape[0] if plane.dim() == 3 else 1
    hp, wp = plane.shape[-2:]
    if (nv < 1 or nh < 1 or pad_y < 2 or pad_x < 8 or pad_x % 8 or wp % 8
            or wp < pad_x + 8 * nh or hp < pad_y + 8 * nv + 2):
        raise ValueError(f"plane {tuple(plane.shape)} does not hold a {nv} x "
                         f"{nh} fragment grid at padding ({pad_y}, {pad_x})")
    _check(plane, "plane", torch.uint8, tuple(plane.shape), dev)
    if plane.dim() == 2:
        _check(coded, "coded", torch.bool, (nv, nh), dev)
        if isinstance(limit, torch.Tensor):
            raise TypeError("limit: one plane takes an int")
        limit = int(limit)
    else:
        _check(coded, "coded", torch.bool, (G, nv, nh), dev)
        _check(limit, "limit", torch.int32, (G,), dev)
    if dev.type == "cpu":
        return loopfilter.loop_filter_plane(plane, coded, limit, nv, nh,
                                            pad_y, pad_x)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _aligned(plane, "plane", 4)
    out = torch.empty_like(plane)
    by_tensor = plane.dim() == 3
    err = _load().th_loop_filter(
        plane.data_ptr(), out.data_ptr(), coded.data_ptr(),
        limit.data_ptr() if by_tensor else None,
        0 if by_tensor else limit, G, hp, wp, nv, nh, pad_y, pad_x,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:  # also more than 65535 planes, or rows too wide to stage
        raise RuntimeError(f"KL launch failed: CUDA error {err}")
    loop_filter_plane.launches += 1
    return out


# Kernel launches made through the wrapper, one per call on the card (CPU
# calls do not count).
loop_filter_plane.launches = 0
