"""Kernel KP: the hand-written CUDA postprocessor (csrc/postproc.cu).

The decoder's out-of-loop deblock + dering (pp levels 2-7), which the JAX
package runs on the host (theora_tpu/ops/postproc_np.py:273
postprocess_plane; no Pallas kernel), on the card where the decoded
frames already are: two launches per postprocessed plane, the deblock
(one CTA per block row) and, where the level asks for it, the dering (one
warp per block row, rows by an atomic ticket, a row waiting on the row
above only where the block above it is filtered), not one launch per
wave of blocks. Its output must equal the plain version's,
ops/postproc.py:postprocess_plane, byte for byte. The library is compiled
with nvcc for sm_90a at first use into ``csrc/build/`` and bound with
ctypes. The wrapper runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernels or raises. The library also
holds th_pp_step_probe, which tools/bench_pp.py times for KP's bound.
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import postproc
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import _check

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "postproc.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_postproc.so")

# Widest plane the deblock's per-CTA variance row holds (KP_MAX_NH blocks).
MAX_WIDTH = 16384

_lib = None


def build() -> str:
    """Compile csrc/postproc.cu when the library is missing or older than
    its source; returns the library path."""
    return nvcc_build(_SRC, _SO)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.th_pp_deblock.restype = i32
        lib.th_pp_deblock.argtypes = [ptr, i32, ptr, i32, ptr, i32] + [
            ptr] * 4 + [i32, i32, ptr]
        lib.th_pp_dering.restype = i32
        lib.th_pp_dering.argtypes = [ptr, i32, ptr, i32] + [ptr] * 5 + [
            i32] * 4 + [ptr]
        lib.th_pp_step_probe.restype = i32
        lib.th_pp_step_probe.argtypes = [ptr, ptr, i32, ptr]
        _lib = lib
    return _lib


def _plane(t, name: str, shape, device) -> None:
    """A uint8 [h, w] plane with unit column stride (rows may be strided,
    as a view of a padded plane is)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.uint8:
        raise TypeError(f"{name}: expected torch.uint8, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.stride(1) != 1 or t.stride(0) < shape[1]:
        raise ValueError(f"{name}: rows must be contiguous")


def postprocess_plane(src, dc_qis, qi, dc_scale, sharp, dering: bool,
                      strong: bool, pli: int, out=None):
    """Deblock, then dering where asked, one plane: src [h, w] uint8 (h, w
    multiples of 8, w <= 16384; a row-strided view, such as a padded
    plane's image, is taken as it is), dc_qis and qi [nv, nh] uint8 (qi
    0..63; on the card an index outside traps), dc_scale and sharp [64]
    int32, all on one device. Writes the result into out ([h, w] uint8,
    rows contiguous, not overlapping src) when given, else a new tensor,
    and returns it. Equals postproc.postprocess_plane, which is the CPU
    path."""
    if not isinstance(src, torch.Tensor) or src.dim() != 2:
        raise ValueError("src: expected an [h, w] tensor")
    dev = src.device
    h, w = src.shape
    if h < 8 or w < 8 or h % 8 or w % 8 or w > MAX_WIDTH:
        raise ValueError(f"src {tuple(src.shape)}: h and w must be "
                         f"multiples of 8, w at most {MAX_WIDTH}")
    nv, nh = h >> 3, w >> 3
    _plane(src, "src", (h, w), dev)
    _check(dc_qis, "dc_qis", torch.uint8, (nv, nh), dev)
    _check(qi, "qi", torch.uint8, (nv, nh), dev)
    _check(dc_scale, "dc_scale", torch.int32, (64,), dev)
    _check(sharp, "sharp", torch.int32, (64,), dev)
    if out is not None:
        _plane(out, "out", (h, w), dev)
    if dev.type == "cpu":
        res = postproc.postprocess_plane(src, dc_qis, qi, dc_scale, sharp,
                                         dering, strong, pli)
        if out is None:
            return res
        out.copy_(res)
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if out is None:
        out = torch.empty((h, w), dtype=torch.uint8, device=dev)
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    var = torch.empty((nv, nh), dtype=torch.int32, device=dev)
    counters = torch.empty(1 + nv, dtype=torch.int32, device=dev)
    deblocked = torch.empty((h, w), dtype=torch.uint8, device=dev) \
        if dering else out
    err = lib.th_pp_deblock(
        src.data_ptr(), src.stride(0), deblocked.data_ptr(),
        deblocked.stride(0), out.data_ptr() if dering else None,
        out.stride(0), dc_qis.data_ptr(), dc_scale.data_ptr(),
        var.data_ptr(), counters.data_ptr(), h, w, stream)
    if err != 0:
        raise RuntimeError(f"KP deblock launch failed: CUDA error {err}")
    postprocess_plane.launches += 1
    if dering:
        err = lib.th_pp_dering(
            deblocked.data_ptr(), deblocked.stride(0), out.data_ptr(),
            out.stride(0), var.data_ptr(), qi.data_ptr(),
            dc_scale.data_ptr(), sharp.data_ptr(), counters.data_ptr(),
            nv, nh, int(bool(strong)), int(pli), stream)
        if err != 0:
            raise RuntimeError(f"KP dering launch failed: CUDA error {err}")
        postprocess_plane.launches += 1
    return out


# Kernel launches made through the wrapper on the card: one for the
# deblock, one more for the dering (CPU calls do not count).
postprocess_plane.launches = 0
