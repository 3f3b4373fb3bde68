"""Kernel KP: the hand-written CUDA postprocessor (csrc/postproc.cu).

The decoder's out-of-loop deblock + dering (pp levels 2-7), which the JAX
package runs on the host (theora_tpu/ops/postproc_np.py:273
postprocess_plane; no Pallas kernel), on the card where the decoded
frames already are. KP is out of loop, so the decoder postprocesses a
plane's frames of a whole batch at once (postprocess_frames): one deblock
launch over all their block rows (a CTA per block row and frame) and,
where any frame derings, one dering launch (a warp per block row and
frame, rows by an atomic ticket, a row waiting on the row above only
where the block above it is filtered). postprocess_plane is the one-frame
entry, the test hook and the chain tools/bench_pp.py times. The output
must equal the plain version's, ops/postproc.py:postprocess_plane, byte
for byte. The frames' descriptors reach the kernels by value (a struct
kernel parameter of at most MAX_FRAMES frames). The library is compiled
with nvcc for sm_90a at first use into ``csrc/build/`` and bound with
ctypes. The wrappers run the plain version only for tensors on the CPU;
for CUDA tensors they launch the kernels or raise. The library also holds
th_pp_step_probe, which tools/bench_pp.py times for KP's bound.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from theora_tpu_torch.ops import postproc
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import _check

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "postproc.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_postproc.so")

# Widest plane the kernels take (KP_MAX_NH blocks: the dering's plan row,
# the deblock's 108 bytes of shared memory per block column).
MAX_WIDTH = 16384
# Frames in one launch (KP_MAX_FRAMES descriptors in the kernel parameter);
# postprocess_frames splits a longer list into launches of this many.
MAX_FRAMES = 32


class KPFrame(ctypes.Structure):
    """csrc/postproc.cu's KPFrame: one frame's source plane (base pointer,
    row stride in bytes), its index into out and the qi grids, and its
    flags (1: dering, 2: strong); the slot is assigned by the library."""
    _fields_ = [("src", ctypes.c_void_p), ("ss", ctypes.c_longlong),
                ("frame", ctypes.c_int), ("slot", ctypes.c_int),
                ("flags", ctypes.c_int)]


class KPPlanes(ctypes.Structure):
    """csrc/postproc.cu's KPPlanes: what a launch's frames share."""
    _fields_ = [("out", ctypes.c_void_p), ("out_fs", ctypes.c_longlong),
                ("dcq", ctypes.c_void_p), ("dcq_fs", ctypes.c_longlong),
                ("qi", ctypes.c_void_p), ("qi_fs", ctypes.c_longlong),
                ("scale", ctypes.c_void_p), ("sharp", ctypes.c_void_p),
                ("deb", ctypes.c_void_p), ("var", ctypes.c_void_p),
                ("counters", ctypes.c_void_p), ("mail", ctypes.c_void_p),
                ("out_rs", ctypes.c_int),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("nv", ctypes.c_int), ("nh", ctypes.c_int),
                ("pli", ctypes.c_int)]


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
        for name in ("th_pp_deblock", "th_pp_dering"):
            fn = getattr(lib, name)
            fn.restype = i32
            fn.argtypes = [ctypes.POINTER(KPFrame), i32,
                           ctypes.POINTER(KPPlanes), ptr]
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


def _geometry(h: int, w: int, what: str) -> tuple[int, int]:
    if h < 8 or w < 8 or h % 8 or w % 8 or w > MAX_WIDTH:
        raise ValueError(f"{what} {h}x{w}: h and w must be multiples of 8, "
                         f"w at most {MAX_WIDTH}")
    return h >> 3, w >> 3


def _flag(v, name: str) -> bool:
    if not isinstance(v, (bool, np.bool_)):
        raise TypeError(f"{name}: expected a bool, got {type(v).__name__}")
    return bool(v)


def _launch(counter, srcs, frames, flags, out, dcq: int, dcq_fs: int,
            qi: int, qi_fs: int, dc_scale, sharp, pli: int) -> None:
    """KP over the frames, MAX_FRAMES at a time: a deblock launch, then a
    dering launch where a frame derings; counter.launches counts them.
    out is [F, h, w] (rows contiguous); frame f's qi grids are at dcq + f
    dcq_fs and qi + f qi_fs."""
    dev = out.device
    _, h, w = out.shape
    nv, nh = h >> 3, w >> 3
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, len(srcs), MAX_FRAMES):
        part = range(lo, min(lo + MAX_FRAMES, len(srcs)))
        nd = sum(flags[k] & 1 for k in part)
        deb = torch.empty((nd, h, w), dtype=torch.uint8, device=dev)
        var = torch.empty((nd, nv, nh), dtype=torch.int32, device=dev)
        counters = torch.empty(1, dtype=torch.int32, device=dev)
        mail = torch.empty(2 * nd * nv * nh, dtype=torch.int64, device=dev)
        descs = (KPFrame * len(part))(*[
            KPFrame(srcs[k].data_ptr(), srcs[k].stride(0), frames[k], -1,
                    flags[k]) for k in part])
        planes = KPPlanes(out.data_ptr(), out.stride(0), dcq, dcq_fs, qi,
                          qi_fs, dc_scale.data_ptr(), sharp.data_ptr(),
                          deb.data_ptr(), var.data_ptr(),
                          counters.data_ptr(), mail.data_ptr(),
                          out.stride(1), h, w, nv, nh, pli)
        err = lib.th_pp_deblock(descs, len(part), ctypes.byref(planes),
                                stream)
        if err != 0:
            raise RuntimeError(f"KP deblock launch failed: CUDA error {err}")
        counter.launches += 1
        if nd:
            err = lib.th_pp_dering(descs, len(part), ctypes.byref(planes),
                                   stream)
            if err != 0:
                raise RuntimeError(f"KP dering launch failed: CUDA error "
                                   f"{err}")
            counter.launches += 1


def _tables(dc_scale, sharp, dev) -> None:
    _check(dc_scale, "dc_scale", torch.int32, (64,), dev)
    _check(sharp, "sharp", torch.int32, (64,), dev)


def _cuda(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


def postprocess_frames(srcs, frames, out, ppq, dc_scale, sharp, dering,
                       strong, pli: int):
    """Deblock, then dering where asked, F' frames of one plane: srcs a
    list of F' [h, w] uint8 source planes (row-strided views, such as
    padded planes' images, are taken as they are; kept alive by the
    caller until the launches have run), frames their F' distinct indices
    into out [F, h, w] uint8 (rows contiguous, not overlapping a source)
    and ppq [F, 2, nv, nh] uint8 (each frame's DC qi and qi per block,
    0..63; on the card an index outside traps), dering and strong F'
    bools, dc_scale and sharp [64] int32, all on one device. Writes frame
    k's result into out[frames[k]] and returns out; other frames of out
    are left as they are. On the card: one deblock launch over all F'
    frames and one dering launch where any derings, per MAX_FRAMES frames.
    Equals postproc.postprocess_plane frame by frame, which is the CPU
    path."""
    if not isinstance(out, torch.Tensor) or out.dim() != 3:
        raise ValueError("out: expected an [F, h, w] tensor")
    dev = out.device
    F, h, w = out.shape
    nv, nh = _geometry(h, w, "out")
    if out.dtype != torch.uint8:
        raise TypeError(f"out: expected torch.uint8, got {out.dtype}")
    if out.stride(2) != 1 or out.stride(1) < w \
            or out.stride(0) < h * out.stride(1):
        raise ValueError("out: rows must be contiguous, frames apart")
    _check(ppq, "ppq", torch.uint8, (F, 2, nv, nh), dev)
    _tables(dc_scale, sharp, dev)
    n = len(srcs)
    if n < 1 or not (len(frames) == len(dering) == len(strong) == n):
        raise ValueError(f"{n} sources, {len(frames)} frame indices, "
                         f"{len(dering)} dering and {len(strong)} strong "
                         f"flags: expected one of each per frame, at least "
                         f"one frame")
    for k, src in enumerate(srcs):
        _plane(src, f"srcs[{k}]", (h, w), dev)
    for f in frames:
        if not isinstance(f, (int, np.integer)) or isinstance(f, bool) \
                or not 0 <= f < F:
            raise ValueError(f"frame index {f!r}: expected an int in "
                             f"0..{F - 1}")
    if len(set(int(f) for f in frames)) != n:
        raise ValueError(f"frame indices {list(frames)} repeat")
    flags = [int(_flag(d, "dering")) | int(_flag(s, "strong")) << 1
             for d, s in zip(dering, strong)]
    if pli not in (0, 1, 2):
        raise ValueError(f"pli {pli!r}: expected 0, 1 or 2")
    if dev.type == "cpu":
        for src, f, fl in zip(srcs, frames, flags):
            out[f] = postproc.postprocess_plane(
                src, ppq[f, 0], ppq[f, 1], dc_scale, sharp, bool(fl & 1),
                bool(fl & 2), pli)
        return out
    _cuda(dev)
    _launch(postprocess_frames, list(srcs), [int(f) for f in frames], flags,
            out, ppq.data_ptr(), 2 * nv * nh, ppq.data_ptr() + nv * nh,
            2 * nv * nh, dc_scale, sharp, pli)
    return out


def postprocess_plane(src, dc_qis, qi, dc_scale, sharp, dering: bool,
                      strong: bool, pli: int, out=None):
    """Deblock, then dering where asked, one plane: src [h, w] uint8 (h, w
    multiples of 8, w <= 16384; a row-strided view, such as a padded
    plane's image, is taken as it is), dc_qis and qi [nv, nh] uint8 (qi
    0..63; on the card an index outside traps), dc_scale and sharp [64]
    int32, all on one device. Writes the result into out ([h, w] uint8,
    rows contiguous, not overlapping src) when given, else a new tensor,
    and returns it. The frame-axis kernels over one frame (two launches
    with dering, one without). Equals postproc.postprocess_plane, which
    is the CPU path."""
    if not isinstance(src, torch.Tensor) or src.dim() != 2:
        raise ValueError("src: expected an [h, w] tensor")
    dev = src.device
    h, w = src.shape
    nv, nh = _geometry(h, w, "src")
    _plane(src, "src", (h, w), dev)
    _check(dc_qis, "dc_qis", torch.uint8, (nv, nh), dev)
    _check(qi, "qi", torch.uint8, (nv, nh), dev)
    _tables(dc_scale, sharp, dev)
    if out is not None:
        _plane(out, "out", (h, w), dev)
    if dev.type == "cpu":
        res = postproc.postprocess_plane(src, dc_qis, qi, dc_scale, sharp,
                                         dering, strong, pli)
        if out is None:
            return res
        out.copy_(res)
        return out
    _cuda(dev)
    if out is None:
        out = torch.empty((h, w), dtype=torch.uint8, device=dev)
    flags = int(bool(dering)) | int(bool(strong)) << 1
    _launch(postprocess_plane, [src], [0], [flags], out.unsqueeze(0),
            dc_qis.data_ptr(), 0, qi.data_ptr(), 0, dc_scale, sharp,
            int(pli))
    return out


# Kernel launches made through each wrapper on the card: one for the
# deblock and, where a frame derings, one for the dering, per call (per
# MAX_FRAMES frames of postprocess_frames); CPU calls do not count.
postprocess_plane.launches = 0
postprocess_frames.launches = 0
