"""Kernel KM: the hand-written CUDA ME plan (csrc/me.cu).

Replaces the encoder's ME plan, theora_tpu/ops/me_jax.py:_plan_impl
(:527), which XLA compiles on the TPU (no Pallas kernel): each
macroblock's coarse, full-pel and half-pel search against the previous
and the golden frame, the 4MV refine, the intra SAD, the 16 shared
candidate vectors of each frame and their SADs. Three launches per plan
call (search, candidates, candidate SADs) in place of the plain
version's thousands of PyTorch ops. Its bound is its instructions at
the int32 rate, byte SIMD counted four differences to one
(tools/bench_me.py:km_bound); one warp searches one macroblock against
one reference on packed bytes in shared memory and takes every minimum
over an integer key (see the source's note).

Its 11 outputs must equal the plain version's (ops/me.py:plan_with_gold)
bit for bit, tie order included. The library is compiled with nvcc for
sm_90a at first use into ``csrc/build/`` and bound with ctypes. The
wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import os

import torch

from theora_tpu_torch.ops import me
from theora_tpu_torch.ops.cuda_build import nvcc_build
from theora_tpu_torch.ops.idct_cuda import _check

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "me.cu")
_SO = os.path.join(_CSRC, "build", "libtheora_me.so")
# The candidate histogram's key count * 4096 + (4095 - bin) must fit int32.
MAX_MBS = 1 << 19
MAX_ROWS = 65535  # the search and candidate-SAD grids' second dimension

_lib = None


def build() -> str:
    """Compile csrc/me.cu when the library is missing or older than its
    source; returns the library path."""
    return nvcc_build(_SRC, _SO)


def bind(path: str):
    """The KM library at path (built from csrc/me.cu or an earlier
    version of it with the same C interface), its entries typed."""
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.th_me_search.restype = i32
    lib.th_me_search.argtypes = [ptr, ptr, i32, i32, i32] + [ptr] * 10
    lib.th_me_cands.restype = i32
    lib.th_me_cands.argtypes = [ptr, i32, i32, ptr, ptr]
    lib.th_me_cand_sads.restype = i32
    lib.th_me_cand_sads.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr]
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def outputs(B: int, nv: int, nh: int, dev) -> tuple:
    """Empty int32 tensors for the plan's 11 outputs, in me.plan's order."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    return (empty(B, nv, nh, 2), empty(B, nv, nh), empty(B, nv, nh),
            empty(B, nv, nh), empty(B, nv, nh), empty(B, me.N_CANDS, 2),
            empty(B, me.N_CANDS, nv, nh), empty(B, nv, nh, 2),
            empty(B, nv, nh), empty(B, 2 * nv, 2 * nh, 2), empty(B, nv, nh))


# The three launches of a plan call, in order.
STAGES = ("search", "candidates", "candidate SADs")


def launch(lib, stage: str, ys, gold_idx, out) -> int:
    """Launch one stage of the plan of ys [F, H, W], gold_idx [F-1] on the
    current stream into out (outputs()); returns the entry's CUDA error.
    The stages read what the earlier ones wrote."""
    (mv, sad_mv, sad_nomv, sad_gold, sad_intra, cands, cand_sads, gmv,
     sad_gmv, bmv, bsad4) = out
    F, H, W = ys.shape
    B = F - 1
    stream = torch.cuda.current_stream(ys.device).cuda_stream
    if stage == "search":
        return lib.th_me_search(
            ys.data_ptr(), gold_idx.data_ptr(), B, H, W, mv.data_ptr(),
            sad_mv.data_ptr(), sad_nomv.data_ptr(), gmv.data_ptr(),
            sad_gmv.data_ptr(), sad_gold.data_ptr(), sad_intra.data_ptr(),
            bmv.data_ptr(), bsad4.data_ptr(), stream)
    if stage == "candidates":
        return lib.th_me_cands(mv.data_ptr(), B, (H // 16) * (W // 16),
                               cands.data_ptr(), stream)
    if stage == "candidate SADs":
        return lib.th_me_cand_sads(ys.data_ptr(), cands.data_ptr(), B, H, W,
                                   cand_sads.data_ptr(), stream)
    raise ValueError(f"unknown KM stage {stage!r}")


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"KM {what} launch failed: CUDA error {err}")
    plan_with_gold.launches += 1


def plan_with_gold(ys, gold_idx):
    """The ME plan of a frame sequence: ys [F, H, W] uint8 luma (F >= 2, H
    and W multiples of 16), gold_idx [F-1] int64 giving, for each cur frame
    f+1, the index in ys of its golden reference, each in [0, F). The
    wrapper does not read the values (that would wait for the device): on
    the card an index outside traps the kernel and the next
    synchronisation raises, as PyTorch's own indexing does with a
    device-side assert. Row r searches ys[r + 1] against ys[r] and
    ys[gold_idx[r]]; rows whose cur frame is a keyframe are computed too.
    Returns me.plan's 11 int32 tensors (mv [B, nv, nh, 2], sad_mv,
    sad_nomv, sad_gold, sad_intra [B, nv, nh], cands [B, 16, 2], cand_sads
    [B, 16, nv, nh], gmv [B, nv, nh, 2], sad_gmv [B, nv, nh], bmv [B, 2nv,
    2nh, 2], bsad4 [B, nv, nh]), B = F - 1. Same contract as
    me.plan_with_gold, which is the CPU path."""
    if not isinstance(ys, torch.Tensor) or ys.dim() != 3:
        raise ValueError("ys: expected an [F, H, W] tensor")
    F, H, W = ys.shape
    if F < 2 or H < 16 or W < 16 or H % 16 or W % 16:
        raise ValueError(f"ys: expected F >= 2 frames of H x W multiples of "
                         f"16, got {tuple(ys.shape)}")
    B, nv, nh = F - 1, H // 16, W // 16
    n = nv * nh
    if n >= MAX_MBS or B > MAX_ROWS:
        raise ValueError(f"ys: {B} rows of {n} macroblocks exceed the "
                         f"kernel's {MAX_ROWS} rows of {MAX_MBS - 1}")
    dev = ys.device
    _check(ys, "ys", torch.uint8, (F, H, W), dev)
    _check(gold_idx, "gold_idx", torch.int64, (B,), dev)
    if dev.type == "cpu":
        return me.plan_with_gold(ys, gold_idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    out = outputs(B, nv, nh, dev)
    for stage in STAGES:
        _launched(launch(lib, stage, ys, gold_idx, out), stage)
    return out


# Kernel launches made through the wrapper, three per plan call on the card
# (CPU calls do not count).
plan_with_gold.launches = 0

