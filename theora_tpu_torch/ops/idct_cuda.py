"""Kernel K1: the hand-written CUDA dequant + iDCT (csrc/idct.cu).

Replaces the Pallas kernel theora_tpu/ops/pallas_kernels.py:idct8x8_soa
and the steps around it, through two entry points over one block core:
`dequantize_idct_frames`, the decode scan's dequant + iDCT, and
`idct_recon_choose`, the encode scan's step after the trellis (dequant +
iDCT of each of K qi rows, reconstruction, SSD and the qi chooser). The
library is compiled with nvcc for sm_90a (``-fmad=false``) at first use
into ``csrc/build/`` and bound with ctypes (plain C interface). Each
wrapper runs its plain PyTorch version (ops/transforms.py) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
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
# The chooser's float32 costs round once per operation, as on the CPU: no
# contraction of a*b + c into a fused multiply-add.
NVCC_FLAGS = ("-fmad=false",)
# The most qi rows one encode launch takes (a frame carries 1-3 qis).
MAX_ROWS = 3
# The most segments one encode-side launch takes (the mesh encoder's GOPs
# per dispatch, parallel/gop.py): the segment is the grid's y index.
MAX_SEGMENTS = 65535

_lib = None


def build() -> str:
    """Compile csrc/idct.cu when the library is missing or older than its
    source; returns the library path."""
    return nvcc_build(_SRC, _SO, NVCC_FLAGS)


def bind(lib, recon: bool = True):
    """Set the ctypes signatures of a K1 library's entry points (recon:
    also th_idct_recon_choose, which builds of the one-entry interface
    lack); returns lib."""
    lib.th_dequant_idct.restype = ctypes.c_int
    lib.th_dequant_idct.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int64, ctypes.c_void_p,
    ]
    if recon:
        lib.th_idct_recon_choose.restype = ctypes.c_int
        lib.th_idct_recon_choose.argtypes = [ctypes.c_void_p] * 14 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()))
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _aligned(t: torch.Tensor, name: str, nbytes: int) -> None:
    """The kernel loads t as vectors of nbytes."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: must be {nbytes}-byte aligned")


def segments(deq: torch.Tensor, nblocks: int, device):
    """The segments of an encode-side launch over nblocks blocks from its
    dequant rows: deq [K, 2, 64] is one segment, deq [G, K, 2, 64] G
    segments of nblocks / G blocks each (block b in segment b // n), each
    with its own K rows. Returns (deq as [G, K, 2, 64], G, K, n)."""
    if deq.dim() not in (3, 4):
        raise ValueError(f"deq: expected [K, 2, 64] or [G, K, 2, 64], got "
                         f"{tuple(deq.shape)}")
    deq4 = deq[None] if deq.dim() == 3 else deq
    g, k = deq4.shape[0], deq4.shape[1]
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"deq: expected K in 1..{MAX_ROWS} qi rows, got "
                         f"{tuple(deq.shape)}")
    if not 1 <= g <= MAX_SEGMENTS:
        raise ValueError(f"deq: expected G in 1..{MAX_SEGMENTS} segments, "
                         f"got {tuple(deq.shape)}")
    if nblocks % g:
        raise ValueError(f"{nblocks} blocks do not split into {g} segments")
    _check(deq4, "deq", torch.int16, (g, k, 2, 64), device)
    return deq4, g, k, nblocks // g


def dequantize_idct_frames(qz, dc, deq_tab, frame, qii, inter, dc_only):
    """Dequant + iDCT of [N] blocks of F frames of one plane.

    qz: [N, 64] int16 zig-zag (DC slot ignored), 16-byte aligned; dc: [N]
    int16 predicted DC; deq_tab: [F, 3, 2, 64] int16, 16-byte aligned;
    frame: [N] int32; qii, inter: [N] uint8; dc_only: [N] bool. Returns
    [N, 64] int16 residuals, raster order inside each block. Same contract
    as transforms.dequantize_idct_frames, which is the CPU path.
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
    _aligned(qz, "qz", 16)
    _aligned(deq_tab, "deq_tab", 16)
    if dev.type == "cpu":
        return transforms.dequantize_idct_frames(
            qz, dc, deq_tab, frame, qii, inter, dc_only
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = launch_dequant_idct(_load(), qz, dc, deq_tab, frame, qii, inter,
                              dc_only)
    dequantize_idct_frames.launches += 1
    return out


def launch_dequant_idct(lib, qz, dc, deq_tab, frame, qii, inter, dc_only):
    """th_dequant_idct of lib on checked CUDA arguments; returns the
    residuals. Counts nothing: the wrapper counts its launches."""
    n = qz.shape[0]
    out = torch.empty((n, 64), dtype=torch.int16, device=qz.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(qz.device).cuda_stream
    err = lib.th_dequant_idct(
        qz.data_ptr(), dc.data_ptr(), deq_tab.data_ptr(), frame.data_ptr(),
        qii.data_ptr(), inter.data_ptr(), dc_only.data_ptr(), out.data_ptr(),
        n, stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 dequant_idct launch failed: CUDA error {err}")
    return out


def idct_recon_choose(q16, dc_only, cnt, deq, inter, pred, cur, lam,
                      lam_sc=None):
    """The encode scan's step after the trellis for [N] blocks of one
    plane of one frame at K qi rows: each row's residual, reconstruction
    and SSD, and each block's row of least R/D cost.

    q16: [K, N, 64] int16 zig-zag values (the trellis' output, DC slot
    included), dc_only: [K, N] bool and cnt: [K, N] int32 nonzero counts,
    as kernel KT returns them; deq: [K, 2, 64] int16 zig-zag dequant rows
    (per qi row intra, inter), slot 0 of every row holding the base qi's
    DC factor, as encode/gop.py builds them; inter: [N] uint8; pred: [N,
    64] int32 prediction and cur: [N, 64] uint8 source, raster order inside
    each block; lam: float32 0-d tensor, the chooser's lambda; lam_sc: None
    or [N] float32 lambda scales. K in 1..3; q16, deq and pred 16-byte
    aligned, cur 8-byte aligned. With G segments (the mesh encoder's GOPs,
    `segments`): deq [G, K, 2, 64] and lam [G], block b taking segment b //
    (N / G)'s rows and lambda.

    Returns (recon [N, 64] uint8, ssd [N] int32, qii [N] uint8, q [N, 64]
    int16, cnt [N] int32) of each block's kept row (qii all 0 at K = 1).
    At K = 1, q and cnt are views of row 0 of q16 and cnt. Same contract
    as transforms.idct_recon_choose, which is the CPU path.
    """
    k, n = (q16.shape[0], q16.shape[1]) if q16.dim() == 3 else (0, 0)
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"q16: expected [K, N, 64] with K in 1..{MAX_ROWS},"
                         f" got {tuple(q16.shape)}")
    dev = q16.device
    _check(q16, "q16", torch.int16, (k, n, 64), dev)
    _check(dc_only, "dc_only", torch.bool, (k, n), dev)
    _check(cnt, "cnt", torch.int32, (k, n), dev)
    deq4, g, kd, _ = segments(deq, n, dev)
    if kd != k:
        raise ValueError(f"deq: {kd} qi rows for q16's {k}")
    _check(inter, "inter", torch.uint8, (n,), dev)
    _check(pred, "pred", torch.int32, (n, 64), dev)
    _check(cur, "cur", torch.uint8, (n, 64), dev)
    _check(lam, "lam", torch.float32, deq.shape[:-3], dev)
    if lam_sc is not None:
        _check(lam_sc, "lam_sc", torch.float32, (n,), dev)
    for t, name in ((q16, "q16"), (deq, "deq"), (pred, "pred")):
        _aligned(t, name, 16)
    _aligned(cur, "cur", 8)
    if dev.type == "cpu":
        return transforms.idct_recon_choose(q16, dc_only, cnt, deq, inter,
                                            pred, cur, lam, lam_sc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = launch_recon_choose(_load(), q16, dc_only, cnt, deq4, inter, pred,
                              cur, lam, lam_sc)
    idct_recon_choose.launches += 1
    return out


def launch_recon_choose(lib, q16, dc_only, cnt, deq, inter, pred, cur, lam,
                        lam_sc=None):
    """th_idct_recon_choose of lib on checked CUDA arguments (deq [G, K,
    2, 64], lam [G] or 0-d for G = 1); returns (recon, ssd, qii, q, cnt).
    Counts nothing: the wrapper counts its launches."""
    k, n = q16.shape[0], q16.shape[1]
    g = deq.shape[0] if deq.dim() == 4 else 1
    dev = q16.device
    recon = torch.empty((n, 64), dtype=torch.uint8, device=dev)
    ssd = torch.empty(n, dtype=torch.int32, device=dev)
    qii = torch.empty(n, dtype=torch.uint8, device=dev)
    if k == 1:
        q, cnt_sel = q16[0], cnt[0]
    else:
        q = torch.empty((n, 64), dtype=torch.int16, device=dev)
        cnt_sel = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return recon, ssd, qii, q, cnt_sel
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.th_idct_recon_choose(
        q16.data_ptr(), dc_only.data_ptr(), cnt.data_ptr(), deq.data_ptr(),
        inter.data_ptr(), pred.data_ptr(), cur.data_ptr(), lam.data_ptr(),
        None if lam_sc is None else lam_sc.data_ptr(), recon.data_ptr(),
        ssd.data_ptr(), qii.data_ptr(),
        None if k == 1 else q.data_ptr(),
        None if k == 1 else cnt_sel.data_ptr(), n // g, k, g, stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 idct_recon_choose launch failed: CUDA error "
                           f"{err}")
    return recon, ssd, qii, q, cnt_sel


# Kernel launches made through the wrappers (CPU calls do not count).
dequantize_idct_frames.launches = 0
idct_recon_choose.launches = 0
