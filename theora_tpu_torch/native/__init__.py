"""Native (C++) host tier, loaded with ctypes.

Copy of the parts of theora_tpu/native/__init__.py the port uses. Decode:
the Huffman context and `NativeEntropy.decode_frame_tokens`,
`dc_predict_native` and the argument types of the frame side-info
parser. Encode: `NativeTokenPacker.pack_frame`, `dc_residuals_native`,
`coded_flags_pack_native`, `mb_modes_pack_native` and
`mode_decide_native`. The library is built with g++ from entropy.cpp at
first use into ``native/build/``, with the JAX package's flags (the mode
decision's double-precision costs then compile to the same instructions).
A failed build or a missing symbol raises: the port has no pure-Python
host tier.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "entropy.cpp")
_SO = os.path.join(_DIR, "build", "libtheora_host.so")
_FLAGS = ["-O3", "-march=native", "-fno-math-errno"]

_lib = None

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


def build() -> str:
    """Compile entropy.cpp when the library is missing or older than its
    source; returns the library path. Concurrent builders each write a
    private file and rename it into place."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *_FLAGS, "-std=c++17", "-shared", "-fPIC", _SRC, "-o",
             tmp],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed:\n{proc.stderr}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _SO


def get_lib():
    """The loaded native library, building it if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.th_entropy_create.restype = _P
    lib.th_entropy_create.argtypes = [_P, _P]
    lib.th_entropy_destroy.restype = None
    lib.th_entropy_destroy.argtypes = [_P]
    lib.th_decode_frame_tokens.restype = _I64
    lib.th_decode_frame_tokens.argtypes = [
        _P,    # ctx
        _P,    # packet
        _I64,  # packet_len
        _I64,  # bit_offset
        _P,    # ncoded[3]
        _P,    # qcoeffs out
        _P,    # last_zzi out
        _P,    # dc out
    ]
    lib.th_dc_predict_plane.restype = None
    lib.th_dc_predict_plane.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P,
    ]
    lib.th_encode_frame_tokens.restype = _I64
    lib.th_encode_frame_tokens.argtypes = [_P, _P, _P, _P, _I64, _P, _I64]
    lib.th_coded_flags_pack.restype = _I64
    lib.th_coded_flags_pack.argtypes = [_P, _P, _P, _I64, _I64, _P, _I64, _P]
    lib.th_mb_modes_pack.restype = _I64
    lib.th_mb_modes_pack.argtypes = [_P, _I64, _P, _P, _I64]
    lib.th_mode_decide.restype = None
    lib.th_mode_decide.argtypes = (
        [_I64] + [_P] * 16 + [_I64] * 3
        + [ctypes.c_double, ctypes.c_double, _I32] + [_P] * 3
    )
    lib.th_parse_frame_sideinfo.restype = _I64
    lib.th_parse_frame_sideinfo.argtypes = [
        _P, _I64, _I64, _I32, _I32, _I32, _P, _P, _P, _I64, _I32, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _P,
    ]
    _lib = lib
    return _lib


class NativeEntropy:
    """ctypes wrapper around the C++ residual-token decoder."""

    def __init__(self, codebooks):
        """codebooks: the 80 Codebook objects of the setup header."""
        self._lib = get_lib()
        codes = np.zeros((80, 32, 3), dtype=np.int32)
        ncodes = np.zeros(80, dtype=np.int32)
        for b, book in enumerate(codebooks):
            for i, (t, p, n) in enumerate(book.codes):
                codes[b, i] = (t, p, n)
            ncodes[b] = len(book.codes)
        self._ctx = self._lib.th_entropy_create(
            codes.ctypes.data, ncodes.ctypes.data
        )

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.th_entropy_destroy(self._ctx)
            self._ctx = None

    def decode_frame_tokens(self, packet: bytes, bit_offset: int, ncoded):
        """Returns (qcoeffs [total,64] int16 zig-zag, last_zzi [total],
        dc [total] pre-prediction, end_bitpos), in coded order."""
        total = int(sum(ncoded))
        nc = np.asarray(ncoded, dtype=np.int64)
        qcoeffs = np.zeros((max(total, 1), 64), dtype=np.int16)
        last_zzi = np.zeros(max(total, 1), dtype=np.int32)
        dc = np.zeros(max(total, 1), dtype=np.int32)
        buf = np.frombuffer(packet, dtype=np.uint8)
        end = self._lib.th_decode_frame_tokens(
            self._ctx, buf.ctypes.data, len(packet), bit_offset,
            nc.ctypes.data, qcoeffs.ctypes.data, last_zzi.ctypes.data,
            dc.ctypes.data,
        )
        if end < 0:
            raise ValueError("native token decode failed")
        return qcoeffs[:total], last_zzi[:total], dc[:total], int(end)


def _dc_predict(mode, coded, refi, dc, out, pred_last) -> None:
    lib = get_lib()
    nv, nh = coded.shape
    coded8 = np.ascontiguousarray(coded, dtype=np.uint8)
    refi32 = np.ascontiguousarray(refi, dtype=np.int32)
    pl = np.asarray(pred_last, dtype=np.int32)
    lib.th_dc_predict_plane(
        mode, nv, nh, coded8.ctypes.data, refi32.ctypes.data, dc.ctypes.data,
        None if out is None else out.ctypes.data, pl.ctypes.data,
    )
    pred_last[:] = pl.tolist()


def dc_predict_native(coded, refi, dc, pred_last) -> None:
    """Undo DC prediction over one plane, in place on the int32 array dc
    [nv, nh]. pred_last: length-3 list, updated in place."""
    if dc.dtype != np.int32 or not dc.flags["C_CONTIGUOUS"]:
        raise ValueError("dc must be a C-contiguous int32 array")
    _dc_predict(0, coded, refi, dc, None, pred_last)


def dc_residuals_native(coded, refi, dc, pred_last) -> np.ndarray:
    """DC prediction residuals of one plane: [nv, nh] int32 dc - pred for
    the coded fragments (the encoder's side). pred_last: length-3 list,
    updated in place."""
    dc32 = np.ascontiguousarray(dc, dtype=np.int32)
    out = np.zeros(dc32.shape, dtype=np.int32)
    _dc_predict(1, coded, refi, dc32, out, pred_last)
    return out


class NativeTokenPacker:
    """Encode side: tokenize + residual section packing in C++."""

    def __init__(self, huff_codes):
        """huff_codes: [80][32] of (pattern, nbits)."""
        self._lib = get_lib()
        arr = np.zeros((80, 32, 2), dtype=np.int32)
        for b in range(80):
            for t in range(32):
                arr[b, t] = huff_codes[b][t]
        self._codes = np.ascontiguousarray(arr)

    def pack_frame(self, vecs: np.ndarray, ncoded, prefix: bytes,
                   prefix_bits: int) -> bytes:
        """vecs: [total, 64] zig-zag coefficients with the DC residual at
        0, in coded order, ncoded[3] per plane; prefix: the packet's
        packed header bits. Returns the whole packet."""
        vecs = np.ascontiguousarray(vecs, dtype=np.int16)
        nc = np.asarray(ncoded, dtype=np.int64)
        cap = 64 + prefix_bits // 8 + vecs.size * 4
        out = np.zeros(cap, dtype=np.uint8)
        pre = (np.frombuffer(prefix, dtype=np.uint8) if prefix
               else np.zeros(1, np.uint8))
        n = self._lib.th_encode_frame_tokens(
            vecs.ctypes.data, nc.ctypes.data, self._codes.ctypes.data,
            pre.ctypes.data, prefix_bits, out.ctypes.data, cap,
        )
        if n < 0:
            raise ValueError("native token pack failed")
        return out[:n].tobytes()


def coded_flags_pack_native(coded, scan_fragis, scan_sbi, nsbs):
    """Pack the coded-block-flags section. Returns (bit buffer bytes,
    nbits, sb_partial bool[nsbs])."""
    lib = get_lib()
    c8 = np.ascontiguousarray(coded, dtype=np.uint8)
    sf = np.ascontiguousarray(scan_fragis, dtype=np.int32)
    sb = np.ascontiguousarray(scan_sbi, dtype=np.int32)
    cap = 64 + len(sf) + nsbs
    out = np.zeros(cap, dtype=np.uint8)
    part = np.zeros(nsbs, dtype=np.uint8)
    bits = lib.th_coded_flags_pack(
        c8.ctypes.data, sf.ctypes.data, sb.ctypes.data, len(sf), int(nsbs),
        out.ctypes.data, cap, part.ctypes.data,
    )
    if bits < 0:
        raise ValueError("coded flags pack failed")
    return out.tobytes(), int(bits), part.astype(bool)


def mb_modes_pack_native(modes, alphabets):
    """Scheme selection + MB mode emission. Returns (bit buffer bytes,
    nbits)."""
    lib = get_lib()
    m32 = np.ascontiguousarray(modes, dtype=np.int32)
    al = np.ascontiguousarray(alphabets, dtype=np.int32)
    cap = 16 + len(m32) * 2
    out = np.zeros(cap, dtype=np.uint8)
    bits = lib.th_mb_modes_pack(m32.ctypes.data, len(m32), al.ctypes.data,
                                out.ctypes.data, cap)
    if bits < 0:
        raise ValueError("mb modes pack failed")
    return out.tobytes(), int(bits)


def mode_decide_native(mb_list, mb_row, mb_col, mb_all4, mb_birc,
                       mv, sad_mv, sad_nomv, sad_gold, sad_intra,
                       cands, cand_sads, gmv, sad_gmv, bmv, bsad,
                       nmbs, b, mvb, no_mc: bool = False):
    """Sequential LAST/LAST2-aware mode decision of one frame over the
    device-precomputed SADs (th_mode_decide; the walk in
    TpuGopEncoder._decide_frame). With no_mc (speed level 4) the MV and
    golden-MV vectors count as zero and 4MV is never considered. Returns
    (mb_modes [nmbs] int32, mb_mvs [nmbs, 2] int32, mb_bmvs [nmbs, 4, 2]
    int32)."""
    lib = get_lib()
    nv, nh = sad_mv.shape
    K = cands.shape[0]

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    mb_list = c32(mb_list)
    row, col = c32(mb_row), c32(mb_col)
    all4 = np.ascontiguousarray(mb_all4, dtype=np.uint8)
    birc = c32(mb_birc)
    ins = [c32(x) for x in (mv, sad_mv, sad_nomv, sad_gold, sad_intra,
                            cands, cand_sads, gmv, sad_gmv, bmv, bsad)]
    mb_modes = np.full(nmbs, -1, np.int32)
    mb_modes[mb_list] = 0
    mb_mvs = np.zeros((nmbs, 2), np.int32)
    mb_bmvs = np.zeros((nmbs, 4, 2), np.int32)
    lib.th_mode_decide(
        len(mb_list), mb_list.ctypes.data, row.ctypes.data, col.ctypes.data,
        all4.ctypes.data, birc.ctypes.data, *[x.ctypes.data for x in ins],
        nv, nh, K, float(b), float(mvb), int(bool(no_mc)),
        mb_modes.ctypes.data, mb_mvs.ctypes.data, mb_bmvs.ctypes.data,
    )
    return mb_modes, mb_mvs, mb_bmvs
