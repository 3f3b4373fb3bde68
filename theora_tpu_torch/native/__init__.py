"""Decode-only native (C++) host tier, loaded with ctypes.

Copy of the decode side of theora_tpu/native/__init__.py: the Huffman
context and `NativeEntropy.decode_frame_tokens`, `dc_predict_native`,
and the argument types of the frame side-info parser. The library is
built with g++ from entropy.cpp at first use into ``native/build/``. A
failed build raises: the port has no pure-Python entropy tier.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "entropy.cpp")
_SO = os.path.join(_DIR, "build", "libtheora_decode.so")

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
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
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
    """The loaded native decode library, building it if needed."""
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
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
    ]
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


def dc_predict_native(coded, refi, dc, pred_last) -> None:
    """Undo DC prediction over one plane, in place on the int32 array dc
    [nv, nh]. pred_last: length-3 list, updated in place."""
    if dc.dtype != np.int32 or not dc.flags["C_CONTIGUOUS"]:
        raise ValueError("dc must be a C-contiguous int32 array")
    lib = get_lib()
    nv, nh = coded.shape
    coded8 = np.ascontiguousarray(coded, dtype=np.uint8)
    refi32 = np.ascontiguousarray(refi, dtype=np.int32)
    pl = np.asarray(pred_last, dtype=np.int32)
    lib.th_dc_predict_plane(
        nv, nh, coded8.ctypes.data, refi32.ctypes.data, dc.ctypes.data,
        pl.ctypes.data,
    )
    pred_last[:] = pl.tolist()
