"""Native (C++) host tier, loaded with ctypes.

Copy of the parts of theora_tpu/native/__init__.py the port uses. Decode:
the Huffman context and `NativeEntropy.decode_frame_tokens`,
`dc_predict_native` and the argument types of the frame side-info
parser. Encode: `NativeTokenPacker.pack_frame`, `dc_residuals_native`,
`coded_flags_pack_native`, `mb_modes_pack_native` and
`mode_decide_native`; the host encoder's keyframe path:
`fdct_quantize_rd_native`, `trellis_plan_blocks_native` and
`NativeTokenPacker.pack_frame_trellis_perm`; its inter path:
`motion_estimate_native`, `me_block_refine_native`,
`mode_decide_fill_native`, `sad_batch_native`, `enc_residuals_native` and
`ssd8_plane_native`. The library is built with g++ from entropy.cpp at
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
        _P,    # frag_bits out (null: not counted)
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
    lib.th_fdct_quantize_rd.restype = None
    lib.th_fdct_quantize_rd.argtypes = [
        _I64, _P, _P, ctypes.c_double, ctypes.c_int, _P, _P, _P, _P,
    ]
    lib.th_trellis_plan_blocks.restype = None
    lib.th_trellis_plan_blocks.argtypes = [_I64] + [_P] * 5 + [_I64] + [
        _P] * 4
    lib.th_trellis_plan_blocks_lam.restype = None
    lib.th_trellis_plan_blocks_lam.argtypes = [_I64] + [_P] * 10
    lib.th_encode_frame_trellis_perm.restype = _I64
    lib.th_encode_frame_trellis_perm.argtypes = [_P] * 12 + [_I64, _P, _I64,
                                                             _P]
    # The inter path (theora_tpu/native/__init__.py:434-452, 534-577,
    # 665-719, 858-882).
    me = [_P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P, _P, _I64]
    for name, extra in (("th_me_fullpel", [_P, _P, ctypes.c_int]),
                        ("th_me_propagate", [_P, _P, ctypes.c_int,
                                             ctypes.c_int]),
                        ("th_me_halfpel", [ctypes.c_int, _P, _P]),
                        ("th_me_refine", [ctypes.c_int, _P, _P,
                                          ctypes.c_int, ctypes.c_int])):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = me + extra
    lib.th_mode_decide_fill.restype = None
    lib.th_mode_decide_fill.argtypes = (
        [_P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _I64] + [_P] * 11
        + [ctypes.c_int, ctypes.c_double, ctypes.c_double] + [_P] * 5)
    lib.th_sad_batch.restype = None
    lib.th_sad_batch.argtypes = [_P, ctypes.c_int, _P, ctypes.c_int, _I64,
                                 _P, _P, _P, _P, ctypes.c_int, _P]
    lib.th_enc_residuals.restype = None
    lib.th_enc_residuals.argtypes = (
        [_P, ctypes.c_int, _P, _P, ctypes.c_int, _I64] + [_P] * 8
        + [ctypes.c_int, ctypes.c_int, _P])
    lib.th_ssd8_plane.restype = None
    lib.th_ssd8_plane.argtypes = [_P, _P, _I64, _I64, _I64, _P]
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

    def decode_frame_tokens(self, packet: bytes, bit_offset: int, ncoded,
                            want_bits: bool = False):
        """Returns (qcoeffs [total,64] int16 zig-zag, last_zzi [total],
        dc [total] pre-prediction, end_bitpos), in coded order; with
        want_bits also frag_bits [total] int32, the bits of the tokens
        each fragment's coefficients took (the telemetry's bits
        overlay)."""
        total = int(sum(ncoded))
        nc = np.asarray(ncoded, dtype=np.int64)
        qcoeffs = np.zeros((max(total, 1), 64), dtype=np.int16)
        last_zzi = np.zeros(max(total, 1), dtype=np.int32)
        dc = np.zeros(max(total, 1), dtype=np.int32)
        fbits = np.zeros(max(total, 1), dtype=np.int32) if want_bits else None
        buf = np.frombuffer(packet, dtype=np.uint8)
        end = self._lib.th_decode_frame_tokens(
            self._ctx, buf.ctypes.data, len(packet), bit_offset,
            nc.ctypes.data, qcoeffs.ctypes.data, last_zzi.ctypes.data,
            dc.ctypes.data, fbits.ctypes.data if want_bits else None,
        )
        if end < 0:
            raise ValueError("native token decode failed")
        out = (qcoeffs[:total], last_zzi[:total], dc[:total], int(end))
        return out + (fbits[:total],) if want_bits else out


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

    def pack_frame_trellis_perm(self, paths3, perm3, dc3, prefix: bytes,
                                prefix_bits: int):
        """Replay the trellis plans and pack the residual section:
        per plane, the [n, 66, 4] int16 plans in quantize (raster) order,
        the scan -> raster permutation and the scan-order DC residuals.
        Returns (the whole packet, the chosen Huffman indices [dc_y, dc_c,
        ac_y, ac_c])."""
        paths = [np.ascontiguousarray(p, dtype=np.int16) for p in paths3]
        perms = [np.ascontiguousarray(p, dtype=np.int32) for p in perm3]
        dcs = [np.ascontiguousarray(d, dtype=np.int32) for d in dc3]
        nc = np.asarray([len(p) for p in perms], dtype=np.int64)
        cap = 64 + prefix_bits // 8 + max(int(nc.sum()) * 80, 512)
        out = np.zeros(cap, dtype=np.uint8)
        pre = (np.frombuffer(prefix, dtype=np.uint8) if prefix
               else np.zeros(1, np.uint8))
        chosen = np.zeros(4, dtype=np.int32)
        # Empty planes still need valid pointers.
        zp = np.zeros((1, 66, 4), np.int16)
        zi = np.zeros(1, np.int32)
        n = self._lib.th_encode_frame_trellis_perm(
            *[(p if len(p) else zp).ctypes.data for p in paths],
            *[(p if len(p) else zi).ctypes.data for p in perms],
            *[(d if len(d) else zi).ctypes.data for d in dcs],
            nc.ctypes.data, self._codes.ctypes.data, pre.ctypes.data,
            prefix_bits, out.ctypes.data, cap, chosen.ctypes.data,
        )
        if n < 0:
            raise ValueError("native trellis pack failed")
        return out[:n].tobytes(), [int(x) for x in chosen]


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


def fdct_quantize_rd_native(res_blocks, dequant_zz, lam, rd=True,
                            want_dct=False):
    """fDCT + (R/D) quantization of [n, 8, 8] residual blocks with one
    [64] zig-zag dequant row. Returns (qz [n, 64] int16, err2 [n] int64,
    res2 [n] int64), and the zig-zag DCT [n, 64] int16 as a fourth array
    when want_dct (the trellis' input)."""
    lib = get_lib()
    n = len(res_blocks)
    res32 = np.ascontiguousarray(np.asarray(res_blocks).reshape(n, 64),
                                 dtype=np.int32)
    dq32 = np.ascontiguousarray(dequant_zz, dtype=np.int32)
    qz = np.empty((n, 64), dtype=np.int16)
    err2 = np.empty(n, dtype=np.int64)
    res2 = np.empty(n, dtype=np.int64)
    dct = np.empty((n, 64), dtype=np.int16) if want_dct else None
    lib.th_fdct_quantize_rd(
        n, res32.ctypes.data, dq32.ctypes.data, float(lam), int(rd),
        qz.ctypes.data, err2.ctypes.data, res2.ctypes.data,
        dct.ctypes.data if want_dct else None,
    )
    if want_dct:
        return qz, err2, res2, dct
    return qz, err2, res2


def trellis_plan_blocks_native(dct16, qdct, dq0, dq1, qti, lam, nbt):
    """Phase-1 trellis planning (th_trellis_plan_blocks).

    dct16 [n, 64] int16; qdct [n, 64] int16, C-contiguous, its AC values
    rewritten in place; dq0/dq1 [64] intra/inter dequant rows; qti [n]
    0/1; lam a number (truncated to an integer) or a float array of one
    lambda per block (rounded to nearest); nbt [5, 32] int64 bit costs.
    Returns (paths [n, 66, 4] int16, acbits [n] int64, err2 [n] int64).
    """
    lib = get_lib()
    if qdct.dtype != np.int16 or not qdct.flags.c_contiguous:
        raise ValueError("qdct must be a C-contiguous int16 array")
    n = len(qdct)
    dct_c = np.ascontiguousarray(dct16, dtype=np.int16)
    dq0_c = np.ascontiguousarray(dq0, dtype=np.int32)
    dq1_c = np.ascontiguousarray(dq1, dtype=np.int32)
    qti_c = np.ascontiguousarray(qti, dtype=np.int32)
    nbt_c = np.ascontiguousarray(nbt, dtype=np.int64)
    paths = np.empty((n, 66, 4), dtype=np.int16)
    acbits = np.empty(n, dtype=np.int64)
    err2 = np.empty(n, dtype=np.int64)
    args = (dct_c.ctypes.data, qdct.ctypes.data, dq0_c.ctypes.data,
            dq1_c.ctypes.data, qti_c.ctypes.data)
    outs = (nbt_c.ctypes.data, acbits.ctypes.data, err2.ctypes.data,
            paths.ctypes.data)
    if isinstance(lam, np.ndarray):
        lam_c = np.ascontiguousarray(np.rint(lam).astype(np.int64))
        if len(lam_c) != n:
            raise ValueError("one lambda per block expected")
        lib.th_trellis_plan_blocks_lam(n, *args, lam_c.ctypes.data, *outs)
    else:
        lib.th_trellis_plan_blocks(n, *args, int(lam), *outs)
    return paths, acbits, err2


# ----------------------------------------------------------------------
# The host encoder's inter path.


def _me_args(cur, ref_padded, by, bx):
    """The leading arguments of the ME calls and the arrays they point
    into (kept alive by the caller)."""
    cur = np.ascontiguousarray(cur)
    ref = np.ascontiguousarray(ref_padded)
    h, w = cur.shape
    by32 = np.ascontiguousarray(by, dtype=np.int32)
    bx32 = np.ascontiguousarray(bx, dtype=np.int32)
    keep = (cur, ref, by32, bx32)
    return keep, (cur.ctypes.data, w, h, ref.ctypes.data,
                  (ref.shape[0] - h) // 2, by32.ctypes.data,
                  bx32.ctypes.data, len(by32))


def motion_estimate_native(cur, ref_padded, mb_y, mb_x, max_mv=15, iters=2):
    """Luma ME of 16x16 macroblocks: pyramid full-pel search, candidate
    propagation, half-pel refinement. cur [H, W] uint8, ref_padded the
    reference edge-padded by the same amount on every side, mb_y/mb_x the
    blocks' pixel coordinates. Returns (mvs [n, 2] half-pel (dx, dy),
    sads [n] int64)."""
    lib = get_lib()
    keep, args = _me_args(cur, ref_padded, mb_y, mb_x)
    n = len(keep[2])
    mvs = np.zeros((n, 2), dtype=np.int32)
    sads = np.zeros(n, dtype=np.int64)
    lib.th_me_fullpel(*args, mvs.ctypes.data, sads.ctypes.data, max_mv)
    lib.th_me_propagate(*args, mvs.ctypes.data, sads.ctypes.data, max_mv,
                        iters)
    lib.th_me_halfpel(*args, 16, mvs.ctypes.data, sads.ctypes.data)
    return mvs, sads


def me_block_refine_native(cur, ref_padded, by, bx, seed_mvs, bs=8):
    """Per-block +-1 full-pel refinement from the seed (the macroblock's
    full-pel vector), then half-pel, for the 4MV mode. Returns (mvs [n, 2]
    half-pel, sads [n] int64)."""
    lib = get_lib()
    keep, args = _me_args(cur, ref_padded, by, bx)
    n = len(keep[2])
    mvs = np.ascontiguousarray(seed_mvs, dtype=np.int32).copy()
    sads = np.zeros(n, dtype=np.int64)
    lib.th_me_refine(*args, bs, mvs.ctypes.data, sads.ctypes.data, 15, 1)
    lib.th_me_halfpel(*args, bs, mvs.ctypes.data, sads.ctypes.data)
    return mvs, sads


def mode_decide_fill_native(cur, ref_padded, mb_list, mb_fy, mb_fx,
                            sad_nomv, sad_gold, sad_intra, sad_mv, sad_4mv,
                            mvs, bmvs, mb_maps, pixel_fmt, mv_bits_sad,
                            nfrags, bias_scale=1.0):
    """The host encoder's sequential mode decision over its SADs, with the
    per-fragment fill (chroma vectors by pixel_fmt). Returns (mb_modes
    [n], mb_mvs [n, 2], refi [nfrags], mode [nfrags], mv [nfrags, 2]),
    int32; unfilled fragments keep refi 3 (FRAME_NONE)."""
    lib = get_lib()
    cur = np.ascontiguousarray(cur)
    ref = np.ascontiguousarray(ref_padded)
    h, w = cur.shape
    n = len(mb_list)

    def a(x, dt):
        return np.ascontiguousarray(x, dtype=dt)

    mb_modes = np.zeros(n, dtype=np.int32)
    mb_mvs = np.zeros((n, 2), dtype=np.int32)
    refi = np.full(nfrags, 3, dtype=np.int32)
    fmode = np.zeros(nfrags, dtype=np.int32)
    fmv = np.zeros((nfrags, 2), dtype=np.int32)
    arrs = [
        a(mb_list, np.int32), a(mb_fy, np.int32), a(mb_fx, np.int32),
        a(sad_nomv, np.int64), a(sad_gold, np.int64),
        a(sad_intra, np.int64), a(sad_mv, np.int64), a(sad_4mv, np.int64),
        a(mvs, np.int32), a(bmvs, np.int32),
        a(mb_maps.reshape(-1), np.int32),
    ]
    lib.th_mode_decide_fill(
        cur.ctypes.data, w, h, ref.ctypes.data, (ref.shape[0] - h) // 2, n,
        *[x.ctypes.data for x in arrs],
        int(pixel_fmt), float(mv_bits_sad), float(bias_scale),
        mb_modes.ctypes.data, mb_mvs.ctypes.data, refi.ctypes.data,
        fmode.ctypes.data, fmv.ctypes.data,
    )
    return mb_modes, mb_mvs, refi, fmode, fmv


def sad_batch_native(cur, ref_padded, fy, fx, mvx, mvy, bs=16):
    """Half-pel SADs of bs x bs blocks at pixel coordinates (fy, fx)
    against the padded reference at half-pel vectors (mvx, mvy). Returns
    [n] int64."""
    lib = get_lib()
    cur = np.ascontiguousarray(cur)
    ref = np.ascontiguousarray(ref_padded)
    w = cur.shape[1]
    arrs = [np.ascontiguousarray(x, dtype=np.int32)
            for x in (fy, fx, mvx, mvy)]
    out = np.empty(len(arrs[0]), dtype=np.int64)
    lib.th_sad_batch(cur.ctypes.data, w, ref.ctypes.data,
                     (ref.shape[1] - w) // 2, len(out),
                     *[x.ctypes.data for x in arrs], int(bs),
                     out.ctypes.data)
    return out


def enc_residuals_native(cur, prev_padded, gold_padded, fy, fx, refsel,
                         o1y, o1x, o2y, o2x, use2, vpad, hpad):
    """cur minus each block's prediction: 128 (refsel 0), or the MC read
    from the padded previous (1) or golden (2) reconstruction at offsets
    o1, averaged with o2 where use2. Returns [n, 8, 8] int32."""
    lib = get_lib()
    cur = np.ascontiguousarray(cur)
    prev = np.ascontiguousarray(prev_padded)
    gold = np.ascontiguousarray(gold_padded)
    ints = [np.ascontiguousarray(x, dtype=np.int32)
            for x in (fy, fx, refsel, o1y, o1x, o2y, o2x)]
    u8 = np.ascontiguousarray(use2, dtype=np.uint8)
    out = np.empty((len(ints[0]), 8, 8), dtype=np.int32)
    lib.th_enc_residuals(
        cur.ctypes.data, cur.shape[1], prev.ctypes.data, gold.ctypes.data,
        prev.shape[1], len(out), *[x.ctypes.data for x in ints],
        u8.ctypes.data, int(vpad), int(hpad), out.ctypes.data,
    )
    return out


def ssd8_plane_native(cur, prev_padded, vpad, hpad):
    """Per-8x8-block SSD, times 16, of cur [h, w] uint8 (h, w multiples
    of 8) against the padded reconstruction prev_padded [h + 2 vpad,
    w + 2 hpad]: the early skip's uncoded cost. Returns [h/8 * w/8]
    int64 in raster order."""
    lib = get_lib()
    cur = np.ascontiguousarray(cur, dtype=np.uint8)
    h, w = cur.shape
    prev = np.ascontiguousarray(prev_padded, dtype=np.uint8)
    out = np.empty((h // 8) * (w // 8), np.int64)
    lib.th_ssd8_plane(cur.ctypes.data,
                      prev.ctypes.data + vpad * prev.shape[1] + hpad,
                      h, w, prev.shape[1], out.ctypes.data)
    return out
