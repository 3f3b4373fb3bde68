"""Plain Theora decoder: the benchmark's reference for what the port's
encoders write and what its decoder returns.

Python and NumPy only, rewritten after the pattern of the JAX package's
host decoder (its pure-Python tier: theora_tpu/decode/decoder.py,
tokens.py, dcpred.py, ops/idct_np.py, ops/loopfilter_vec.py), with the
header parsers, geometry and tables of the frozen copies beside it. It
imports nothing of the port. Streams are 4:2:0 (every configuration of
the benchmark). Frames come out as the port's decoders return them:
display-orientation [y, u, v] planes of frame size.

Besides the frames, each packet yields a verdict on its syntax: a packet
whose reads run past its end, or whose token data ends more than a byte
before its end, is counted bad (`bad_packets`); an encoder pads only the
last byte.

`control` selects a lower-precision decode for the benchmark's controls:
"float_idct" replaces the spec's integer iDCT by a float one rounded once;
"coef_lsb" drops the lowest bit of every quantized coefficient, as if it
had been coded at half the precision its quantizer states.
"""
from __future__ import annotations

import numpy as np

from .constants import (
    C1S7, C2S6, C3S5, C4S4, C5S3, C6S2, C7S1,
    DCT_TOKEN_EXTRA_BITS, FRAME_FOR_MODE, FRAME_GOLD, FRAME_NONE, FRAME_PREV,
    FRAME_SELF, HUFF_LIST_MAX, MODE_ALPHABETS, MODE_GOLDEN_MV, MODE_INTER_MV,
    MODE_INTER_MV_FOUR, MODE_INTER_MV_LAST, MODE_INTER_MV_LAST2,
    MODE_INTER_NOMV, MODE_INTRA, MVMAP, MVMAP2, ZIGZAG_TO_NAT,
)
from .geometry import get_geometry
from .headers import parse_info_header, parse_setup_header
from .quant import dequant_tables_init

EOB_FINISH = 1 << 60
_LUT_BITS = 11
_MB_MAP_420 = (0, 1, 2, 3, 4, 8)  # mb_maps flat indices of 4:2:0


class BadPacket(ValueError):
    """A packet the reference cannot decode."""


# ---------------------------------------------------------------------------
# Bits

class Bits:
    """MSB-first reads over one packet through a table of 32-bit windows,
    one per bit position (reads past the end give zero bits)."""

    def __init__(self, data: bytes):
        self.nbits = 8 * len(data)
        buf = np.frombuffer(bytes(data) + bytes(16), np.uint8).astype(
            np.uint64)
        pos = np.arange(self.nbits + 64)
        b = pos >> 3
        w40 = ((buf[b] << 32) | (buf[b + 1] << 24) | (buf[b + 2] << 16)
               | (buf[b + 3] << 8) | buf[b + 4])
        self.win = (((w40 << (pos & 7).astype(np.uint64)) >> 8)
                    & 0xFFFFFFFF).tolist()
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.win[self.pos] >> (32 - n)
        self.pos += n
        return v

    def read1(self) -> int:
        v = self.win[self.pos] >> 31
        self.pos += 1
        return v

    def check(self) -> None:
        """Raise BadPacket once a read has gone past the packet's end."""
        if self.pos > self.nbits:
            raise BadPacket("read past the end of the packet")


class Book:
    """A prefix code as a lookup table on the next _LUT_BITS bits, with a
    search for the longer codes."""

    def __init__(self, codes):
        self.lut = [-1] * (1 << _LUT_BITS)
        self.long = {}
        for tok, pat, n in codes:
            if n <= _LUT_BITS:
                lo = pat << (_LUT_BITS - n)
                for i in range(lo, lo + (1 << (_LUT_BITS - n))):
                    self.lut[i] = tok << 6 | n
            else:
                self.long[(n, pat)] = tok
        self.long_lens = sorted({n for n, _ in self.long})

    def decode(self, bits: Bits) -> int:
        w = bits.win[bits.pos]
        e = self.lut[w >> (32 - _LUT_BITS)]
        if e >= 0:
            bits.pos += e & 63
            return e >> 6
        for n in self.long_lens:
            tok = self.long.get((n, w >> (32 - n)))
            if tok is not None:
                bits.pos += n
                return tok
        raise BadPacket("no Huffman code matches")


def _book(entries):
    return Book([(tok, int(code, 2), len(code)) for tok, code in entries])


# Run-length codes of the coded flags and block qis (decode.c:299-357).
_SB_RUN = _book([(0, "0"), (1, "10"), (2, "110"), (3, "1110"),
                 (4, "11110"), (5, "111110"), (6, "111111")])
_SB_RUN_PARAMS = ((1, 0), (2, 1), (4, 1), (6, 2), (10, 3), (18, 4), (34, 12))
_BLOCK_RUN = _book([(0, "0"), (1, "10"), (2, "110"), (3, "1110"),
                    (4, "11110"), (5, "11111")])
_BLOCK_RUN_PARAMS = ((1, 1), (3, 1), (5, 1), (7, 2), (11, 2), (15, 4))
# Mode codes (decode.c:684-739).
_MODE_VLC = _book([(i, "1" * i + "0") for i in range(7)] + [(7, "1111111")])
_MODE_CLC = _book([(i, format(i, "03b")) for i in range(8)])


def _mv_vlc():
    """MV component VLC (decode.c:743-773) over value + 32."""
    e = [(32, "000"), (33, "001"), (31, "010"), (34, "0110"), (30, "0111"),
         (35, "1000"), (29, "1001")]
    for i, mag in enumerate(range(4, 8)):
        p = format(20 + i, "05b")
        e += [(32 + mag, p + "0"), (32 - mag, p + "1")]
    for i, base in enumerate(range(8, 16, 2)):
        p = format(24 + i, "05b")
        e += [(32 + base, p + "00"), (32 - base, p + "01"),
              (33 + base, p + "10"), (31 - base, p + "11")]
    for i, base in enumerate(range(16, 32, 4)):
        p = format(28 + i, "05b")
        for j in range(4):
            e += [(32 + base + j, p + format(2 * j, "03b")),
                  (32 - base - j, p + format(2 * j + 1, "03b"))]
    return e


_MV_VLC = _book(_mv_vlc())
_MV_CLC = _book([(32 + v, format(2 * v, "06b")) for v in range(32)]
                + [(32 - v, format(2 * v + 1, "06b")) for v in range(32)])


def _sb_run(bits):
    base, n = _SB_RUN_PARAMS[_SB_RUN.decode(bits)]
    return base + bits.read(n)


def _block_run(bits):
    base, n = _BLOCK_RUN_PARAMS[_BLOCK_RUN.decode(bits)]
    return base + bits.read(n)


def _expand(token: int, eb: int):
    """(eob run, zero run, coefficient) of a DCT token and its extra bits
    (the spec's token table, decode.c:985-1100)."""
    if token < 3:
        return token + 1, 0, 0
    if token < 6:
        return (4, 8, 16)[token - 3] + eb, 0, 0
    if token == 6:
        return (eb if eb else EOB_FINISH), 0, 0
    if token < 9:
        return 0, eb, 0
    if token < 13:
        return 0, 0, (1, -1, 2, -2)[token - 9]
    if token < 17:
        mag = token - 10
        return 0, 0, -mag if eb else mag
    if token < 23:
        n, base = ((1, 7), (2, 9), (3, 13), (4, 21), (5, 37), (9, 69))[
            token - 17]
        mag = base + (eb & ((1 << n) - 1))
        return 0, 0, -mag if eb >> n else mag
    if token < 28:
        return 0, token - 22, -1 if eb else 1
    if token == 28:
        return 0, 6 + (eb & 3), -1 if eb >> 2 else 1
    if token == 29:
        return 0, 10 + (eb & 7), -1 if eb >> 3 else 1
    if token == 30:
        mag = 2 + (eb & 1)
        return 0, 1, -mag if eb >> 1 else mag
    mag = 2 + ((eb >> 1) & 1)
    return 0, 2 + (eb & 1), -mag if eb >> 2 else mag


_NEB = [int(n) for n in DCT_TOKEN_EXTRA_BITS]
_EXPAND = [[_expand(t, eb) for eb in range(1 << _NEB[t])] for t in range(32)]


# ---------------------------------------------------------------------------
# Integer iDCT (idct.c:30-330) and its float control

def _i16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _idct8(x):
    """1-D 8-point iDCT over the last axis, int64 in and out."""
    t0 = C4S4 * _i16(x[..., 0] + x[..., 4]) >> 16
    t1 = C4S4 * _i16(x[..., 0] - x[..., 4]) >> 16
    t2 = (C6S2 * x[..., 2] >> 16) - (C2S6 * x[..., 6] >> 16)
    t3 = (C2S6 * x[..., 2] >> 16) + (C6S2 * x[..., 6] >> 16)
    t4 = (C7S1 * x[..., 1] >> 16) - (C1S7 * x[..., 7] >> 16)
    t5 = (C3S5 * x[..., 5] >> 16) - (C5S3 * x[..., 3] >> 16)
    t6 = (C5S3 * x[..., 5] >> 16) + (C3S5 * x[..., 3] >> 16)
    t7 = (C1S7 * x[..., 1] >> 16) + (C7S1 * x[..., 7] >> 16)
    t4, t5 = t4 + t5, C4S4 * _i16(t4 - t5) >> 16
    t7, t6 = t7 + t6, C4S4 * _i16(t7 - t6) >> 16
    t0, t3 = t0 + t3, t0 - t3
    t1, t2 = t1 + t2, t1 - t2
    t6, t5 = t6 + t5, t6 - t5
    return _i16(np.stack([t0 + t7, t1 + t6, t2 + t5, t3 + t4, t3 - t4,
                          t2 - t5, t1 - t6, t0 - t7], axis=-1))


def idct8x8(coeffs: np.ndarray) -> np.ndarray:
    """[N, 8, 8] natural-order dequantized coefficients -> residuals."""
    w = np.swapaxes(_idct8(coeffs.astype(np.int64)), -1, -2)
    return _i16(np.swapaxes(_idct8(w), -1, -2) + 8 >> 4)


_K = np.arange(8)
_BASIS = (np.where(_K == 0, np.sqrt(0.125), 0.5)[None, :]
          * np.cos((2 * _K[:, None] + 1) * _K[None, :] * np.pi / 16))


def idct8x8_float(coeffs: np.ndarray) -> np.ndarray:
    """The same transform in float, rounded once: the control's."""
    x = coeffs.astype(np.float64) / 4.0
    return np.rint(_BASIS @ x @ _BASIS.T).astype(np.int64)


# ---------------------------------------------------------------------------
# Loop filter in the spec's edge order, one fragment row at a time
# (state.c:1002-1105; the row decomposition of the JAX package's
# ops/loopfilter_vec.py)

def bounding_values(flimit: int) -> np.ndarray:
    bv = np.zeros(256, dtype=np.int64)
    for i in range(flimit):
        if 127 - i - flimit >= 0:
            bv[127 - i - flimit] = i - flimit
        bv[127 - i] = -i
        bv[127 + i] = i
        if 127 + i + flimit < 256:
            bv[127 + i + flimit] = flimit - i
    return bv


def _filt(p0, p1, p2, p3, bv):
    f = (p0.astype(np.int64) - p3.astype(np.int64)
         + 3 * (p2.astype(np.int64) - p1.astype(np.int64)))
    return bv[((f + 4) >> 3) + 127]


def _clamp(x):
    return np.clip(x, 0, 255)


def _lookup(width, keys):
    t = np.full(width, -1, dtype=np.int64)
    t[keys] = np.arange(len(keys))
    return t


def loop_filter_plane(plane: np.ndarray, coded: np.ndarray,
                      bv: np.ndarray) -> None:
    """Filter one padded plane in place. Per coded fragment in raster
    order the spec filters its left edge, its top edge, its right edge if
    the right neighbour is uncoded and its bottom edge if the one below
    is; later filters read what earlier ones wrote. Within a fragment row
    the order only couples pixel rows y0 and y0 + 7, whose chains are
    resolved from the row's snapshot and both firing orders."""
    nv, nh = coded.shape
    hpad = (plane.shape[1] - nh * 8) // 2
    vpad = (plane.shape[0] - nv * 8) // 2
    width = plane.shape[1]
    ecols = hpad + 8 * np.arange(nh)
    for r in range(nv):
        y0 = vpad + 8 * r
        row = coded[r]
        hfire = np.zeros(nh, bool)
        hfire[1:] = row[1:] | row[:-1]
        left_fired = np.zeros(nh, bool)
        left_fired[1:] = row[1:]
        top = row.copy() if r > 0 else np.zeros(nh, bool)
        bottom = row & ~coded[r + 1] if r + 1 < nv else np.zeros(nh, bool)
        if not (hfire.any() or top.any() or bottom.any()):
            continue
        s0, s1 = plane[y0].copy(), plane[y0 + 1].copy()
        s6, s7 = plane[y0 + 6].copy(), plane[y0 + 7].copy()
        hc = np.nonzero(hfire)[0]
        tc = np.nonzero(top)[0]
        bc = np.nonzero(bottom)[0]
        hx = ecols[hc]
        # Vertical edges, pixel rows y0+1 .. y0+6: no same-row coupling.
        if len(hc):
            rows = plane[y0 + 1:y0 + 7]
            rsp = _filt(rows[:, hx - 2], rows[:, hx - 1], rows[:, hx],
                        rows[:, hx + 1], bv)
            rows[:, hx - 1] = _clamp(rows[:, hx - 1] + rsp)
            rows[:, hx] = _clamp(rows[:, hx] - rsp)
        # Row y0: top edges' outputs at columns 8c+6, 8c+7 feed the next
        # vertical edge; they read snapshot values only.
        top_o = {}
        for off in (6, 7):
            if len(tc):
                x = ecols[tc] + off
                rsp = _filt(plane[y0 - 2, x], plane[y0 - 1, x], s0[x],
                            s1[x], bv)
                top_o[off] = (x, _clamp(s0[x].astype(np.int64) - rsp))
        h0 = None
        if len(hc):
            in_m2 = s0[hx - 2].astype(np.int64)
            in_m1 = s0[hx - 1].astype(np.int64)
            prev_top = np.zeros(nh, bool)
            prev_top[1:] = top[:-1]
            m = prev_top[hc]
            if m.any():
                in_m2[m] = top_o[6][1][_lookup(width, top_o[6][0])[hx[m] - 2]]
                in_m1[m] = top_o[7][1][_lookup(width, top_o[7][0])[hx[m] - 1]]
            rsp = _filt(in_m2, in_m1, s0[hx], s0[hx + 1], bv)
            h0 = (_clamp(in_m1 + rsp), _clamp(s0[hx].astype(np.int64) - rsp))
        if len(tc):
            x0 = ecols[tc]
            cols = x0[:, None] + np.arange(8)[None, :]
            r_m2 = plane[y0 - 2][cols].astype(np.int64)
            r_m1 = plane[y0 - 1][cols].astype(np.int64)
            r_0 = s0[cols].astype(np.int64)
            r_1 = s1[cols].astype(np.int64)
            if h0 is not None:
                hi = _lookup(width, hx)[x0]
                hm = hi >= 0
                r_0[hm, 0] = h0[1][hi[hm]]
            r_1[:, 0] = plane[y0 + 1, x0]
            rsp = _filt(r_m2, r_m1, r_0, r_1, bv)
            plane[y0 - 1][cols] = _clamp(r_m1 + rsp)
            plane[y0][cols] = _clamp(r_0 - rsp)
        if h0 is not None:
            plane[y0, hx - 1] = h0[0]
            keep = ~top[hc]
            plane[y0, hx[keep]] = h0[1][keep]
        # Row y0+7: a vertical edge fires before or after the bottom edge
        # to its left, as the fragment to its right is coded or not.
        h7s = None
        if len(hc):
            rsp = _filt(s7[hx - 2], s7[hx - 1], s7[hx], s7[hx + 1], bv)
            h7s = (_clamp(s7[hx - 1].astype(np.int64) + rsp),
                   _clamp(s7[hx].astype(np.int64) - rsp))
        bo6 = bo7 = None
        if len(bc):
            x = ecols[bc] + 6
            rsp = _filt(s6[x], s7[x], plane[y0 + 8, x], plane[y0 + 9, x], bv)
            bo6 = (x, _clamp(s7[x].astype(np.int64) + rsp))
            x7 = ecols[bc] + 7
            nxt = np.zeros(len(bc), bool)
            inr = bc + 1 < nh
            nxt[inr] = row[np.minimum(bc + 1, nh - 1)][inr]
            in6 = np.where(~nxt, plane[y0 + 6, x7], s6[x7]).astype(np.int64)
            in7 = s7[x7].astype(np.int64)
            if h7s is not None:
                hi = _lookup(width, hx)[np.minimum(x7 + 1, width - 1)]
                hm = (hi >= 0) & ~nxt
                in7[hm] = h7s[0][hi[hm]]
            rsp = _filt(in6, in7, plane[y0 + 8, x7], plane[y0 + 9, x7], bv)
            bo7 = (x7, _clamp(in7 + rsp))
        h7 = None
        if len(hc):
            in_m2 = s7[hx - 2].astype(np.int64)
            in_m1 = s7[hx - 1].astype(np.int64)
            prev_bot = np.zeros(nh, bool)
            prev_bot[1:] = bottom[:-1]
            m = prev_bot[hc] & left_fired[hc]
            if m.any():
                in_m2[m] = bo6[1][_lookup(width, bo6[0])[hx[m] - 2]]
                in_m1[m] = bo7[1][_lookup(width, bo7[0])[hx[m] - 1]]
            rsp = _filt(in_m2, in_m1, s7[hx], s7[hx + 1], bv)
            lf = left_fired[hc]
            h7 = (np.where(lf, _clamp(in_m1 + rsp), h7s[0]),
                  np.where(lf, _clamp(s7[hx].astype(np.int64) - rsp), h7s[1]))
        if len(bc):
            x0 = ecols[bc]
            cols = x0[:, None] + np.arange(8)[None, :]
            r_6 = s6[cols].astype(np.int64)
            r_7 = s7[cols].astype(np.int64)
            r_8 = plane[y0 + 8][cols].astype(np.int64)
            r_9 = plane[y0 + 9][cols].astype(np.int64)
            r_6[:, 0] = plane[y0 + 6, x0]
            if h7 is not None:
                hi = _lookup(width, hx)[x0]
                hm = hi >= 0
                r_7[hm, 0] = h7[1][hi[hm]]
            nxt = np.zeros(len(bc), bool)
            inr = bc + 1 < nh
            nxt[inr] = row[np.minimum(bc + 1, nh - 1)][inr]
            r_6[:, 7] = np.where(~nxt, plane[y0 + 6, x0 + 7], s6[x0 + 7])
            if h7 is not None:
                hi = _lookup(width, hx)[np.minimum(x0 + 8, width - 1)]
                hm = (hi >= 0) & ~nxt
                r_7[hm, 7] = h7[0][hi[hm]]
            rsp = _filt(r_6, r_7, r_8, r_9, bv)
            plane[y0 + 7][cols] = _clamp(r_7 + rsp)
            plane[y0 + 8][cols] = _clamp(r_8 - rsp)
        if h7 is not None:
            lf = left_fired[hc]
            prev_bot = np.zeros(nh, bool)
            prev_bot[1:] = bottom[:-1]
            keep = ~(prev_bot[hc] & ~lf)
            plane[y0 + 7, hx[keep] - 1] = h7[0][keep]
            keep = ~bottom[hc]
            plane[y0 + 7, hx[keep]] = h7[1][keep]


# ---------------------------------------------------------------------------
# DC prediction (decode.c:1392-1500)

def _cdiv(a: int, b: int) -> int:
    q = abs(a) // b
    return -q if a < 0 else q


def dc_unpredict(coded, refi, dc, pred_last) -> None:
    """Undo DC prediction over one plane in place; coded, refi and dc are
    row lists of Python values."""
    nv, nh = len(coded), len(coded[0])
    for fy in range(nv):
        crow, rrow, drow = coded[fy], refi[fy], dc[fy]
        if fy == 0:
            for fx in range(nh):
                if crow[fx]:
                    r = rrow[fx]
                    v = _i16(drow[fx] + pred_last[r])
                    drow[fx] = v
                    pred_last[r] = v
            continue
        cup, rup, dup = coded[fy - 1], refi[fy - 1], dc[fy - 1]
        l_ref = ul_ref = -1
        u_ref = rup[0] if cup[0] else -1
        for fx in range(nh):
            ur_ref = rup[fx + 1] if fx + 1 < nh and cup[fx + 1] else -1
            if crow[fx]:
                r = rrow[fx]
                case = ((l_ref == r) | (ul_ref == r) << 1 | (u_ref == r) << 2
                        | (ur_ref == r) << 3)
                if case == 1 or case == 3:
                    pred = drow[fx - 1]
                elif case == 2:
                    pred = dup[fx - 1]
                elif case == 4 or case == 6 or case == 12:
                    pred = dup[fx]
                elif case == 5:
                    pred = _cdiv(drow[fx - 1] + dup[fx], 2)
                elif case == 8:
                    pred = dup[fx + 1]
                elif case == 9 or case == 11 or case == 13:
                    pred = _cdiv(75 * drow[fx - 1] + 53 * dup[fx + 1], 128)
                elif case == 10:
                    pred = _cdiv(dup[fx - 1] + dup[fx + 1], 2)
                elif case == 14:
                    pred = _cdiv(3 * (dup[fx - 1] + dup[fx + 1])
                                 + 10 * dup[fx], 16)
                elif case == 7 or case == 15:
                    p0, p1, p2 = drow[fx - 1], dup[fx - 1], dup[fx]
                    pred = _cdiv(29 * (p0 + p2) - 26 * p1, 32)
                    if abs(pred - p2) > 128:
                        pred = p2
                    elif abs(pred - p0) > 128:
                        pred = p0
                    elif abs(pred - p1) > 128:
                        pred = p1
                else:
                    pred = pred_last[r]
                v = _i16(drow[fx] + pred)
                drow[fx] = v
                pred_last[r] = v
                l_ref = r
            else:
                l_ref = -1
            ul_ref, u_ref = u_ref, ur_ref


# ---------------------------------------------------------------------------

class RefDecoder:
    """Decode a Theora stream from its three header packets on."""

    def __init__(self, headers: list[bytes], control: str | None = None):
        if control not in (None, "float_idct", "coef_lsb"):
            raise ValueError(f"unknown control {control!r}")
        self.control = control
        self.info = info = parse_info_header(headers[0])
        setup = parse_setup_header(headers[2])
        if int(info.pixel_fmt) != 0:
            raise ValueError("the reference decodes 4:2:0 streams only")
        self.g = g = get_geometry(info.frame_width, info.frame_height, 0)
        self.dequant = dequant_tables_init(setup.qinfo).astype(np.int64)
        self.flimits = setup.qinfo["loop_filter_limits"]
        self.books = [Book(cb.codes) for cb in setup.codebooks]
        self.frag_pli = np.repeat(np.arange(3),
                                  [g.planes[pli].nfrags for pli in range(3)])
        self.pad = [g.plane_padding(pli) for pli in range(3)]
        self.shape = [g.plane_shape(pli) for pli in range(3)]
        self.gold = self.prev = None
        self.bad_packets = 0
        pli_sel = [g.scan_pli == pli for pli in range(3)]
        self.scan_by_plane = [g.scan_fragis[s] for s in pli_sel]

    # -- side information -------------------------------------------------
    def _coded_flags(self, bits):
        g = self.g
        nsbs = g.nsbs
        partial = [0] * nsbs
        full = [0] * nsbs
        flag = bits.read1()
        npartial = sbi = 0
        while sbi < nsbs:
            run = _sb_run(bits)
            full_run = run >= 4129
            n = min(run, nsbs - sbi)
            partial[sbi:sbi + n] = [flag] * n
            npartial += flag * n
            sbi += n
            flag = bits.read1() if full_run and sbi < nsbs else 1 - flag
        if npartial < nsbs:
            sbi = 0
            while partial[sbi]:
                sbi += 1
            flag = bits.read1()
            while sbi < nsbs:
                run = _sb_run(bits)
                full_run = run >= 4129
                while sbi < nsbs:
                    if partial[sbi]:
                        sbi += 1
                        continue
                    if run <= 0:
                        break
                    full[sbi] = flag
                    sbi += 1
                    run -= 1
                flag = bits.read1() if full_run and sbi < nsbs else 1 - flag
        flag = 1 - bits.read1() if npartial else 0
        coded = np.zeros(g.nfrags, bool)
        run = 0
        cflags = []
        for sbi in g.scan_sbi.tolist():
            if full[sbi]:
                cflags.append(True)
            elif not partial[sbi]:
                cflags.append(False)
            else:
                if run <= 0:
                    run = _block_run(bits)
                    flag = 1 - flag
                run -= 1
                cflags.append(bool(flag))
        cflags = np.array(cflags, bool)
        coded[g.scan_fragis] = cflags
        luma = g.scan_sbi < g.planes[0].nsbs
        mb_coded = np.zeros(g.nmbs, bool)
        sel = cflags & luma
        mb_coded[(g.scan_sbi[sel] << 2) | g.scan_quadi[sel]] = True
        return coded, mb_coded

    def _modes(self, bits, mb_coded):
        scheme = bits.read(3)
        if scheme == 0:
            alphabet = [0] * 8
            for mi in range(8):
                alphabet[bits.read(3)] = int(MODE_ALPHABETS[6][mi])
        else:
            alphabet = [int(m) for m in MODE_ALPHABETS[scheme - 1]]
        book = _MODE_CLC if scheme == 7 else _MODE_VLC
        g = self.g
        modes = [-1] * g.nmbs
        valid = g.mb_valid
        for mbi in np.nonzero(valid & mb_coded)[0].tolist():
            modes[mbi] = alphabet[book.decode(bits)]
        for mbi in np.nonzero(valid & ~mb_coded)[0].tolist():
            modes[mbi] = MODE_INTER_NOMV
        return modes

    def _mvs(self, bits, modes, coded, refi, mode_of, mv):
        g = self.g
        book = _MV_CLC if bits.read1() else _MV_VLC
        maps = g.mb_maps

        def read_mv():
            dx = book.decode(bits) - 32
            return dx, book.decode(bits) - 32

        last = prior = (0, 0)
        for mbi, mode in enumerate(modes):
            if mode < 0:
                continue
            if mode == MODE_INTER_MV_FOUR:
                lb = [(0, 0)] * 4
                prior = last
                for bi in range(4):
                    f = maps[mbi, 0, bi]
                    if f >= 0 and coded[f]:
                        last = lb[bi] = read_mv()
                        refi[f], mode_of[f], mv[f] = FRAME_PREV, mode, lb[bi]
                sx = sum(v[0] for v in lb)
                sy = sum(v[1] for v in lb)
                cmv = ((sx + (sx < 0 and -1) + 2) >> 2,
                       (sy + (sy < 0 and -1) + 2) >> 2)
                for mapi in _MB_MAP_420[4:]:
                    f = maps[mbi, mapi >> 2, mapi & 3]
                    if f >= 0 and coded[f]:
                        refi[f], mode_of[f], mv[f] = FRAME_PREV, mode, cmv
                continue
            if mode == MODE_INTER_MV:
                prior = last
                last = mbmv = read_mv()
            elif mode == MODE_INTER_MV_LAST:
                mbmv = last
            elif mode == MODE_INTER_MV_LAST2:
                mbmv = prior
                prior, last = last, mbmv
            elif mode == MODE_GOLDEN_MV:
                mbmv = read_mv()
            else:
                mbmv = (0, 0)
            r = int(FRAME_FOR_MODE[mode])
            for mapi in _MB_MAP_420:
                f = maps[mbi, mapi >> 2, mapi & 3]
                if f >= 0 and coded[f]:
                    refi[f], mode_of[f], mv[f] = r, mode, mbmv

    def _block_qis(self, bits, order, nqis):
        n = len(order)
        qii = [0] * n
        if n == 0 or nqis == 1:
            return qii
        flag = bits.read1()
        nqi1 = i = 0
        while i < n:
            run = _sb_run(bits)
            full_run = run >= 4129
            k = min(run, n - i)
            qii[i:i + k] = [flag] * k
            nqi1 += flag * k
            i += k
            flag = bits.read1() if full_run and i < n else 1 - flag
        if nqis == 3 and nqi1 > 0:
            i = 0
            while qii[i] == 0:
                i += 1
            flag = bits.read1()
            while i < n:
                run = _sb_run(bits)
                full_run = run >= 4129
                while i < n:
                    if qii[i] == 0:
                        i += 1
                        continue
                    if run <= 0:
                        break
                    qii[i] += flag
                    i += 1
                    run -= 1
                flag = bits.read1() if full_run and i < n else 1 - flag
        return qii

    # -- tokens (decode.c:1164-1201, 1531-1586) ----------------------------
    def _tokens(self, bits, ncoded):
        """Token streams per plane and zig-zag index, each a list of
        (eob run, zero run, coefficient), and the EOB run that each stream
        starts with."""
        books = self.books
        streams = [[[] for _ in range(64)] for _ in range(3)]
        eob_start = [[0] * 64 for _ in range(3)]
        left = [[ncoded[pli]] * 64 for pli in range(3)]
        win = bits.win
        eobs = 0
        hidx = [bits.read(4), bits.read(4)]
        for pli in range(3):
            book = books[hidx[(pli + 1) >> 1]]
            runs = [0] * 64
            eob_start[pli][0] = eobs
            n = ncoded[pli]
            k = min(eobs, n)
            eob_count = k
            eobs -= k
            out = streams[pli][0]
            while k < n:
                tok = book.decode(bits)
                neb = _NEB[tok]
                eb = 0
                if neb:
                    eb = win[bits.pos] >> (32 - neb)
                    bits.pos += neb
                ex = _EXPAND[tok][eb]
                out.append(ex)
                if ex[0]:
                    take = min(ex[0], n - k)
                    eob_count += take
                    eobs = ex[0] - take
                    k += take
                else:
                    runs[ex[1]] += 1
                    k += 1
            runs[63] += eob_count
            self._consume(left[pli], runs, 0)
        hidx = [bits.read(4), bits.read(4)]
        zzi = 1
        for hgi in range(1, 5):
            hidx = [hidx[0] + 16, hidx[1] + 16]
            while zzi < HUFF_LIST_MAX[hgi]:
                for pli in range(3):
                    book = books[hidx[(pli + 1) >> 1]]
                    eob_start[pli][zzi] = min(eobs, EOB_FINISH)
                    runs = [0] * 64
                    eob_count = 0
                    ntl = left[pli][zzi]
                    ntoks = 0
                    out = streams[pli][zzi]
                    while ntoks + eobs < ntl:
                        ntoks += eobs
                        eob_count += eobs
                        tok = book.decode(bits)
                        neb = _NEB[tok]
                        eb = 0
                        if neb:
                            eb = win[bits.pos] >> (32 - neb)
                            bits.pos += neb
                        ex = _EXPAND[tok][eb]
                        out.append(ex)
                        eobs = ex[0]
                        if eobs == 0:
                            runs[ex[1]] += 1
                            ntoks += 1
                    eob_count += ntl - ntoks
                    eobs -= ntl - ntoks
                    runs[63] += eob_count
                    self._consume(left[pli], runs, zzi)
                zzi += 1
        return streams, eob_start

    @staticmethod
    def _consume(left, runs, zzi):
        """Tokens at zig-zag index zzi that end a block's run at index j
        leave one fewer block for every index from zzi to zzi + j: take
        the suffix sums of the run counts off the later streams."""
        acc = 0
        suffix = [0] * 64
        for j in range(63, -1, -1):
            acc += runs[j]
            suffix[j] = acc
        for j in range(64 - zzi):
            left[zzi + j] -= suffix[j]

    @staticmethod
    def _replay(streams, eob_start, n, row0, rows, cols, vals, last):
        """Coefficients of a plane's n coded blocks from its streams."""
        ti = [0] * 64
        eob = list(eob_start)
        for b in range(row0, row0 + n):
            zzi = 0
            lz = 0
            while zzi < 64:
                lz = zzi
                if eob[zzi]:
                    eob[zzi] -= 1
                    break
                e, run, c = streams[zzi][ti[zzi]]
                ti[zzi] += 1
                eob[zzi] = e
                zzi += run
                if zzi < 64 and not e:
                    rows.append(b)
                    cols.append(zzi)
                    vals.append(c)
                if not e:
                    zzi += 1
            last[b] = lz

    # -- frames -------------------------------------------------------------
    def _new_planes(self, fill=None):
        out = []
        for pli in range(3):
            (vp, hp), (h, w) = self.pad[pli], self.shape[pli]
            p = np.zeros((h + 2 * vp, w + 2 * hp), np.uint8)
            if fill is not None:
                p.fill(fill)
            out.append(p)
        return out

    def _borders(self, planes):
        for pli, p in enumerate(planes):
            (vp, hp), (h, w) = self.pad[pli], self.shape[pli]
            p[vp:vp + h, :hp] = p[vp:vp + h, hp:hp + 1]
            p[vp:vp + h, hp + w:] = p[vp:vp + h, hp + w - 1:hp + w]
            p[:vp] = p[vp:vp + 1]
            p[vp + h:] = p[vp + h - 1:vp + h]

    def frame(self) -> list[np.ndarray]:
        """The last decoded frame, display orientation, frame size."""
        out = []
        for pli, p in enumerate(self.prev):
            (vp, hp), (h, w) = self.pad[pli], self.shape[pli]
            out.append(p[vp:vp + h, hp:hp + w][::-1].copy())
        return out

    def decode(self, packet: bytes) -> list[np.ndarray]:
        """Decode one data packet; returns its frame. A packet the
        reference rejects raises BadPacket and is counted bad."""
        try:
            return self._decode(packet)
        except (BadPacket, IndexError) as e:
            self.bad_packets += 1
            raise BadPacket(str(e)) from e

    def _decode(self, packet: bytes) -> list[np.ndarray]:
        g = self.g
        if len(packet) == 0:
            if self.prev is None:
                raise BadPacket("a stream may not start with a dup")
            return self.frame()
        bits = Bits(packet)
        if bits.read1() != 0:
            raise BadPacket("not a data packet")
        intra = bits.read1() == 0
        qis = [bits.read(6)]
        if bits.read1():
            qis.append(bits.read(6))
            if bits.read1():
                qis.append(bits.read(6))
        nfrags = g.nfrags
        refi = np.full(nfrags, FRAME_NONE, np.int64)
        mode_of = np.zeros(nfrags, np.int64)
        mv = np.zeros((nfrags, 2), np.int64)
        if intra:
            if bits.read(3) != 0:
                raise BadPacket("reserved bits set in a keyframe")
            coded = np.ones(nfrags, bool)
            refi[:] = FRAME_SELF
            mode_of[:] = MODE_INTRA
        else:
            if self.prev is None:
                self.gold = self.prev = self._new_planes(0x80)
            coded, mb_coded = self._coded_flags(bits)
            modes = self._modes(bits, mb_coded)
            refi_l, mode_l, mv_l = refi.tolist(), mode_of.tolist(), \
                [(0, 0)] * nfrags
            self._mvs(bits, modes, coded.tolist(), refi_l, mode_l, mv_l)
            refi = np.array(refi_l, np.int64)
            mode_of = np.array(mode_l, np.int64)
            mv = np.array(mv_l, np.int64).reshape(nfrags, 2)
            orphan = coded & (refi == FRAME_NONE)
            refi[orphan] = FRAME_PREV
            mode_of[orphan] = MODE_INTER_NOMV
        per_plane = [f[coded[f]] for f in self.scan_by_plane]
        order = np.concatenate(per_plane)
        ncoded = [len(f) for f in per_plane]
        qii = np.array(self._block_qis(bits, order, len(qis)), np.int64)
        streams, eob_start = self._tokens(bits, ncoded)
        bits.check()
        if bits.nbits - bits.pos >= 8:
            raise BadPacket(f"{(bits.nbits - bits.pos) // 8} bytes after "
                            f"the last token")
        total = len(order)
        rows, cols, vals = [], [], []
        last = [0] * total
        row0 = 0
        for pli in range(3):
            self._replay(streams[pli], eob_start[pli], ncoded[pli], row0,
                         rows, cols, vals, last)
            row0 += ncoded[pli]
        qz = np.zeros((total, 64), np.int64)
        qz[rows, cols] = vals
        last = np.array(last, np.int64)
        if self.control == "coef_lsb":
            qz = np.sign(qz) * (np.abs(qz) & ~1)
        # DC prediction over each plane in raster order.
        dc_full = np.zeros(nfrags, np.int64)
        dc_full[order] = qz[:, 0]
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            shape = (pl.nvfrags, pl.nhfrags)
            dc_rows = dc_full[sl].reshape(shape).tolist()
            dc_unpredict(coded[sl].reshape(shape).tolist(),
                         refi[sl].reshape(shape).tolist(), dc_rows,
                         [0, 0, 0])
            dc_full[sl] = np.array(dc_rows, np.int64).reshape(-1)
        # Dequantization (DC at qii 0) and the iDCT.
        inter = (mode_of[order] != MODE_INTRA).astype(np.int64)
        fpli = self.frag_pli[order]
        qi_of = np.array(qis, np.int64)[qii]
        deq_rows = self.dequant[qi_of, fpli, inter]
        dcq = self.dequant[qis[0], fpli, inter, 0]
        dcs = dc_full[order]
        residual = np.empty((total, 8, 8), np.int64)
        dc_only = last < 2
        if dc_only.any():
            fill = _i16(dcs[dc_only] * dcq[dc_only] + 15 >> 5)
            residual[dc_only] = fill[:, None, None]
        full = ~dc_only
        if full.any():
            deq = qz[full] * deq_rows[full]
            deq[:, 0] = dcs[full] * dcq[full]
            deq = _i16(deq)
            nat = np.zeros_like(deq)
            nat[:, ZIGZAG_TO_NAT[:64]] = deq
            tf = idct8x8_float if self.control == "float_idct" else idct8x8
            residual[full] = tf(nat.reshape(-1, 8, 8))
        cur = self._new_planes()
        refs = {FRAME_PREV: self.prev, FRAME_GOLD: self.gold}
        for pli in range(3):
            self._recon_plane(pli, cur[pli], refs, order, fpli, residual,
                              refi, mv, coded)
        flimit = int(self.flimits[qis[0]])
        if flimit:
            bv = bounding_values(flimit)
            for pli in range(3):
                pl = g.planes[pli]
                sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                loop_filter_plane(cur[pli],
                                  coded[sl].reshape(pl.nvfrags, pl.nhfrags),
                                  bv)
        self._borders(cur)
        self.prev = cur
        if intra:
            self.gold = cur
        return self.frame()

    def _recon_plane(self, pli, dst, refs, order, fpli, residual, refi, mv,
                     coded):
        g = self.g
        vp, hp = self.pad[pli]
        sel = np.nonzero(fpli == pli)[0]
        fr = order[sel]
        res = residual[sel]
        fy = g.frag_y[fr].astype(np.int64) * 8 + vp
        fx = g.frag_x[fr].astype(np.int64) * 8 + hp
        ar = np.arange(8)
        r = refi[fr]
        out = np.empty((len(fr), 8, 8), np.int64)
        m = r == FRAME_SELF
        out[m] = res[m] + 128
        q = 1 if pli else 0
        for rf in (FRAME_PREV, FRAME_GOLD):
            m = r == rf
            if not m.any():
                continue
            src = refs[rf][pli]
            dx, dy = mv[fr[m], 0], mv[fr[m], 1]
            mx, mx2 = MVMAP[q][dx + 31], MVMAP2[q][dx + 31]
            my, my2 = MVMAP[q][dy + 31], MVMAP2[q][dy + 31]
            y1 = fy[m] + my
            x1 = fx[m] + mx
            blk = src[y1[:, None, None] + ar[None, :, None],
                      x1[:, None, None] + ar[None, None, :]].astype(np.int64)
            two = (mx2 != 0) | (my2 != 0)
            if two.any():
                blk2 = src[(y1 + my2)[:, None, None] + ar[None, :, None],
                           (x1 + mx2)[:, None, None] + ar[None, None, :]]
                blk = np.where(two[:, None, None],
                               (blk + blk2.astype(np.int64)) >> 1, blk)
            out[m] = res[m] + blk
        np.clip(out, 0, 255, out=out)
        dst[fy[:, None, None] + ar[None, :, None],
            fx[:, None, None] + ar[None, None, :]] = out.astype(np.uint8)
        # Uncoded fragments copy the previous frame (decode.c:1598-1606).
        pl = g.planes[pli]
        cm = coded[pl.froffset:pl.froffset + pl.nfrags].reshape(
            pl.nvfrags, pl.nhfrags)
        if not cm.all():
            ys, xs = np.nonzero(~cm)
            ay = (vp + ys * 8)[:, None, None] + ar[None, :, None]
            ax = (hp + xs * 8)[:, None, None] + ar[None, None, :]
            dst[ay, ax] = refs[FRAME_PREV][pli][ay, ax]
