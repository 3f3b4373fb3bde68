# Frozen copy of theora_tpu_torch/constants.py at commit 6cd77e7, imports made relative;
# part of the benchmark's reference decoder, which imports nothing of the port.
"""Spec-defined constant tables of the decoder and the device encoder.

Copy of the parts of theora_tpu/constants.py the port uses. Values are
normative (Theora spec / VP3 bitstream); reference locations:
lib/internal.c:29-97, lib/dct.h:23-29, lib/state.h.
"""
from __future__ import annotations

import numpy as np

# Zig-zag index -> row-major coefficient index (internal.c:29-60).
ZIGZAG_TO_NAT = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int64,
)

# DCT constants: round(cos(n*pi/16) * 65536) (dct.h:23-29).
C1S7 = 64277
C2S6 = 60547
C3S5 = 54491
C4S4 = 46341
C5S3 = 36410
C6S2 = 25080
C7S1 = 12785

# Bitstream ordering of the 4 MBs inside a luma super block (internal.c:63).
MB_MAP = np.array([[0, 3], [1, 2]], dtype=np.int32)

# 4x4 Hilbert ordering of fragments inside a super block, as
# (macro_block_quadrant, block_index) per (y, x) (state.c:133-138).
SB_HILBERT = np.array(
    [
        [(0, 0), (0, 1), (3, 2), (3, 3)],
        [(0, 3), (0, 2), (3, 1), (3, 0)],
        [(1, 0), (1, 3), (2, 0), (2, 3)],
        [(1, 1), (1, 2), (2, 1), (2, 2)],
    ],
    dtype=np.int32,
)

# Reference frame slots (state.h:171-184).
FRAME_GOLD = 0
FRAME_PREV = 1
FRAME_SELF = 2

# Unrestricted-motion-vector padding (state.h:167).
UMV_PADDING = 16

# Number of Huffman codebooks (codec.h:425).
NHUFFMAN_TABLES = 80


def ilog(v: int) -> int:
    """Bits needed to represent v (oc_ilog, internal.c:97)."""
    return int(v).bit_length()


# Coding modes (state.h:188-210).
MODE_INTER_NOMV = 0
MODE_INTRA = 1
MODE_INTER_MV = 2
MODE_INTER_MV_LAST = 3
MODE_INTER_MV_LAST2 = 4
MODE_GOLDEN_NOMV = 5
MODE_GOLDEN_MV = 6
MODE_INTER_MV_FOUR = 7

# Reference index of an uncoded fragment (state.h:171-184).
FRAME_NONE = 3

# The reference frame each coding mode predicts from (state.c:33-45).
FRAME_FOR_MODE = np.array(
    [FRAME_PREV, FRAME_SELF, FRAME_PREV, FRAME_PREV, FRAME_PREV,
     FRAME_GOLD, FRAME_GOLD, FRAME_PREV], dtype=np.int32)

# Mode alphabets of coding schemes 1..6 (decode.c:54-93); scheme 0 is
# transmitted, scheme 7 is fixed-length in mode order.
MODE_ALPHABETS = np.array(
    [
        [3, 4, 2, 0, 1, 5, 6, 7],
        [3, 4, 0, 2, 1, 5, 6, 7],
        [3, 2, 4, 0, 1, 5, 6, 7],
        [3, 2, 0, 4, 1, 5, 6, 7],
        [0, 3, 4, 2, 1, 5, 6, 7],
        [0, 5, 3, 4, 2, 1, 6, 7],
        [0, 1, 2, 3, 4, 5, 6, 7],
    ],
    dtype=np.int32,
)

# Extra bits carried by each spec token (internal.c:82-95).
DCT_TOKEN_EXTRA_BITS = np.array(
    [
        0, 0, 0, 2, 3, 4, 12, 3, 6,
        0, 0, 0, 0,
        1, 1, 1, 1, 2, 3, 4, 5, 6, 10,
        1, 1, 1, 1, 1, 3, 4,
        2, 3,
    ],
    dtype=np.int32,
)

# Huffman group boundaries over zig-zag indices: group g covers zzi in
# [HUFF_LIST_MAX[g-1], HUFF_LIST_MAX[g]) (decode.c:1165).
HUFF_LIST_MAX = [1, 6, 15, 28, 64]

# zzi -> Huffman group (0 DC, 1..4 AC bands); theora_tpu/encode/encoder.py
# `_ZZI_GROUP`.
ZZI_GROUP = np.searchsorted(np.asarray(HUFF_LIST_MAX), np.arange(64),
                            side="right")

# Integer and half-pel components of MV offsets (state.c:901-928):
# index by (precision, mv_component + 31).
MVMAP = np.array(
    [
        [
            -15, -15, -14, -14, -13, -13, -12, -12, -11, -11, -10, -10, -9,
            -9, -8, -8, -7, -7, -6, -6, -5, -5, -4, -4, -3, -3, -2, -2, -1,
            -1, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
            9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15,
        ],
        [
            -7, -7, -7, -7, -6, -6, -6, -6, -5, -5, -5, -5, -4, -4, -4, -4,
            -3, -3, -3, -3, -2, -2, -2, -2, -1, -1, -1, -1, 0, 0, 0, 0, 0,
            0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5,
            5, 6, 6, 6, 6, 7, 7, 7, 7,
        ],
    ],
    dtype=np.int32,
)
MVMAP2 = np.array(
    [
        [
            -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0,
            -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, 1, 0, 1, 0, 1,
            0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0,
            1, 0, 1, 0, 1,
        ],
        [
            -1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, -1,
            -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, 1, 1,
            1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1,
            0, 1, 1, 1, 0, 1, 1, 1,
        ],
    ],
    dtype=np.int32,
)
