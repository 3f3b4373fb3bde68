# Frozen copy of theora_tpu_torch/huffman.py at commit 6cd77e7, imports made relative;
# part of the benchmark's reference decoder, which imports nothing of the port;
# only the setup header's unpack is kept.
"""Huffman codebooks: setup-header unpack and pack, and the MV VLC.

Copy of the parts of theora_tpu/huffman.py the port uses (`Codebook`,
`codebook_unpack`, `codebooks_unpack`, huffdec.c:193-240;
`codebook_pack`, `codebooks_pack`, huffenc.c:850-917; `MV_VLC_BOOK`,
decode.c:743-773). Token decoding and encoding run in the native tier
(native/entropy.cpp).
"""
from __future__ import annotations

from .bitio import BitReader
from .constants import NHUFFMAN_TABLES


class Codebook:
    """One Huffman codebook: up to 32 codes over the 5-bit token
    alphabet, as (token, pattern, nbits) with right-aligned patterns."""

    __slots__ = ("codes",)

    def __init__(self, codes: list[tuple[int, int, int]]):
        self.codes = codes


def codebook_unpack(br: BitReader) -> Codebook:
    """Unpack one codebook via the bit-by-bit tree walk
    (huffdec.c:193-240)."""
    codes: list[tuple[int, int, int]] = []
    nleaves = 0
    code = 0
    length = 0
    while True:
        bit = br.read1()
        if br.bytes_left() < 0:
            raise ValueError("truncated Huffman codebook")
        if not bit:
            length += 1
            if length > 32:
                raise ValueError("Huffman code too long")
        else:
            nleaves += 1
            if nleaves > 32:
                raise ValueError("too many Huffman leaves")
            token = br.read(5)
            codes.append((token, code, length))
            if length <= 0:
                break
            # Advance to the next code in DFS order.
            code_bit = 0x80000000 >> (length - 1)
            while length > 0 and (code & code_bit):
                code ^= code_bit
                code_bit <<= 1
                length -= 1
            if length <= 0:
                break
            code |= code_bit
    # 32-bit-aligned code prefixes -> right-aligned patterns.
    return Codebook([(t, c >> (32 - n) if n else 0, n) for t, c, n in codes])


def codebooks_unpack(br: BitReader) -> list[Codebook]:
    return [codebook_unpack(br) for _ in range(NHUFFMAN_TABLES)]


