"""Huffman codebooks: setup-header unpack and pack, and the MV VLC.

Copy of the parts of theora_tpu/huffman.py the port uses (`Codebook`,
`codebook_unpack`, `codebooks_unpack`, huffdec.c:193-240;
`codebook_pack`, `codebooks_pack`, huffenc.c:850-917; `MV_VLC_BOOK`,
decode.c:743-773). Token decoding and encoding run in the native tier
(native/entropy.cpp).
"""
from __future__ import annotations

from theora_tpu_torch.bitio import BitReader, BitWriter
from theora_tpu_torch.constants import NHUFFMAN_TABLES


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


def codebook_pack(bw: BitWriter, codes: list[tuple[int, int]]) -> None:
    """Pack one codebook given per-token (pattern, nbits): a depth-first
    walk of the code tree, 0 for an internal node, 1 and the 5-bit token
    for a leaf (oc_huff_codes_pack, huffenc.c:850-917)."""
    tree: dict = {}
    for token, (pattern, nbits) in enumerate(codes):
        if nbits <= 0:
            raise ValueError("every token needs a code to pack")
        node = tree
        for i in range(nbits - 1, -1, -1):
            bit = (pattern >> i) & 1
            if i == 0:
                if bit in node:
                    raise ValueError("code collision")
                node[bit] = token
            else:
                node = node.setdefault(bit, {})
                if not isinstance(node, dict):
                    raise ValueError("code prefix collision")

    def emit(node) -> None:
        if isinstance(node, dict):
            bw.write(0, 1)
            emit(node[0])
            emit(node[1])
        else:
            bw.write(1, 1)
            bw.write(node, 5)

    if 0 not in tree or 1 not in tree:
        raise ValueError("degenerate codebook")
    emit(tree)


def codebooks_pack(bw: BitWriter, books: list[list[tuple[int, int]]]) -> None:
    for codes in books:
        codebook_pack(bw, codes)


def _mv_vlc_entries() -> list[tuple[int, str]]:
    """MV component VLC (decode.c:743-773) as (value + 32, code) pairs."""
    e = [(32, "000"), (33, "001"), (31, "010"), (34, "0110"), (30, "0111"),
         (35, "1000"), (29, "1001")]
    for i, mag in enumerate(range(4, 8)):
        prefix = format(20 + i, "05b")
        e += [(32 + mag, prefix + "0"), (32 - mag, prefix + "1")]
    for i, base in enumerate(range(8, 16, 2)):
        prefix = format(24 + i, "05b")
        e += [(32 + base, prefix + "00"), (32 - base, prefix + "01"),
              (32 + base + 1, prefix + "10"), (32 - base - 1, prefix + "11")]
    for i, base in enumerate(range(16, 32, 4)):
        prefix = format(28 + i, "05b")
        for j in range(4):
            e += [(32 + base + j, prefix + format(2 * j, "03b")),
                  (32 - base - j, prefix + format(2 * j + 1, "03b"))]
    return e


MV_VLC_BOOK = Codebook([(tok, int(bits, 2), len(bits))
                        for tok, bits in _mv_vlc_entries()])
