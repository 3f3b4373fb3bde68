"""MSB-first bit reader with Theora's bit-unpacking semantics.

Read-side copy of theora_tpu/bitio.py: reads past the end of the buffer
return zero bits and latch an EOF flag (bitpack.c:47-53).
"""
from __future__ import annotations


class BitReader:
    """MSB-first bit reader over a bytes-like object."""

    __slots__ = ("data", "nbits", "pos", "eof")

    def __init__(self, data: bytes):
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = 0
        self.eof = False

    def read(self, bits: int) -> int:
        """Read `bits` bits (0..32), zero-padded past EOF."""
        if bits == 0:
            return 0
        pos = self.pos
        end = pos + bits
        self.pos = end
        if end > self.nbits:
            self.eof = True
        data = self.data
        first_byte = pos >> 3
        last_byte = (end - 1) >> 3
        chunk = 0
        nbytes = last_byte - first_byte + 1
        avail = len(data) - first_byte
        if avail >= nbytes:
            chunk = int.from_bytes(data[first_byte:first_byte + nbytes], "big")
        elif avail > 0:
            chunk = int.from_bytes(data[first_byte:], "big") << (
                8 * (nbytes - avail)
            )
        shift = 8 * nbytes - (end - 8 * first_byte)
        return (chunk >> shift) & ((1 << bits) - 1)

    def read1(self) -> int:
        pos = self.pos
        self.pos = pos + 1
        if pos >= self.nbits:
            self.eof = True
            return 0
        return (self.data[pos >> 3] >> (7 - (pos & 7))) & 1

    def bytes_left(self) -> int:
        """Whole bytes remaining, or -1 once EOF has been hit
        (oc_pack_bytes_left, bitpack.c:110-114)."""
        if self.eof:
            return -1
        return (self.nbits - self.pos) >> 3

    def read_string(self, nbytes: int) -> bytes:
        return bytes(self.read(8) for _ in range(nbytes))
