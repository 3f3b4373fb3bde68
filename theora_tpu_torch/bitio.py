"""MSB-first bit reader and writer with Theora's bit-packing semantics.

Copy of theora_tpu/bitio.py: reads past the end of the buffer return zero
bits and latch an EOF flag (bitpack.c:47-53); the writer's bytes equal
oggpackB's.
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


class BitWriter:
    """MSB-first bit writer, byte-output-identical to oggpackB."""

    __slots__ = ("_buf", "_cur", "_curbits")

    def __init__(self):
        self._buf = bytearray()
        self._cur = 0
        self._curbits = 0

    def write(self, value: int, bits: int) -> None:
        if bits <= 0:
            return
        value &= (1 << bits) - 1
        cur = (self._cur << bits) | value
        curbits = self._curbits + bits
        while curbits >= 8:
            curbits -= 8
            self._buf.append((cur >> curbits) & 0xFF)
        self._cur = cur & ((1 << curbits) - 1)
        self._curbits = curbits

    def write_string(self, data: bytes) -> None:
        for b in data:
            self.write(b, 8)

    def append_bits(self, data: bytes, nbits: int) -> None:
        """Append the first nbits of an MSB-first bit buffer."""
        nbytes = nbits >> 3
        if self._curbits == 0:
            self._buf.extend(data[:nbytes])
        else:
            for b in data[:nbytes]:
                self.write(b, 8)
        rem = nbits & 7
        if rem:
            self.write(data[nbytes] >> (8 - rem), rem)

    @property
    def bitpos(self) -> int:
        return 8 * len(self._buf) + self._curbits

    def bytes(self) -> bytes:
        """The bytes written; a trailing partial byte is zero-padded
        (oggpackB_bytes: (endbit + 7) / 8)."""
        out = bytearray(self._buf)
        if self._curbits:
            out.append((self._cur << (8 - self._curbits)) & 0xFF)
        return bytes(out)
