"""Ogg (RFC 3533): page mux and demux, CRC, packet reassembly.

Copy of theora_tpu/ogg.py (`PageWriter`, `mux_stream`, `PageReader`,
`demux_stream`).
"""
from __future__ import annotations

import struct

from theora_tpu_torch.tpkt import Packet

# Ogg CRC: 32-bit, polynomial 0x04c11db7, no reflection, init/xorout 0.
_CRC_TABLE = []
for _i in range(256):
    _r = _i << 24
    for _ in range(8):
        _r = ((_r << 1) ^ 0x04C11DB7) if (_r & 0x80000000) else (_r << 1)
        _r &= 0xFFFFFFFF
    _CRC_TABLE.append(_r)


def _crc(data: bytes) -> int:
    r = 0
    for b in data:
        r = ((r << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((r >> 24) & 0xFF) ^ b]
    return r


class PageWriter:
    """Packs the packets of one logical stream into Ogg pages."""

    def __init__(self, serialno: int):
        self.serialno = serialno
        self.pageno = 0
        self._lacing: list[int] = []
        self._data = bytearray()
        self._granulepos = -1
        self._bos_pending = True
        self._continued = False

    def _flush_page(self, granulepos: int, eos: bool,
                    continued: bool) -> bytes:
        header_type = ((0x01 if self._continued else 0)
                       | (0x02 if self._bos_pending else 0)
                       | (0x04 if eos else 0))
        self._bos_pending = False
        seg_table = bytes(self._lacing)
        header = struct.pack("<4sBBqIIi", b"OggS", 0, header_type,
                             granulepos, self.serialno, self.pageno, 0)
        page = bytearray(header + bytes([len(seg_table)]) + seg_table
                         + bytes(self._data))
        page[22:26] = struct.pack("<I", _crc(bytes(page)))
        self.pageno += 1
        self._lacing = []
        self._data = bytearray()
        self._continued = continued
        return bytes(page)

    def add_packet(self, pkt: Packet, flush: bool = False) -> list[bytes]:
        """Add a packet; returns the pages it completed."""
        pages = []
        data = pkt.data
        n = len(data)
        # n // 255 lacing values of 255, then one of n % 255 (< 255).
        lacing = [255] * (n // 255) + [n % 255]
        pos = 0
        for k, lv in enumerate(lacing):
            self._lacing.append(lv)
            self._data += data[pos:pos + lv]
            pos += lv
            if len(self._lacing) == 255:
                last = k == len(lacing) - 1
                pages.append(self._flush_page(
                    pkt.granulepos if last else -1, False,
                    continued=not last))
        self._granulepos = pkt.granulepos
        if (flush or pkt.e_o_s) and (self._lacing or pkt.e_o_s):
            pages.append(self._flush_page(pkt.granulepos, pkt.e_o_s, False))
        return pages

    def flush(self, eos: bool = False) -> list[bytes]:
        if not self._lacing and not eos:
            return []
        return [self._flush_page(self._granulepos, eos, False)]


def mux_stream(packets: list[Packet], serialno: int = 0x74707531) -> bytes:
    """Mux a Theora packet list into an Ogg byte stream, one packet per
    page (the first header alone on the first page, as stream
    identification requires)."""
    w = PageWriter(serialno)
    out = bytearray()
    for p in packets:
        for page in w.add_packet(p, flush=True):
            out += page
    for page in w.flush():
        out += page
    return bytes(out)


class PageReader:
    """Demuxes Ogg pages back into per-stream packets."""

    def __init__(self, data: bytes):
        self.data = data
        self._partial: dict[int, bytearray] = {}
        # Streams whose continuation state was lost (first page not yet
        # seen, or a page dropped by CRC): the tail of a continued packet
        # is discarded, not emitted truncated (libogg's
        # ogg_stream_packetout -1 resync semantics).
        self._lost: set[int] = set()

    def pages(self):
        data = self.data
        pos = 0
        while True:
            idx = data.find(b"OggS", pos)
            if idx < 0 or idx + 27 > len(data):
                return
            (_magic, _version, htype, granulepos, serialno, pageno,
             crc) = struct.unpack_from("<4sBBqIIi", data, idx)
            nsegs = data[idx + 26]
            seg_table = data[idx + 27 : idx + 27 + nsegs]
            end = idx + 27 + nsegs + sum(seg_table)
            if end > len(data):
                return
            body = data[idx + 27 + nsegs : end]
            # A CRC mismatch means a corrupted page or a false 'OggS'
            # inside a body: resume the capture one byte further on.
            page_bytes = bytearray(data[idx:end])
            page_bytes[22:26] = b"\x00\x00\x00\x00"
            if _crc(bytes(page_bytes)) != crc & 0xFFFFFFFF:
                pos = idx + 1
                continue
            yield {
                "htype": htype,
                "granulepos": granulepos,
                "serialno": serialno,
                "pageno": pageno,
                "segments": seg_table,
                "body": body,
            }
            pos = end

    def packets(self):
        """Yield (serialno, Packet) in stream order; the page granulepos
        goes on the last packet completed on each page."""
        expect_page: dict[int, int] = {}
        for page in self.pages():
            sn = page["serialno"]
            buf = self._partial.setdefault(sn, bytearray())
            body = page["body"]
            off = 0
            continued = bool(page["htype"] & 0x01)
            exp = expect_page.get(sn)
            if (exp is not None and page["pageno"] != exp) or (
                exp is None and continued
            ):
                buf.clear()
                self._lost.add(sn)
            expect_page[sn] = page["pageno"] + 1
            if not continued and buf:
                buf.clear()
            if not continued:
                self._lost.discard(sn)
            drop_first = continued and sn in self._lost
            completed: list[Packet] = []
            for lv in page["segments"]:
                buf += body[off : off + lv]
                off += lv
                if lv < 255:
                    if drop_first:
                        drop_first = False
                        self._lost.discard(sn)
                    else:
                        completed.append(
                            Packet(bytes(buf),
                                   b_o_s=bool(page["htype"] & 0x02),
                                   granulepos=-1)
                        )
                    buf.clear()
            if completed:
                completed[-1].granulepos = page["granulepos"]
                if page["htype"] & 0x04 and not buf:
                    completed[-1].e_o_s = True
            for p in completed:
                yield sn, p


def demux_stream(data: bytes) -> list[Packet]:
    """The first Theora stream's packets from an Ogg byte stream."""
    theora_sn = None
    out = []
    for sn, pkt in PageReader(data).packets():
        if theora_sn is None:
            if len(pkt.data) >= 7 and pkt.data[1:7] == b"theora":
                theora_sn = sn
            else:
                continue
        if sn == theora_sn:
            out.append(pkt)
    return out
