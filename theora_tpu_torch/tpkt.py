"""Reader for the simple framed packet container of the test streams.

Read-side copy of theora_tpu/tpkt.py. Format: magic b"TPKT"; per packet:
u32le length, u8 flags (bit0 b_o_s, bit1 e_o_s), i64le granulepos,
i64le packetno, payload.
"""
from __future__ import annotations

import dataclasses
import struct


@dataclasses.dataclass
class Packet:
    data: bytes
    b_o_s: bool = False
    e_o_s: bool = False
    granulepos: int = -1
    packetno: int = 0


def read_tpkt(path: str) -> list[Packet]:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"TPKT":
        raise ValueError("bad magic")
    off = 4
    pkts = []
    while off < len(raw):
        (ln,) = struct.unpack_from("<I", raw, off)
        off += 4
        flags = raw[off]
        off += 1
        gp, pn = struct.unpack_from("<qq", raw, off)
        off += 16
        pkts.append(
            Packet(raw[off : off + ln], bool(flags & 1), bool(flags & 2),
                   gp, pn)
        )
        off += ln
    return pkts
