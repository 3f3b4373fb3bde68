"""Vorbis audio tier for A/V muxing, via ctypes over the system libvorbis.

Port of theora_tpu/tools/vorbis.py (host only: no device work), with the
port's Packet and Ogg muxer.

Capability match for the reference CLI's audio path
(examples/encoder_example.c:71-101 flags, :1127-1226
encode loop, :1790-1860 page-ordered mux): we encode PCM (WAV) to Vorbis
packets with libvorbisenc and interleave the two logical streams by page
end-time in theora_tpu_torch.ogg.mux_av.

No vorbis headers are installed in this image, so the caller-allocated
API structs (vorbis_info/vorbis_dsp_state/vorbis_block/vorbis_comment)
are over-sized opaque buffers -- the library only ever touches its own
sizeof, and all field access happens inside libvorbis. The one struct we
read ourselves is ogg_packet, whose LP64 layout is fixed ABI.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from theora_tpu_torch.tpkt import Packet


class OggPacket(ctypes.Structure):
    # libogg's ogg_packet (ogg/ogg.h), LP64 layout.
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


_libs = None


def _load():
    global _libs
    if _libs is not None:
        return _libs
    v = None
    ve = None
    for name in ("libvorbis.so.0", "libvorbis.so"):
        try:
            v = ctypes.CDLL(name, mode=ctypes.RTLD_GLOBAL)
            break
        except OSError:
            continue
    for name in ("libvorbisenc.so.2", "libvorbisenc.so"):
        try:
            ve = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if v is None or ve is None:
        raise RuntimeError("system libvorbis/libvorbisenc unavailable")
    v.vorbis_analysis_buffer.restype = ctypes.POINTER(
        ctypes.POINTER(ctypes.c_float)
    )
    v.vorbis_analysis_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    ve.vorbis_encode_init_vbr.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_float,
    ]
    _libs = (v, ve)
    return _libs


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


class VorbisEncoder:
    """float PCM in, Vorbis `Packet`s out (VBR, libvorbisenc)."""

    def __init__(self, channels: int, rate: int, quality: float = 0.2):
        v, ve = _load()
        self._v = v
        self.channels = channels
        self.rate = rate
        # Over-sized caller-allocated structs (see module docstring).
        self._vi = ctypes.create_string_buffer(1024)
        self._vc = ctypes.create_string_buffer(1024)
        self._vd = ctypes.create_string_buffer(16384)
        self._vb = ctypes.create_string_buffer(16384)
        v.vorbis_info_init(self._vi)
        if ve.vorbis_encode_init_vbr(self._vi, channels, rate, quality):
            raise RuntimeError("vorbis_encode_init_vbr failed")
        v.vorbis_comment_init(self._vc)
        if v.vorbis_analysis_init(self._vd, self._vi):
            raise RuntimeError("vorbis_analysis_init failed")
        v.vorbis_block_init(self._vd, self._vb)
        self._packetno = 0
        self._cleared = False

    def headers(self) -> list[Packet]:
        """The three Vorbis header packets (ident, comment, setup)."""
        v = self._v
        ops = (OggPacket(), OggPacket(), OggPacket())
        if v.vorbis_analysis_headerout(
            self._vd, self._vc,
            ctypes.byref(ops[0]), ctypes.byref(ops[1]), ctypes.byref(ops[2]),
        ):
            raise RuntimeError("vorbis_analysis_headerout failed")
        out = []
        for i, op in enumerate(ops):
            out.append(
                Packet(
                    ctypes.string_at(op.packet, op.bytes),
                    b_o_s=i == 0, granulepos=0, packetno=self._packetno,
                )
            )
            self._packetno += 1
        return out

    def _drain(self) -> list[Packet]:
        v = self._v
        pkts = []
        while v.vorbis_analysis_blockout(self._vd, self._vb) == 1:
            v.vorbis_analysis(self._vb, None)
            v.vorbis_bitrate_addblock(self._vb)
            op = OggPacket()
            while v.vorbis_bitrate_flushpacket(
                self._vd, ctypes.byref(op)
            ) == 1:
                pkts.append(
                    Packet(
                        ctypes.string_at(op.packet, op.bytes),
                        granulepos=int(op.granulepos),
                        e_o_s=bool(op.e_o_s),
                        packetno=self._packetno,
                    )
                )
                self._packetno += 1
        return pkts

    def encode(self, pcm: np.ndarray) -> list[Packet]:
        """Feed PCM samples [n, channels] (float32 in [-1, 1] or int16)
        and return any completed packets."""
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        if pcm.dtype == np.int16:
            pcm = pcm.astype(np.float32) / 32768.0
        pcm = np.ascontiguousarray(pcm, dtype=np.float32)
        n = pcm.shape[0]
        buf = self._v.vorbis_analysis_buffer(self._vd, n)
        for ch in range(self.channels):
            ctypes.memmove(
                buf[ch],
                np.ascontiguousarray(pcm[:, ch]).ctypes.data,
                n * 4,
            )
        self._v.vorbis_analysis_wrote(self._vd, n)
        return self._drain()

    def finish(self) -> list[Packet]:
        """Signal end of stream and return the remaining packets (the
        last one carries e_o_s)."""
        self._v.vorbis_analysis_wrote(self._vd, 0)
        pkts = self._drain()
        self.close()
        return pkts

    def close(self):
        if self._cleared:
            return
        self._cleared = True
        v = self._v
        v.vorbis_block_clear(self._vb)
        v.vorbis_dsp_clear(self._vd)
        v.vorbis_comment_clear(self._vc)
        v.vorbis_info_clear(self._vi)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class VorbisDecoder:
    """Vorbis packet decoder (libvorbis synthesis API): proves muxed
    audio streams are playable end-to-end. Feed the 3 header packets,
    then data packets; decode() returns float32 PCM [n, channels]."""

    def __init__(self, header_packets: list[Packet]):
        v, _ = _load()
        self._v = v
        v.vorbis_synthesis_pcmout.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        self._vi = ctypes.create_string_buffer(1024)
        self._vc = ctypes.create_string_buffer(1024)
        self._vd = ctypes.create_string_buffer(16384)
        self._vb = ctypes.create_string_buffer(16384)
        v.vorbis_info_init(self._vi)
        v.vorbis_comment_init(self._vc)
        for i, p in enumerate(header_packets):
            op = self._as_ogg_packet(p, i)
            if v.vorbis_synthesis_headerin(
                self._vi, self._vc, ctypes.byref(op)
            ):
                raise RuntimeError(f"bad vorbis header packet {i}")
        if v.vorbis_synthesis_init(self._vd, self._vi):
            raise RuntimeError("vorbis_synthesis_init failed")
        v.vorbis_block_init(self._vd, self._vb)
        # vorbis_info's first two fields are (int version, int channels),
        # then (long rate) -- fixed ABI prefix we may read.
        self.channels = struct.unpack_from("<i", self._vi, 4)[0]
        self.rate = struct.unpack_from("<q", self._vi, 8)[0]
        self._pno = 3

    def _as_ogg_packet(self, p: Packet, packetno: int) -> OggPacket:
        buf = (ctypes.c_ubyte * len(p.data)).from_buffer_copy(p.data)
        self._keep = buf  # outlive the call
        return OggPacket(
            packet=buf, bytes=len(p.data),
            b_o_s=1 if p.b_o_s else 0, e_o_s=1 if p.e_o_s else 0,
            granulepos=p.granulepos, packetno=packetno,
        )

    def decode(self, p: Packet) -> np.ndarray:
        v = self._v
        op = self._as_ogg_packet(p, self._pno)
        self._pno += 1
        if v.vorbis_synthesis(self._vb, ctypes.byref(op)) == 0:
            v.vorbis_synthesis_blockin(self._vd, self._vb)
        pcmp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        out = []
        while True:
            n = v.vorbis_synthesis_pcmout(self._vd, ctypes.byref(pcmp))
            if n <= 0:
                break
            chans = [
                np.ctypeslib.as_array(pcmp[ch], shape=(n,)).copy()
                for ch in range(self.channels)
            ]
            out.append(np.stack(chans, axis=1))
            v.vorbis_synthesis_read(self._vd, n)
        if not out:
            return np.zeros((0, self.channels), np.float32)
        return np.concatenate(out, axis=0)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE PCM reader -> ([n, channels] int16, rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    off = 12
    fmt = None
    pcm = None
    while off + 8 <= len(data):
        cid = data[off : off + 4]
        sz = struct.unpack("<I", data[off + 4 : off + 8])[0]
        body = data[off + 8 : off + 8 + sz]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            pcm = body
        off += 8 + sz + (sz & 1)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    tag, channels, rate, _br, _ba, bits = fmt
    if tag != 1 or bits != 16:
        raise ValueError("only 16-bit PCM WAV is supported")
    samples = np.frombuffer(pcm, dtype="<i2").reshape(-1, channels)
    return samples, rate
