"""Header packets (info 0x80, comment 0x81, setup 0x82): parsing and
packing.

Copy of theora_tpu/headers.py (lib/decinfo.c, lib/encinfo.c).
"""
from __future__ import annotations

import dataclasses

from theora_tpu_torch.bitio import BitReader, BitWriter
from theora_tpu_torch.huffman import Codebook, codebooks_pack, \
    codebooks_unpack
from theora_tpu_torch.info import VENDOR_STRING, VERSION_MAJOR, \
    VERSION_MINOR, VERSION_SUBMINOR, TheoraInfo
from theora_tpu_torch.quant import quant_params_pack, quant_params_unpack


@dataclasses.dataclass
class SetupInfo:
    qinfo: dict
    codebooks: list[Codebook]


class NotFormatError(ValueError):
    """The packet does not carry the "theora" codec magic (the reference's
    TH_ENOTFORMAT): it is not a Theora header at all."""


class BadHeaderError(ValueError):
    pass


class VersionError(BadHeaderError):
    """Unsupported bitstream version (the reference's TH_EVERSION,
    decinfo.c:62-67); distinct so th_decode_headerin can report the
    same code the reference does."""


def _check_magic(br: BitReader, kind: int, what: str) -> None:
    if br.read(8) != kind:
        raise BadHeaderError(f"not a {what} header")
    if br.read_string(6) != b"theora":
        raise NotFormatError("bad codec magic")


def parse_info_header(packet: bytes) -> TheoraInfo:
    br = BitReader(packet)
    _check_magic(br, 0x80, "info")
    info = TheoraInfo()
    info.version_major = br.read(8)
    info.version_minor = br.read(8)
    info.version_subminor = br.read(8)
    if info.version_major > VERSION_MAJOR or (
        info.version_major == VERSION_MAJOR
        and info.version_minor > VERSION_MINOR
    ):
        raise VersionError("unsupported bitstream version")
    info.frame_width = br.read(16) << 4
    info.frame_height = br.read(16) << 4
    info.pic_width = br.read(24)
    info.pic_height = br.read(24)
    info.pic_x = br.read(8)
    pic_y_bs = br.read(8)
    info.fps_numerator = br.read(32)
    info.fps_denominator = br.read(32)
    if (
        info.frame_width == 0
        or info.frame_height == 0
        or info.pic_width + info.pic_x > info.frame_width
        or info.pic_height + pic_y_bs > info.frame_height
        or info.fps_numerator == 0
        or info.fps_denominator == 0
    ):
        raise BadHeaderError("bad frame geometry")
    # Invert pic_y to the top-left convention (decinfo.c:95-99).
    info.pic_y = info.frame_height - info.pic_height - pic_y_bs
    info.aspect_numerator = br.read(24)
    info.aspect_denominator = br.read(24)
    info.colorspace = br.read(8)
    info.target_bitrate = br.read(24)
    info.quality = br.read(6)
    info.keyframe_granule_shift = br.read(5)
    info.pixel_fmt = br.read(2)
    if info.pixel_fmt == 1:
        raise BadHeaderError("reserved pixel format")
    if br.read(3) != 0 or br.bytes_left() < 0:
        raise BadHeaderError("bad padding")
    return info


def parse_comment_header(packet: bytes) -> dict:
    br = BitReader(packet)
    _check_magic(br, 0x81, "comment")

    def read_len() -> int:
        v = [br.read(8) for _ in range(4)]
        return v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24

    vendor_len = read_len()
    if vendor_len > br.bytes_left():
        raise BadHeaderError("bad vendor length")
    vendor = br.read_string(vendor_len)
    ncomments = read_len()
    if ncomments * 4 > br.bytes_left():
        raise BadHeaderError("bad comment count")
    comments = []
    for _ in range(ncomments):
        ln = read_len()
        if ln > br.bytes_left():
            raise BadHeaderError("bad comment length")
        comments.append(br.read_string(ln))
    if br.bytes_left() < 0:
        raise BadHeaderError("truncated comment header")
    return {"vendor": vendor, "comments": comments}


def parse_setup_header(packet: bytes) -> SetupInfo:
    br = BitReader(packet)
    _check_magic(br, 0x82, "setup")
    qinfo = quant_params_unpack(br)
    books = codebooks_unpack(br)
    return SetupInfo(qinfo=qinfo, codebooks=books)


def pack_info_header(info: TheoraInfo) -> bytes:
    bw = BitWriter()
    bw.write(0x80, 8)
    bw.write_string(b"theora")
    bw.write(VERSION_MAJOR, 8)
    bw.write(VERSION_MINOR, 8)
    bw.write(VERSION_SUBMINOR, 8)
    bw.write(info.frame_width >> 4, 16)
    bw.write(info.frame_height >> 4, 16)
    bw.write(info.pic_width, 24)
    bw.write(info.pic_height, 24)
    bw.write(info.pic_x, 8)
    bw.write(info.frame_height - info.pic_height - info.pic_y, 8)
    bw.write(info.fps_numerator, 32)
    bw.write(info.fps_denominator, 32)
    bw.write(info.aspect_numerator, 24)
    bw.write(info.aspect_denominator, 24)
    bw.write(int(info.colorspace), 8)
    bw.write(info.target_bitrate, 24)
    bw.write(info.quality, 6)
    bw.write(info.keyframe_granule_shift, 5)
    bw.write(int(info.pixel_fmt), 2)
    bw.write(0, 3)
    return bw.bytes()


def pack_comment_header(comments: list[bytes] | None = None,
                        vendor: bytes | None = None) -> bytes:
    bw = BitWriter()
    bw.write(0x81, 8)
    bw.write_string(b"theora")
    vendor = vendor if vendor is not None else VENDOR_STRING.encode()

    def write_len(v: int) -> None:
        for i in range(4):
            bw.write((v >> (8 * i)) & 0xFF, 8)

    write_len(len(vendor))
    bw.write_string(vendor)
    comments = comments or []
    write_len(len(comments))
    for c in comments:
        write_len(len(c))
        bw.write_string(c)
    return bw.bytes()


def pack_setup_header(qinfo: dict,
                      huff_codes: list[list[tuple[int, int]]]) -> bytes:
    bw = BitWriter()
    bw.write(0x82, 8)
    bw.write_string(b"theora")
    quant_params_pack(bw, qinfo)
    codebooks_pack(bw, huff_codes)
    return bw.bytes()
