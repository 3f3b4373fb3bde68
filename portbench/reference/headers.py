# Frozen copy of theora_tpu_torch/headers.py at commit 6cd77e7, imports made relative;
# part of the benchmark's reference decoder, which imports nothing of the port;
# only the info and setup parsers are kept.
"""Header packets (info 0x80, comment 0x81, setup 0x82): parsing and
packing.

Copy of theora_tpu/headers.py (lib/decinfo.c, lib/encinfo.c).
"""
from __future__ import annotations

import dataclasses

from .bitio import BitReader
from .huffman import Codebook, codebooks_unpack
from .info import VERSION_MAJOR, VERSION_MINOR, TheoraInfo
from .quant import quant_params_unpack


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


def parse_setup_header(packet: bytes) -> SetupInfo:
    br = BitReader(packet)
    _check_magic(br, 0x82, "setup")
    qinfo = quant_params_unpack(br)
    books = codebooks_unpack(br)
    return SetupInfo(qinfo=qinfo, codebooks=books)


