# Frozen copy of theora_tpu_torch/info.py at commit 6cd77e7, imports made relative;
# part of the benchmark's reference decoder, which imports nothing of the port.
"""Stream parameters (the `th_info` analogue) and the pixel-format and
colorspace enums.

Copy of theora_tpu/info.py (codec.h:206-298 in the reference).
"""
from __future__ import annotations

import dataclasses
import enum


class PixelFormat(enum.IntEnum):
    """Chroma decimation formats (codec.h:116-131). Bit 0 set: no
    horizontal chroma decimation; bit 1 set: no vertical decimation."""

    PF_420 = 0
    PF_RSVD = 1
    PF_422 = 2
    PF_444 = 3


class ColorSpace(enum.IntEnum):
    """Colorspaces (codec.h:100-109)."""

    UNSPECIFIED = 0
    ITU_REC_470M = 1
    ITU_REC_470BG = 2


# Frame types (lib/state.h:157-161)
INTRA_FRAME = 0
INTER_FRAME = 1

VERSION_MAJOR = 3
VERSION_MINOR = 2
VERSION_SUBMINOR = 1

# The comment header's vendor string: the JAX package's, so the headers
# of the two encoders are byte-identical.
VENDOR_STRING = "theora-tpu 0.1"


@dataclasses.dataclass
class TheoraInfo:
    """Parameters of the info header packet. `pic_y` is measured from the
    top; the bitstream stores it from the bottom (decinfo.c:95-99)."""

    frame_width: int = 0
    frame_height: int = 0
    pic_width: int = 0
    pic_height: int = 0
    pic_x: int = 0
    pic_y: int = 0
    fps_numerator: int = 30
    fps_denominator: int = 1
    aspect_numerator: int = 0
    aspect_denominator: int = 0
    colorspace: int = ColorSpace.UNSPECIFIED
    pixel_fmt: int = PixelFormat.PF_420
    target_bitrate: int = 0
    quality: int = 48
    keyframe_granule_shift: int = 6
    version_major: int = VERSION_MAJOR
    version_minor: int = VERSION_MINOR
    version_subminor: int = 1

    def validate(self) -> None:
        """Validation rules of oc_state_init (state.c:698-727)."""
        if self.frame_width & 0xF or self.frame_height & 0xF:
            raise ValueError("frame dimensions must be multiples of 16")
        if not (0 < self.frame_width < 0x100000):
            raise ValueError("bad frame_width")
        if not (0 < self.frame_height < 0x100000):
            raise ValueError("bad frame_height")
        if self.pic_x + self.pic_width > self.frame_width:
            raise ValueError("picture region exceeds frame width")
        if self.pic_y + self.pic_height > self.frame_height:
            raise ValueError("picture region exceeds frame height")
        if self.pic_x > 255 or (
            self.frame_height - self.pic_height - self.pic_y
        ) > 255:
            raise ValueError("picture offsets out of range")
        if self.pixel_fmt == PixelFormat.PF_RSVD:
            raise ValueError("reserved pixel format")
        if self.fps_numerator < 1 or self.fps_denominator < 1:
            raise ValueError("bad frame rate")

    @property
    def hdec(self) -> int:
        """1 when chroma is decimated horizontally."""
        return 0 if (self.pixel_fmt & 1) else 1

    @property
    def vdec(self) -> int:
        """1 when chroma is decimated vertically."""
        return 0 if (self.pixel_fmt & 2) else 1

    def granule_frame(self, granpos: int) -> int:
        """The frame index of a granule position, -1 for a negative one
        (state.c:1242-1267): streams of version 3.2.1 and later count
        from 1, earlier ones from 0."""
        if granpos < 0:
            return -1
        shift = self.keyframe_granule_shift
        iframe = granpos >> shift
        pframe = granpos - (iframe << shift)
        counts_from_one = (self.version_major, self.version_minor,
                           self.version_subminor) >= (3, 2, 1)
        return iframe + pframe - (1 if counts_from_one else 0)

    def granule_time(self, granpos: int) -> float:
        """The end time in seconds of the frame of a granule position,
        -1.0 for a negative one."""
        if granpos < 0:
            return -1.0
        return ((self.granule_frame(granpos) + 1) * self.fps_denominator
                / self.fps_numerator)
