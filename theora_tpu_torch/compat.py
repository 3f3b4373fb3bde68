"""The reference's `th_*` functional API (include/theora/theoraenc.h,
theoradec.h, codec.h) on the port's host Encoder and per-packet decoder,
and the pre-1.0 `theora_*` API (include/theora/theora.h) over it, as
lib/apiwrapper.c does.

Port of theora_tpu/compat.py. Encode half: the TH_ENCCTL_* codes,
th_encode_alloc and th_enc_ctx (ctl with all 15 codes: keyframe
frequency, quality, bitrate, rate flags and buffer, speed level, dup
count, Huffman codes, quantization parameters, another encoder's setup
header, the 2-pass metrics out and in, VP3 compatibility; flushheader,
ycbcr_in, packetout) over `encode.encoder.Encoder`, whose closed loop
decodes on `device`. Decode half: the error codes and the TH_DECCTL_*
codes, th_version_string, th_packet_isheader and th_packet_iskeyframe,
th_decode_headerin, th_decode_alloc and th_dec_ctx, whose ctl sets the
postprocessing level, the telemetry overlays, the striped-decode
callback and the granule position of a `decode.scalar.PacketDecoder` on
`device`. The pre-1.0 shim: theora_info (with its field-name swap),
theora_state, theora_encode_*, theora_decode_*, the granule helpers,
theora_control and theora_comment*. Every entry point runs on `device`,
"cuda" by default, "cpu" for the plain PyTorch path; without a card
"cuda" raises.

Faults of the reference (ROADMAP.md section 3). F10, not copied: JAX's
ctl rebuilds its Encoder for TH_ENCCTL_SET_HUFFMAN_CODES,
SET_QUANT_PARAMS, SET_COMPAT_CONFIG and SET_VP3_COMPATIBLE, which drops
what earlier ctls set (keyframe frequency, quality, speed level, rate
controller, VP3 mode), while GET_SPLEVEL still returns the old level;
here the rebuilt Encoder keeps them. F11, mirrored:
TH_ENCCTL_SET_DUP_COUNT is stored and never read, so no dup packet
follows a frame, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
import struct

from theora_tpu_torch import tables
from theora_tpu_torch.decode.decoder import BadPacketError
from theora_tpu_torch.decode.scalar import PacketDecoder
from theora_tpu_torch.encode.encoder import Encoder
from theora_tpu_torch.encode.rate import RateControl
from theora_tpu_torch.headers import (
    SetupInfo,
    VersionError,
    pack_comment_header,
    parse_comment_header,
    parse_info_header,
    parse_setup_header,
)
from theora_tpu_torch.info import VENDOR_STRING, TheoraInfo
from theora_tpu_torch.tpkt import Packet

# Error codes (codec.h:77-93).
TH_EFAULT = -1
TH_EINVAL = -10
TH_EBADHEADER = -20
TH_ENOTFORMAT = -21
TH_EVERSION = -22
TH_EIMPL = -23
TH_EBADPACKET = -24
TH_DUPFRAME = 1

# Encoder ctl codes (theoraenc.h:52-377).
TH_ENCCTL_SET_HUFFMAN_CODES = 0
TH_ENCCTL_SET_QUANT_PARAMS = 2
TH_ENCCTL_SET_KEYFRAME_FREQUENCY_FORCE = 4
TH_ENCCTL_SET_VP3_COMPATIBLE = 10
TH_ENCCTL_GET_SPLEVEL_MAX = 12
TH_ENCCTL_SET_SPLEVEL = 14
TH_ENCCTL_GET_SPLEVEL = 16
TH_ENCCTL_SET_DUP_COUNT = 18
TH_ENCCTL_SET_RATE_FLAGS = 20
TH_ENCCTL_SET_RATE_BUFFER = 22
TH_ENCCTL_2PASS_OUT = 24
TH_ENCCTL_2PASS_IN = 26
TH_ENCCTL_SET_QUALITY = 28
TH_ENCCTL_SET_BITRATE = 30
TH_ENCCTL_SET_COMPAT_CONFIG = 32

# Decoder ctl codes (theoradec.h:39-105).
TH_DECCTL_GET_PPLEVEL_MAX = 1
TH_DECCTL_SET_PPLEVEL = 3
TH_DECCTL_SET_GRANPOS = 5
TH_DECCTL_SET_STRIPE_CB = 7
TH_DECCTL_SET_TELEMETRY_MBMODE = 9
TH_DECCTL_SET_TELEMETRY_MV = 11
TH_DECCTL_SET_TELEMETRY_QI = 13
TH_DECCTL_SET_TELEMETRY_BITS = 15

SP_LEVEL_MAX = 4  # OC_SP_LEVEL_MAX (encint.h:226)


def th_version_string() -> str:
    return VENDOR_STRING


def th_packet_isheader(packet: bytes) -> bool:
    return len(packet) > 0 and bool(packet[0] & 0x80)


def th_packet_iskeyframe(packet: bytes) -> int:
    if len(packet) == 0:
        return -1  # dup frame: whatever the previous frame was
    if packet[0] & 0x80:
        return -1
    return 0 if (packet[0] & 0x40) else 1


# --------------------------------------------------------------- encoder
class th_enc_ctx:
    def __init__(self, info: TheoraInfo, device: str = "cuda"):
        self._enc = Encoder(info, device=device)
        self._pending: Packet | None = None
        self._headers_done = False
        self._header_queue: list[Packet] = []
        self._dup_count = 0
        self._2p_sent = 0          # pass-1 records already handed out
        self._2p_fill = b""        # pass-2 input buffer
        self._eos = False
        self._rate_buf: int | None = None
        self._rate_flags: int | None = None

    def _rebuild(self, qinfo, huff_codes) -> None:
        """A new Encoder with other tables that keeps what earlier ctls
        set (F10: JAX's rebuild drops it)."""
        old = self._enc
        e = Encoder(old.info, qinfo=qinfo, huff_codes=huff_codes,
                    device=old.device)
        e.keyframe_freq = old.keyframe_freq
        e.qi = old.qi
        e.set_splevel(old.sp_level)
        e.vp3_compatible = old.vp3_compatible
        e.rc = old.rc
        self._enc = e

    def ctl(self, req: int, buf=None):
        e = self._enc
        if req == TH_ENCCTL_SET_KEYFRAME_FREQUENCY_FORCE:
            e.keyframe_freq = min(int(buf),
                                  1 << e.info.keyframe_granule_shift)
            return e.keyframe_freq
        if req == TH_ENCCTL_SET_QUALITY:
            if e.rc is not None:
                return TH_EINVAL
            e.qi = max(0, min(63, int(buf)))
            return 0
        if req == TH_ENCCTL_SET_BITRATE:
            # A change mid-stream resizes the reservoir but keeps its
            # fullness (encode.c:1461-1478, oc_enc_rc_resize).
            e.info.target_bitrate = int(buf)
            if e.rc is not None:
                e.rc.set_bitrate(int(buf))
            return 0
        if req == TH_ENCCTL_SET_RATE_FLAGS:
            # TH_RATECTL_DROP_FRAMES | CAP_OVERFLOW | CAP_UNDERFLOW
            # (theoraenc.h:176-197).
            self._rate_flags = int(buf)
            if self._ensure_rc() is not None:
                e.rc.set_rate_flags(int(buf))
                return 0
            return TH_EINVAL
        if req == TH_ENCCTL_SET_RATE_BUFFER:
            # The rate buffer in frames, resizable on the fly
            # (theoraenc.h:199-219, rate.c:345).
            self._rate_buf = int(buf)
            if self._ensure_rc() is not None:
                e.rc.resize_buffer(int(buf), started=e.curframe_num >= 0)
                return 0
            return TH_EINVAL
        if req == TH_ENCCTL_GET_SPLEVEL_MAX:
            return SP_LEVEL_MAX
        if req == TH_ENCCTL_SET_SPLEVEL:
            if not 0 <= int(buf) <= SP_LEVEL_MAX:
                return TH_EINVAL
            e.set_splevel(int(buf))
            return 0
        if req == TH_ENCCTL_GET_SPLEVEL:
            return e.sp_level
        if req == TH_ENCCTL_SET_DUP_COUNT:
            # F11: stored and never read, as in JAX (no dup packets).
            self._dup_count = int(buf)
            return 0
        if req == TH_ENCCTL_SET_HUFFMAN_CODES:
            if self._headers_done:
                return TH_EINVAL
            self._rebuild(e.qinfo, buf)
            return 0
        if req == TH_ENCCTL_SET_QUANT_PARAMS:
            if self._headers_done:
                return TH_EINVAL
            self._rebuild(buf, e.huff_codes)
            return 0
        if req == TH_ENCCTL_SET_COMPAT_CONFIG:
            # Another encoder's setup header wholesale: its quantization
            # parameters and Huffman codes (encode.c:1512-1537).
            if self._headers_done:
                return TH_EINVAL
            try:
                setup = parse_setup_header(bytes(buf))
            except Exception:
                return TH_EBADHEADER
            huff = []
            for book in setup.codebooks:
                per = [(0, 0)] * 32
                for token, pattern, nbits in book.codes:
                    per[token] = (pattern, nbits)
                huff.append(per)
            self._rebuild(setup.qinfo, huff)
            return 0
        if req == TH_ENCCTL_2PASS_OUT:
            return self._twopass_out()
        if req == TH_ENCCTL_2PASS_IN:
            return self._twopass_in(buf)
        if req == TH_ENCCTL_SET_VP3_COMPATIBLE:
            if self._headers_done:
                return TH_EINVAL
            want = bool(buf)
            # VP3's operating restrictions (encode.c:1405-1417): 4:2:0
            # only, no cropped picture, at most 4095 super blocks. The
            # downgraded value is reported, not an error.
            if want and (
                e.info.pixel_fmt != 0
                or e.info.pic_width < e.info.frame_width
                or e.info.pic_height < e.info.frame_height
                or e.geometry.nsbs > 4095
            ):
                want = False
            if want:
                self._rebuild(tables.VP31_QUANT_INFO,
                              tables.VP31_HUFF_CODES)
                self._enc.vp3_compatible = True
            return want
        return TH_EIMPL

    def _twopass_out(self):
        """The reference's protocol (rate.c:878-936, encoder_example.c
        :1190-1226): the first call, before any frame, returns the 38-byte
        placeholder header; calls after frames return their 12-byte
        records; the call after the last packet returns the summary header
        to write over the placeholder."""
        rc = self._ensure_rc()
        if rc is None:
            return TH_EINVAL
        if rc.twopass == 0:
            self._2p_sent = 0
            return rc.start_pass1()
        if rc.twopass != 1:
            return TH_EINVAL
        if self._2p_sent < len(rc.frame_metrics):
            out = b"".join(rc.pack_metrics(m)
                           for m in rc.frame_metrics[self._2p_sent:])
            self._2p_sent = len(rc.frame_metrics)
            return out
        if self._eos:
            return rc.pass1_summary()
        return b""

    def _twopass_in(self, buf):
        """Pass-1 data in; with buf None, the number of bytes still
        wanted (0: ready for the next frame), the reference's pull
        protocol (rate.c:949-1034)."""
        rc = self._ensure_rc()
        if rc is None:
            return TH_EINVAL
        if buf is None:
            if rc.twopass == 2:
                return 0
            need = 38 - len(self._2p_fill)
            if need > 0:
                return need
            n0, n1 = struct.unpack_from("<II", self._2p_fill, 8)
            return max(38 + 12 * (n0 + n1) - len(self._2p_fill), 0)
        if rc.twopass == 2:
            return 0  # already primed; more data is ignored
        self._2p_fill += bytes(buf)
        if len(self._2p_fill) >= 38:
            n0, n1 = struct.unpack_from("<II", self._2p_fill, 8)
            if len(self._2p_fill) >= 38 + 12 * (n0 + n1):
                try:
                    rc.start_pass2(self._2p_fill, self._rate_buf)
                except ValueError:
                    return TH_EBADHEADER
                self._2p_fill = b""
        return len(buf)

    def flushheader(self) -> Packet | None:
        if not self._header_queue and not self._headers_done:
            self._header_queue = self._enc.flush_headers()
            self._headers_done = True
        if self._header_queue:
            return self._header_queue.pop(0)
        return None

    def _ensure_rc(self):
        """The rate controller, made on first need for the ctl codes that
        need it before the first frame (CBR only)."""
        e = self._enc
        if e.rc is None and e.info.target_bitrate > 0:
            e.rc = RateControl(e.info, e.keyframe_freq)
            if self._rate_flags is not None:
                e.rc.set_rate_flags(self._rate_flags)
        return e.rc

    def ycbcr_in(self, ycbcr) -> int:
        self._pending = self._enc.encode_frame(ycbcr)
        return 0

    def packetout(self, last: bool) -> Packet | None:
        p = self._pending
        self._pending = None
        if p is not None and last:
            p.e_o_s = True
            self._eos = True
        return p


def th_encode_alloc(info: TheoraInfo, device: str = "cuda") -> th_enc_ctx:
    return th_enc_ctx(info, device=device)


# --------------------------------------------------------------- decoder
class th_dec_ctx:
    def __init__(self, info: TheoraInfo, setup: SetupInfo,
                 device: str = "cuda"):
        self._dec = PacketDecoder(info, setup, device=device)

    def ctl(self, req: int, buf=None):
        if req == TH_DECCTL_GET_PPLEVEL_MAX:
            return 7
        if req == TH_DECCTL_SET_PPLEVEL:
            if not 0 <= int(buf) <= 7:
                return TH_EINVAL
            self._dec.set_pplevel(int(buf))
            return 0
        if req == TH_DECCTL_SET_STRIPE_CB:
            self._dec.stripe_callback = buf
            return 0
        if req == TH_DECCTL_SET_TELEMETRY_MBMODE:
            self._dec.set_telemetry(mbmode=int(buf))
            return 0
        if req == TH_DECCTL_SET_TELEMETRY_MV:
            self._dec.set_telemetry(mv=int(buf))
            return 0
        if req == TH_DECCTL_SET_TELEMETRY_QI:
            self._dec.set_telemetry(qi=int(buf))
            return 0
        if req == TH_DECCTL_SET_TELEMETRY_BITS:
            self._dec.set_telemetry(bits=int(buf))
            return 0
        if req == TH_DECCTL_SET_GRANPOS:
            gp = int(buf)
            if gp < 0:
                return TH_EINVAL
            d = self._dec
            shift = d.info.keyframe_granule_shift
            d.keyframe_num = (gp >> shift) - 1
            d.curframe_num = d.keyframe_num + (gp & ((1 << shift) - 1))
            return 0
        return TH_EIMPL

    def packetin(self, packet: bytes):
        """(0, or TH_DUPFRAME for a frame that repeats the last one, or
        TH_EBADPACKET for a packet the host parse rejects; granpos). Any
        other error (a kernel's, a build's, a wrapper's check, the stripe
        callback's) is not a bad packet: it raises."""
        try:
            ret = self._dec.decode_packet(packet)
        except BadPacketError:
            return TH_EBADPACKET, self._dec.granpos
        return (TH_DUPFRAME if ret == 1 else 0), self._dec.granpos

    def ycbcr_out(self):
        return self._dec.ycbcr_out()


def th_decode_headerin(state: dict, packet: Packet):
    """State-machine header parse; `state` accumulates info/comment/setup.
    Returns >0 while consuming headers, 0 on the first video packet, and
    the reference's error codes (never raises) on damaged headers, in the
    reference's check order (decinfo.c:182-272): packtype first (EOF-zeros
    make an empty packet a data packet), then the codec magic
    (TH_ENOTFORMAT even when the state check would also fail), then the
    in-sequence state checks, then the payload parse. A failed parse
    leaves `state` unchanged, so a later well-formed header can still be
    accepted."""
    data = packet.data
    if len(data) == 0 or not (data[0] & 0x80):
        if "info" not in state:
            return TH_ENOTFORMAT
        if "comment" not in state or "setup" not in state:
            return TH_EBADHEADER
        return 0
    ptype = data[0]
    # The reference checks the magic string before dispatching on the
    # packet type; short packets compare their EOF-zero padding.
    if bytes(data[1:7]).ljust(6, b"\0") != b"theora":
        return TH_ENOTFORMAT
    try:
        if ptype == 0x80:
            if not packet.b_o_s or "info" in state:
                return TH_EBADHEADER
            state["info"] = parse_info_header(data)
            return 3
        if ptype == 0x81:
            if "info" not in state or "comment" in state:
                return TH_EBADHEADER
            state["comment"] = parse_comment_header(data)
            return 2
        if ptype == 0x82:
            if "info" not in state or "comment" not in state or (
                "setup" in state
            ):
                return TH_EBADHEADER
            state["setup"] = parse_setup_header(data)
            return 1
    except VersionError:
        return TH_EVERSION
    except Exception:
        return TH_EBADHEADER
    return TH_EBADHEADER


def th_decode_alloc(state: dict, device: str = "cuda") -> th_dec_ctx:
    return th_dec_ctx(state["info"], state["setup"], device=device)



# ===================================================================
# The pre-1.0 `theora_*` API (include/theora/theora.h:430-777), as
# lib/apiwrapper.c, decapiwrapper.c and encapiwrapper.c map it onto the
# th_* calls above. The legacy field names are swapped:
# theora_info.width / height are the padded frame size and frame_width /
# frame_height the visible picture (theora.h:134-140).
@dataclasses.dataclass
class theora_info:
    width: int = 0
    height: int = 0
    frame_width: int = 0
    frame_height: int = 0
    offset_x: int = 0
    offset_y: int = 0
    fps_numerator: int = 30
    fps_denominator: int = 1
    aspect_numerator: int = 0
    aspect_denominator: int = 0
    colorspace: int = 0
    target_bitrate: int = 0
    quality: int = 48
    quick_p: int = 1
    version_major: int = 3
    version_minor: int = 2
    version_subminor: int = 1
    codec_setup: object = None
    dropframes_p: int = 0
    keyframe_auto_p: int = 1
    keyframe_frequency: int = 64
    keyframe_frequency_force: int = 64
    keyframe_data_target_bitrate: int = 0
    keyframe_auto_threshold: int = 80
    keyframe_mindistance: int = 8
    noise_sensitivity: int = 1
    sharpness: int = 0
    pixelformat: int = 0


def theora_granule_shift(ci: theora_info) -> int:
    return max(1, math.ceil(math.log2(max(ci.keyframe_frequency_force, 2))))


def _legacy_to_info(ci: theora_info) -> TheoraInfo:
    return TheoraInfo(
        frame_width=ci.width, frame_height=ci.height,
        pic_width=ci.frame_width or ci.width,
        pic_height=ci.frame_height or ci.height,
        pic_x=ci.offset_x, pic_y=ci.offset_y,
        fps_numerator=ci.fps_numerator, fps_denominator=ci.fps_denominator,
        aspect_numerator=ci.aspect_numerator,
        aspect_denominator=ci.aspect_denominator,
        colorspace=ci.colorspace, pixel_fmt=ci.pixelformat,
        quality=ci.quality, target_bitrate=ci.target_bitrate,
        keyframe_granule_shift=theora_granule_shift(ci),
    )


class theora_state:
    def __init__(self):
        self.i: theora_info | None = None
        self.granulepos = -1
        self._enc: th_enc_ctx | None = None
        self._dec: th_dec_ctx | None = None


def theora_info_init(ci: theora_info) -> None:
    ci.__init__()


def theora_info_clear(ci: theora_info) -> None:
    ci.__init__()


def theora_encode_init(th: theora_state, ci: theora_info,
                       device: str = "cuda") -> int:
    th.i = ci
    th._enc = th_encode_alloc(_legacy_to_info(ci), device=device)
    th._enc.ctl(TH_ENCCTL_SET_KEYFRAME_FREQUENCY_FORCE,
                ci.keyframe_frequency_force)
    return 0


def theora_encode_YUVin(th: theora_state, yuv) -> int:
    """yuv: [y, u, v] display-orientation planes."""
    if th._enc is None:
        return TH_EFAULT
    ret = th._enc.ycbcr_in(yuv)
    if th._enc._pending is not None:
        th.granulepos = th._enc._pending.granulepos
    return ret


def theora_encode_packetout(th: theora_state, last_p: int):
    if th._enc is None:
        return TH_EFAULT, None
    p = th._enc.packetout(bool(last_p))
    return (1 if p is not None else 0), p


def theora_encode_header(th: theora_state, _op=None):
    return th._enc.flushheader()


def theora_encode_comment(tc=None, _op=None):
    comments = tc.user_comments if tc is not None else None
    vendor = tc.vendor if tc is not None and tc.vendor else None
    return Packet(pack_comment_header(comments, vendor), granulepos=0,
                  packetno=1)


def theora_encode_tables(th: theora_state, _op=None):
    # flushheader queues the headers in order; the tables are the third.
    return th._enc.flushheader()


def theora_decode_header(ci: theora_info, cc, op: Packet) -> int:
    if not th_packet_isheader(op.data):
        return TH_EBADHEADER
    kind = op.data[0]
    if kind == 0x80:
        info = parse_info_header(op.data)
        ci.width = info.frame_width
        ci.height = info.frame_height
        ci.frame_width = info.pic_width
        ci.frame_height = info.pic_height
        ci.offset_x = info.pic_x
        ci.offset_y = info.pic_y
        ci.fps_numerator = info.fps_numerator
        ci.fps_denominator = info.fps_denominator
        ci.aspect_numerator = info.aspect_numerator
        ci.aspect_denominator = info.aspect_denominator
        ci.colorspace = int(info.colorspace)
        ci.pixelformat = int(info.pixel_fmt)
        ci.quality = info.quality
        ci.target_bitrate = info.target_bitrate
        ci.keyframe_frequency_force = 1 << info.keyframe_granule_shift
        ci.codec_setup = {"info": info}
        return 0
    if kind == 0x81:
        parsed = parse_comment_header(op.data)
        if cc is not None and hasattr(cc, "user_comments"):
            cc.vendor = parsed.get("vendor")
            cc.user_comments = list(parsed.get("comments", []))
        return 0
    if kind == 0x82:
        ci.codec_setup["setup"] = parse_setup_header(op.data)
        return 0
    return TH_EBADHEADER


def theora_decode_init(th: theora_state, ci: theora_info,
                       device: str = "cuda") -> int:
    th.i = ci
    if not ci.codec_setup or "setup" not in ci.codec_setup:
        return TH_EFAULT
    th._dec = th_decode_alloc(ci.codec_setup, device=device)
    return 0


def theora_decode_packetin(th: theora_state, op: Packet) -> int:
    ret, gp = th._dec.packetin(op.data if isinstance(op, Packet) else op)
    if ret in (0, TH_DUPFRAME):
        th.granulepos = gp
        return 0
    return ret


def theora_decode_YUVout(th: theora_state, _yuv=None):
    """[y, u, v] display-orientation planes (the yuv_buffer analogue; the
    strides are numpy's)."""
    return th._dec.ycbcr_out()


def theora_packet_isheader(op) -> int:
    return 1 if th_packet_isheader(
        op.data if isinstance(op, Packet) else op) else 0


def theora_packet_iskeyframe(op) -> int:
    return th_packet_iskeyframe(op.data if isinstance(op, Packet) else op)


def theora_granule_frame(th: theora_state, granulepos: int) -> int:
    if granulepos < 0:
        return -1
    shift = theora_granule_shift(th.i)
    iframe = granulepos >> shift
    pframe = granulepos - (iframe << shift)
    return iframe + pframe - 1


def theora_granule_time(th: theora_state, granulepos: int) -> float:
    if granulepos < 0:
        return -1.0
    return ((theora_granule_frame(th, granulepos) + 1)
            * th.i.fps_denominator / th.i.fps_numerator)


def theora_clear(th: theora_state) -> None:
    th._enc = None
    th._dec = None
    th.i = None


def theora_version_string() -> str:
    return th_version_string()


def theora_control(th: theora_state, req: int, buf=None, buf_sz: int = 0):
    ctx = th._enc if th._enc is not None else th._dec
    if ctx is None:
        return TH_EFAULT
    return ctx.ctl(req, buf)


class theora_comment:
    """The legacy comment structure (theora.h:705-767): a vendor string
    and TAG=value user comments."""

    def __init__(self):
        self.user_comments: list[bytes] = []
        self.vendor: bytes | None = None

    def add(self, comment: str | bytes) -> None:
        self.user_comments.append(
            comment.encode() if isinstance(comment, str) else comment)

    def add_tag(self, tag: str, value: str) -> None:
        self.add(f"{tag}={value}")

    def query(self, tag: str, count: int = 0):
        pre = (tag + "=").encode().lower()
        hits = [c for c in self.user_comments if c.lower().startswith(pre)]
        if count < len(hits):
            return hits[count][len(pre):].decode("utf-8", "replace")
        return None

    def query_count(self, tag: str) -> int:
        pre = (tag + "=").encode().lower()
        return sum(1 for c in self.user_comments
                   if c.lower().startswith(pre))

    def clear(self) -> None:
        self.__init__()


def theora_comment_init(tc: theora_comment) -> None:
    tc.__init__()


def theora_comment_add(tc: theora_comment, comment) -> None:
    tc.add(comment)


def theora_comment_add_tag(tc: theora_comment, tag, value) -> None:
    tc.add_tag(tag, value)


def theora_comment_query(tc: theora_comment, tag, count=0):
    return tc.query(tag, count)


def theora_comment_query_count(tc: theora_comment, tag) -> int:
    return tc.query_count(tag)


def theora_comment_clear(tc: theora_comment) -> None:
    tc.clear()
