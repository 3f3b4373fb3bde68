"""The decode half of the reference's `th_*` functional API
(include/theora/theoradec.h, codec.h), on the port's per-packet decoder.

Port of theora_tpu/compat.py's decode half: the error codes and the
TH_DECCTL_* codes, th_version_string, th_packet_isheader and
th_packet_iskeyframe, th_decode_headerin, th_decode_alloc and th_dec_ctx,
whose ctl sets the postprocessing level, the telemetry overlays, the
striped-decode callback and the granule position of a
`decode.scalar.PacketDecoder` on `device` ("cuda" by default, "cpu" for
the plain PyTorch path). The encode half (th_enc_ctx, TH_ENCCTL_*) and
the pre-1.0 `theora_*` shim are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from theora_tpu_torch.decode.decoder import BadPacketError
from theora_tpu_torch.decode.scalar import PacketDecoder
from theora_tpu_torch.headers import (
    SetupInfo,
    VersionError,
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

# Decoder ctl codes (theoradec.h:39-105).
TH_DECCTL_GET_PPLEVEL_MAX = 1
TH_DECCTL_SET_PPLEVEL = 3
TH_DECCTL_SET_GRANPOS = 5
TH_DECCTL_SET_STRIPE_CB = 7
TH_DECCTL_SET_TELEMETRY_MBMODE = 9
TH_DECCTL_SET_TELEMETRY_MV = 11
TH_DECCTL_SET_TELEMETRY_QI = 13
TH_DECCTL_SET_TELEMETRY_BITS = 15


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
