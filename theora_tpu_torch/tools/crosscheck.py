"""Randomized encode/decode conformance campaign.

Port of theora_tpu/tools/crosscheck.py, with its six directions; "our
decoder" is the port's PacketDecoder on --device (the card unless
``--device cpu``), and every encoder of a trial runs there too:

- forward (default): the port's host Encoder across random frame
  geometries (odd crops included), pixel formats, quantizers, keyframe
  schedules, CBR and adaptive quantization;
- ``--reverse``: the reference encoder (refbuild/build/ref_enc);
- ``--gop``: the port's device GOP encoder (GopEncoder), with the trellis
  or the R/D quantizer (JAX's ``--device`` direction: here ``--device``
  names the torch device, as in every tool of the port);
- ``--fuzz``: 1-3 damaged data packets of a host encode; both decoders
  must give the same per-packet status (ok, dup or bad) and the same
  bytes, the recovery after a rejected packet included;
- ``--hdr``: damaged header packets through the th_* header state
  machine (compat.py); the same header codes, the same allocation
  decision, the same decoded bytes;
- ``--synth``: legal but R/D-atypical streams, random coding plans packed
  by FramePacker.pack_frame_plan (all-golden frames, saturated vectors,
  extreme coefficients, adversarial qi runs).

Each trial is three steps: ``build_*`` makes the stream, drawing from the
rng in the JAX tool's order (so a seed gives the JAX tool's streams);
``decode_port`` decodes it with the port, returning the per-packet
statuses (or, for --hdr, the events) and the output bytes; ``run_ref``
gets the same from the reference binaries (refbuild/build/ref_dec,
ref_fuzz, ref_hdr; a missing binary is an error that names it).
``compare`` holds one against the other. Only a host-parse rejection of a
data packet (BadPacketError) counts as "bad"; a failure of the card or
of a kernel is never caught. run_trial(direction, ...) runs the three;
the JAX tool's per-direction names (run_reverse_trial, run_device_trial,
run_fuzz_trial, run_hdr_fuzz_trial, run_synth_trial) call it.

Usage: python -m theora_tpu_torch.tools.crosscheck
       [--reverse|--gop|--fuzz|--hdr|--synth] [--device D] [trials] [seed]
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field

import numpy as np

from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.tpkt import Packet, read_tpkt, write_tpkt

REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
REF_DEC = os.path.join(REPO, "refbuild", "build", "ref_dec")
REF_ENC = os.path.join(REPO, "refbuild", "build", "ref_enc")
REF_FUZZ = os.path.join(REPO, "refbuild", "build", "ref_fuzz")
REF_HDR = os.path.join(REPO, "refbuild", "build", "ref_hdr")
# Accepted-but-huge frame geometry guard, mirrored in ref_hdr.c: both
# sides stop before decoder allocation when the accepted info header
# names more pixels than this.
MAX_HDR_AREA = 4096 * 4096


@dataclass
class Stream:
    """A trial's stream: its description, its packets (headers first),
    the postprocessing level the decoders run at, and which decode drives
    it: "dec" (every data packet must decode), "fuzz" (per-packet
    statuses), "hdr" (the header state machine first)."""
    desc: str
    packets: list
    pp: int = 0
    mode: str = "dec"
    # The reverse direction's reference-encoder arguments and frames
    # (its packets come from run_ref).
    ref_enc: tuple | None = None
    frames: list = field(default_factory=list)


def require(path: str) -> None:
    """Raise SystemExit naming a reference binary that is absent."""
    if not os.path.exists(path):
        raise SystemExit(
            f"crosscheck: the reference binary {path} is not built (make "
            f"-C refbuild, from the libtheora sources); the campaign "
            f"compares against it and cannot run without it")


def synth(rng, W, H, n, fmt, kind):
    cw = W if fmt == 3 else W // 2
    ch = H if fmt >= 2 else H // 2
    frames = []
    y0 = rng.randint(0, 256, size=(H, W)).astype(np.uint8)
    for i in range(n):
        if kind == 0:
            yy, xx = np.mgrid[0:H, 0:W]
            y = ((xx * 3 + yy * 2 + i * 7) % 256).astype(np.uint8)
        elif kind == 1:
            y = np.roll(y0, i, axis=1)
        else:
            y = (
                (y0.astype(int)
                 + 30 * np.sin((np.arange(W) + 5 * i) / 17.0)[None, :])
                .clip(0, 255)
            ).astype(np.uint8)
        u = (
            rng.randint(0, 256, size=(ch, cw)).astype(np.uint8)
            if kind == 1
            else np.full((ch, cw), (100 + i * 3) % 256, np.uint8)
        )
        v = np.full((ch, cw), (180 - i * 5) % 256, np.uint8)
        frames.append([y, u, v])
    return frames


def _mutate_packet(rng, data: bytes) -> bytes:
    """One random packet mutation: truncate, bit flips, zeroed range, or
    random-tail extension."""
    b = bytearray(data)
    kind = int(rng.randint(0, 4))
    if kind == 0 and len(b) > 1:  # truncate
        b = b[: int(rng.randint(1, len(b)))]
    elif kind == 1 and len(b):  # flip 1-8 bits
        for _ in range(int(rng.randint(1, 9))):
            i = int(rng.randint(0, len(b)))
            b[i] ^= 1 << int(rng.randint(0, 8))
    elif kind == 2 and len(b) > 2:  # zero a range
        lo = int(rng.randint(0, len(b) - 1))
        hi = int(rng.randint(lo + 1, len(b) + 1))
        b[lo:hi] = bytes(hi - lo)
    else:  # extend with random bytes
        b += bytes(rng.randint(0, 256, int(rng.randint(1, 32))).astype(
            np.uint8
        ).tobytes())
    return bytes(b)


def _mutate_info_packet(rng, data: bytes) -> tuple[bytes, str]:
    """Surgical hostile edits at known info-header byte offsets (the
    info packet layout is fixed at 42 bytes: type(1) magic(6) version(3)
    fw(2) fh(2) pw(3) ph(3) px(1) py(1) fps(8) aspect(6) colorspace(1)
    bitrate(3) quality/kgshift/pixfmt/padding(2))."""
    b = bytearray(data)
    kind = int(rng.randint(0, 10))
    if kind == 0:
        b[7] = 4  # version_major too new -> TH_EVERSION
        tag = "vmaj"
    elif kind == 1:
        b[8] = 9  # version_minor too new -> TH_EVERSION
        tag = "vmin"
    elif kind == 2:
        b[9] = 99  # subminor is always accepted by spec
        tag = "vsub"
    elif kind == 3:
        b[10] = b[11] = 0  # frame_width = 0
        tag = "fw0"
    elif kind == 4:
        b[14] = 0xFF  # pic_width >> frame_width
        tag = "pwbig"
    elif kind == 5:
        b[20] = 0xFF  # pic_x pushes pic past the frame
        tag = "pxbig"
    elif kind == 6:
        b[22:26] = bytes(4)  # fps_numerator = 0
        tag = "fps0"
    elif kind == 7:
        v = (b[40] << 8) | b[41]
        v = (v & ~0x18) | 0x08  # pixel_fmt = 1 (reserved)
        b[40], b[41] = v >> 8, v & 0xFF
        tag = "pfrsvd"
    elif kind == 8:
        v = (b[40] << 8) | b[41]
        v |= int(rng.randint(1, 8))  # nonzero padding bits
        b[40], b[41] = v >> 8, v & 0xFF
        tag = "pad"
    else:
        # Huge-but-legal dims: header accepted, alloc guard must fire
        # identically on both sides.
        b[10] = b[11] = b[12] = b[13] = 0xFF
        tag = "huge"
    return bytes(b), tag


def _mutate_comment_packet(rng, data: bytes) -> tuple[bytes, str]:
    b = bytearray(data)
    kind = int(rng.randint(0, 4))
    if kind == 0:
        b[7:11] = (0xFFFFFFF0).to_bytes(4, "little")  # vendor len huge
        tag = "vendbig"
    elif kind == 1:
        b[7:11] = (0x7FFFFFFF).to_bytes(4, "little")  # vendor len = LONG_MAX
        tag = "vendmax"
    elif kind == 2 and len(b) >= 15:
        # comment count huge (offset depends on vendor length; recompute)
        vlen = int.from_bytes(b[7:11], "little")
        off = 11 + vlen
        if off + 4 <= len(b):
            b[off:off + 4] = (0x40000000).to_bytes(4, "little")
        tag = "nbig"
    else:
        b = b[: max(1, len(b) - int(rng.randint(1, min(8, len(b)))))]
        tag = "trunc"
    return bytes(b), tag


def _host_encode(info, kf, frames, device, adaptive=False):
    from theora_tpu_torch.encode.encoder import Encoder

    e = Encoder(info, device=device)
    e.keyframe_freq = kf
    if adaptive:
        e.adaptive_quant = True
    hd = e.flush_headers()
    return hd + [e.encode_frame(fr) for fr in frames]


def build_forward(rng, trial, device="cuda") -> Stream:
    fw = int(rng.choice([32, 48, 64, 80, 96, 112]))
    fh = int(rng.choice([32, 48, 64, 80]))
    fmt = int(rng.choice([0, 2, 3]))
    pw = fw - int(rng.randint(0, min(16, fw - 15)))
    ph = fh - int(rng.randint(0, min(16, fh - 15)))
    px = int(rng.randint(0, fw - pw + 1))
    py = int(rng.randint(0, fh - ph + 1))
    qi = int(rng.randint(0, 64))
    kf = int(rng.choice([1, 2, 4, 8]))
    nfr = int(rng.randint(2, 7))
    br = int(rng.choice([0, 0, 0, 80000]))
    desc = (f"{fw}x{fh} pic {pw}x{ph}+{px}+{py} fmt{fmt} qi{qi} kf{kf} "
            f"br{br} kind{trial % 3}")
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=pw, pic_height=ph,
        pic_x=px, pic_y=py, fps_numerator=30, fps_denominator=1,
        quality=qi, keyframe_granule_shift=6, pixel_fmt=fmt,
        target_bitrate=br,
    )
    pkts = _host_encode(info, kf, synth(rng, fw, fh, nfr, fmt, trial % 3),
                        device, adaptive=trial % 7 == 0)
    pp = int(rng.choice([0, 0, 0, 2, 5, 7]))
    if pp:
        desc += f" pp{pp}"
    return Stream(desc, pkts, pp)


def build_reverse(rng, trial, device="cuda") -> Stream:
    fw = int(rng.choice([32, 48, 64, 80, 96]))
    fh = int(rng.choice([32, 48, 64, 80]))
    fmt = int(rng.choice([0, 2, 3]))
    pw = fw - int(rng.randint(0, min(16, fw - 15)))
    ph = fh - int(rng.randint(0, min(16, fh - 15)))
    px = int(rng.randint(0, fw - pw + 1))
    py = int(rng.randint(0, fh - ph + 1))
    qi = int(rng.randint(0, 64))
    kf = int(rng.choice([1, 2, 4, 8]))
    nfr = int(rng.randint(2, 7))
    br = int(rng.choice([0, 0, 80000]))
    desc = (f"REV {fw}x{fh} pic {pw}x{ph}+{px}+{py} fmt{fmt} qi{qi} "
            f"kf{kf} br{br}")
    frames = synth(rng, fw, fh, nfr, fmt, trial % 3)
    return Stream(desc, [], 0, ref_enc=(fw, fh, nfr, qi, kf, br, pw, ph,
                                        px, py, fmt), frames=frames)


def build_gop(rng, trial, device="cuda") -> Stream:
    from theora_tpu_torch.encode.gop import GopEncoder

    fw = int(rng.choice([32, 48, 64, 80, 96]))
    fh = int(rng.choice([32, 48, 64, 80]))
    fmt = int(rng.choice([0, 2, 3]))
    pw = fw - int(rng.randint(0, min(16, fw - 15)))
    ph = fh - int(rng.randint(0, min(16, fh - 15)))
    px = int(rng.randint(0, fw - pw + 1))
    py = int(rng.randint(0, fh - ph + 1))
    qi = int(rng.randint(0, 64))
    kf = int(rng.choice([1, 2, 4, 8]))
    nfr = int(rng.randint(2, 7))
    trellis = bool(rng.randint(0, 2))
    desc = (f"GOP {fw}x{fh} pic {pw}x{ph}+{px}+{py} fmt{fmt} qi{qi} "
            f"kf{kf} {'trellis' if trellis else 'rdquant'}")
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=pw, pic_height=ph,
        pic_x=px, pic_y=py,
        fps_numerator=30, fps_denominator=1, quality=qi,
        keyframe_granule_shift=6, pixel_fmt=fmt,
    )
    enc = GopEncoder(info, qi=qi, use_trellis=trellis, device=device)
    pkts = enc.encode_clip(synth(rng, fw, fh, nfr, fmt, trial % 3),
                           keyframe_freq=kf)
    pp = int(rng.choice([0, 0, 0, 2, 7]))
    if pp:
        desc += f" pp{pp}"
    return Stream(desc, pkts, pp)


def build_fuzz(rng, trial, device="cuda") -> Stream:
    fw = int(rng.choice([32, 48, 64, 80]))
    fh = int(rng.choice([32, 48, 64]))
    fmt = int(rng.choice([0, 2, 3]))
    qi = int(rng.randint(0, 64))
    kf = int(rng.choice([1, 2, 4]))
    nfr = int(rng.randint(3, 8))
    desc = f"FUZZ {fw}x{fh} fmt{fmt} qi{qi} kf{kf} n{nfr}"
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=fw, pic_height=fh,
        fps_numerator=30, fps_denominator=1, quality=qi,
        keyframe_granule_shift=6, pixel_fmt=fmt,
    )
    pkts = _host_encode(info, kf, synth(rng, fw, fh, nfr, fmt, trial % 3),
                        device)
    hd, pk = pkts[:3], pkts[3:]
    # Mutate 1-3 data packets (never the headers).
    nmut = int(rng.randint(1, 4))
    muts = rng.choice(len(pk), size=min(nmut, len(pk)), replace=False)
    datas = [p.data for p in pk]
    for mi in muts:
        datas[mi] = _mutate_packet(rng, datas[mi])
        desc += f" mut@{mi}"
    mutated = hd + [
        Packet(d, granulepos=p.granulepos, packetno=p.packetno,
               e_o_s=p.e_o_s)
        for d, p in zip(datas, pk)
    ]
    return Stream(desc, mutated, 0, mode="fuzz")


def build_hdr(rng, trial, device="cuda") -> Stream:
    fw = int(rng.choice([32, 48, 64]))
    fh = int(rng.choice([32, 48]))
    fmt = int(rng.choice([0, 2, 3]))
    qi = int(rng.randint(0, 64))
    nfr = int(rng.randint(2, 5))
    desc = f"HDR {fw}x{fh} fmt{fmt} qi{qi} n{nfr}"
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=fw, pic_height=fh,
        fps_numerator=30, fps_denominator=1, quality=qi,
        keyframe_granule_shift=6, pixel_fmt=fmt,
    )
    pkts = _host_encode(info, 4, synth(rng, fw, fh, nfr, fmt, trial % 3),
                        device)
    strat = int(rng.randint(0, 6))
    if strat == 0:  # generic byte damage on one header packet
        hi = int(rng.randint(0, 3))
        d, p = _mutate_packet(rng, pkts[hi].data), pkts[hi]
        pkts[hi] = Packet(d, granulepos=p.granulepos,
                          packetno=p.packetno, e_o_s=p.e_o_s,
                          b_o_s=p.b_o_s)
        desc += f" gen@{hi}"
    elif strat == 1:  # targeted info-header field edits
        d, tag = _mutate_info_packet(rng, pkts[0].data)
        pkts[0] = Packet(d, granulepos=pkts[0].granulepos,
                         packetno=0, e_o_s=False, b_o_s=True)
        desc += f" info:{tag}"
    elif strat == 2:  # targeted comment-header edits
        d, tag = _mutate_comment_packet(rng, pkts[1].data)
        pkts[1] = Packet(d, granulepos=pkts[1].granulepos,
                         packetno=1, e_o_s=False)
        desc += f" cmt:{tag}"
    elif strat == 3:  # setup-payload bit damage (quant + Huffman areas)
        d = _mutate_packet(rng, pkts[2].data)
        pkts[2] = Packet(d, granulepos=pkts[2].granulepos,
                         packetno=2, e_o_s=False)
        desc += " setup"
    elif strat == 4:  # packet-sequence damage
        kind = int(rng.randint(0, 6))
        if kind == 0 and len(pkts) > 3:
            del pkts[int(rng.randint(0, 3))]
            desc += " drop"
        elif kind == 1:
            hi = int(rng.randint(0, 3))
            pkts.insert(hi, pkts[hi])
            desc += " dup"
        elif kind == 2:
            pkts[1], pkts[2] = pkts[2], pkts[1]
            desc += " swap"
        elif kind == 3:
            p = pkts[0]
            pkts[0] = Packet(p.data, granulepos=p.granulepos,
                             packetno=0, e_o_s=False, b_o_s=False)
            desc += " nobos"
        elif kind == 4:
            pkts.insert(0, Packet(b"", granulepos=-1, packetno=0))
            desc += " empty1st"
        else:
            junk = bytes([0x83]) + b"theora" + bytes(
                rng.randint(0, 256, 8).astype(np.uint8).tobytes())
            pkts.insert(int(rng.randint(0, 4)),
                        Packet(junk, granulepos=-1, packetno=9))
            desc += " junkhdr"
    else:  # bad magic on a random header
        hi = int(rng.randint(0, 3))
        b = bytearray(pkts[hi].data)
        b[1 + int(rng.randint(0, 6))] ^= 0xFF
        pkts[hi] = Packet(bytes(b), granulepos=pkts[hi].granulepos,
                          packetno=hi, e_o_s=False,
                          b_o_s=pkts[hi].b_o_s)
        desc += f" magic@{hi}"
    return Stream(desc, pkts, 0, mode="hdr")


def build_synth(rng, trial, device="cuda") -> Stream:
    from theora_tpu_torch.constants import (
        FRAME_FOR_MODE,
        FRAME_NONE,
        FRAME_SELF,
        MODE_INTER_MV_FOUR,
    )
    from theora_tpu_torch.encode.packer import FramePacker
    from theora_tpu_torch.info import INTER_FRAME, INTRA_FRAME

    fw = int(rng.choice([32, 48, 64, 80]))
    fh = int(rng.choice([32, 48, 64]))
    fmt = int(rng.choice([0, 2, 3]))
    nfr = int(rng.randint(2, 6))
    desc = f"SYNTH {fw}x{fh} fmt{fmt} n{nfr}"
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=fw, pic_height=fh,
        fps_numerator=30, fps_denominator=1, quality=40,
        keyframe_granule_shift=6, pixel_fmt=fmt,
    )
    fp = FramePacker(info)
    g = fp.geometry
    nfrags = g.nfrags
    pkts = list(fp.flush_headers())

    def rand_qis():
        k = int(rng.randint(1, 4))
        qs = list(rng.choice(64, size=k, replace=False))
        return [int(q) for q in qs]

    def rand_qdct(coded):
        qdct = np.zeros((nfrags, 64), np.int16)
        idx = np.nonzero(coded)[0]
        # Sparse values incl. extremes of every value-token category.
        for i in idx:
            nnz = int(rng.randint(0, 12))
            pos = rng.choice(64, size=nnz, replace=False)
            mags = rng.choice(
                [1, 2, 3, 6, 7, 8, 12, 20, 36, 68, 69, 580], size=nnz
            )
            sgn = rng.choice([-1, 1], size=nnz)
            qdct[i, pos] = (mags * sgn).astype(np.int16)
        return qdct

    pno = 3
    for f in range(nfr):
        qis = rand_qis()
        frag_qii = (
            rng.randint(0, len(qis), nfrags).astype(np.int32)
            if len(qis) > 1 else None
        )
        if f == 0:
            coded = np.zeros(nfrags, bool)
            coded[g.scan_fragis] = True
            frag_refi = np.where(coded, FRAME_SELF,
                                 FRAME_NONE).astype(np.int32)
            data = fp.pack_frame_plan(
                INTRA_FRAME, info.quality, coded, frag_refi, None, None,
                rand_qdct(coded), qis=qis if len(qis) > 1 else None,
                frag_qii=frag_qii,
            )
        else:
            coded = rng.rand(nfrags) < rng.uniform(0.15, 0.95)
            mb_modes = np.zeros(g.nmbs, np.int32)
            mb_mvs = np.zeros((g.nmbs, 2), np.int32)
            frag_refi = np.full(nfrags, FRAME_NONE, np.int32)
            fmv4 = np.zeros((nfrags, 2), np.int32)
            for mbi in range(g.nmbs):
                if not g.mb_valid[mbi]:
                    continue
                mode = int(rng.randint(0, 8))
                mb_modes[mbi] = mode
                mb_mvs[mbi] = rng.randint(-31, 32, 2)
                for p in range(3):
                    for bi in range(4):
                        fi = g.mb_maps[mbi, p, bi]
                        if fi >= 0 and coded[fi]:
                            frag_refi[fi] = FRAME_FOR_MODE[mode]
                if mode == MODE_INTER_MV_FOUR:
                    for bi in range(4):
                        fi = g.mb_maps[mbi, 0, bi]
                        if fi >= 0:
                            fmv4[fi] = rng.randint(-31, 32, 2)
            frag_refi[~coded] = FRAME_NONE
            data = fp.pack_frame_plan(
                INTER_FRAME, info.quality, coded, frag_refi, mb_modes,
                mb_mvs, rand_qdct(coded), frag_mv4=fmv4,
                qis=qis if len(qis) > 1 else None, frag_qii=frag_qii,
            )
        shift = info.keyframe_granule_shift
        pkts.append(Packet(
            data, granulepos=(1 << shift) + f, packetno=pno,
            e_o_s=(f == nfr - 1),
        ))
        pno += 1
    pp = int(rng.choice([0, 0, 2, 5, 7]))
    if pp:
        desc += f" pp{pp}"
    return Stream(desc, pkts, pp)


def _frame_bytes(dec) -> np.ndarray:
    return np.concatenate([x.reshape(-1) for x in dec.ycbcr_out()])


def decode_port(stream: Stream, device="cuda"):
    """The port's side of a trial: (per-packet statuses, output bytes).
    A "dec" or "fuzz" stream: "ok", "dup" or "bad" per data packet. An
    "hdr" stream: the events of the JAX driver loop, ("H", code) per
    header-phase packet, ("A", "skip" / "fail") where the allocation
    stops, ("S", 0 / 1 / -1) per data packet."""
    from theora_tpu_torch.decode.decoder import BadPacketError
    from theora_tpu_torch.decode.scalar import PacketDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    mine = []
    stats = []
    if stream.mode != "hdr":
        pk = stream.packets
        dec = PacketDecoder(parse_info_header(pk[0].data),
                            parse_setup_header(pk[2].data), device)
        if stream.pp:
            dec.set_pplevel(stream.pp)
        for p in pk[3:]:
            try:
                ret = dec.decode_packet(p.data)
            except BadPacketError:
                stats.append("bad")
                continue
            stats.append("dup" if ret == 1 else "ok")
            mine.append(_frame_bytes(dec))
    else:
        from theora_tpu_torch import compat

        state: dict = {}
        dec = None
        for p in stream.packets:
            if dec is None:
                ret = compat.th_decode_headerin(state, p)
                stats.append(("H", ret))
                if ret != 0:
                    continue
                ti = state["info"]
                if ti.frame_width * ti.frame_height > MAX_HDR_AREA:
                    stats.append(("A", "skip"))
                    break
                try:
                    dec = PacketDecoder(state["info"], state["setup"],
                                        device)
                except ValueError:
                    stats.append(("A", "fail"))
                    break
            try:
                ret = dec.decode_packet(p.data)
            except BadPacketError:
                stats.append(("S", -1))
                continue
            stats.append(("S", 1 if ret == 1 else 0))
            mine.append(_frame_bytes(dec))
    out = np.concatenate(mine) if mine else np.zeros(0, np.uint8)
    return stats, out


def run_ref(stream: Stream, tmp: str):
    """The reference's side of a trial, through the binaries: (statuses,
    output bytes) as decode_port gives them; for a "dec" stream the
    statuses are None (ref_dec reports only the decoded frames). A
    reverse trial's packets are the reference encoder's, kept in
    stream.packets."""
    if stream.ref_enc is not None:
        require(REF_ENC)
        fw, fh, nfr, qi, kf, br, pw, ph, px, py, fmt = stream.ref_enc
        with open(tmp + ".i420", "wb") as f:
            for fr in stream.frames:
                for p in fr:
                    f.write(np.ascontiguousarray(p).tobytes())
        r = subprocess.run(
            [REF_ENC, str(fw), str(fh), str(nfr), str(qi), str(kf),
             tmp + ".i420", tmp + ".tpkt", str(br), str(pw), str(ph),
             str(px), str(py), str(fmt)],
            capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(f"reference encoder failed: "
                               f"{r.stderr[-120:]}")
        stream.packets = read_tpkt(tmp + ".tpkt")
    else:
        write_tpkt(tmp + ".tpkt", stream.packets)
    binary = {"dec": REF_DEC, "fuzz": REF_FUZZ, "hdr": REF_HDR}[stream.mode]
    require(binary)
    cmd = [binary, tmp + ".tpkt", tmp + ".yuv"]
    if stream.pp:
        cmd.append(str(stream.pp))
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if stream.mode == "dec":
        if "decoded" not in (r.stdout + r.stderr):
            raise RuntimeError(f"reference decoder rejected the stream: "
                               f"{r.stderr[-80:]}")
        stats = None
    elif r.returncode != 0:
        raise RuntimeError(f"{os.path.basename(binary)} crashed: "
                           f"rc={r.returncode} {r.stderr[-80:]}")
    elif stream.mode == "fuzz":
        stats = ["bad" if s < 0 else "dup" if s == 1 else "ok"
                 for s in (int(line.split()[1])
                           for line in r.stdout.splitlines()
                           if line.startswith("S "))]
    else:
        stats = []
        for line in r.stdout.splitlines():
            f = line.split()
            if f and f[0] in ("H", "A", "S"):
                stats.append((f[0], f[1] if f[0] == "A" else int(f[1])))
    return stats, np.fromfile(tmp + ".yuv", np.uint8)


def _norm(stats):
    """hdr events with the data statuses by category (bad, dup, ok)."""
    return [(k, ("bad" if v < 0 else "dup" if v == 1 else "ok")
             if k == "S" else v) for k, v in stats]


def compare(stream: Stream, ref, mine):
    """None when the two sides agree, else what differs."""
    (ref_stats, ref_bytes), (my_stats, my_bytes) = ref, mine
    if stream.mode == "fuzz" and ref_stats != my_stats:
        return f"status divergence: ref {ref_stats} vs ours {my_stats}"
    if stream.mode == "hdr" and _norm(ref_stats) != _norm(my_stats):
        return f"event divergence: ref {ref_stats} vs ours {my_stats}"
    if len(ref_bytes) != len(my_bytes):
        return f"length {len(ref_bytes)} vs {len(my_bytes)}"
    if not np.array_equal(ref_bytes, my_bytes):
        return f"bytes differ at {int(np.argmax(ref_bytes != my_bytes))}"
    return None


BUILDERS = {"forward": build_forward, "reverse": build_reverse,
            "gop": build_gop, "fuzz": build_fuzz, "hdr": build_hdr,
            "synth": build_synth}
WHICH = {"forward": "our encodes", "reverse": "reference encodes",
         "gop": "device-tier encodes", "fuzz": "mutated streams",
         "synth": "synthetic random plans", "hdr": "mutated headers"}


def run_trial(direction, rng, trial, tmp=None, device="cuda"):
    """One trial, its files at the path prefix tmp (None: in a temporary
    directory of its own): (description, None or the divergence)."""
    import signal

    if tmp is None:
        with tempfile.TemporaryDirectory() as td:
            return run_trial(direction, rng, trial,
                             os.path.join(td, direction), device)
    stream = BUILDERS[direction](rng, trial, device)
    ref = run_ref(stream, tmp)

    def _alarm(signum, frame):
        raise TimeoutError

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(60)
    try:
        mine = decode_port(stream, device)
    except TimeoutError:
        return stream.desc, "our decoder hung >60s"
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    return stream.desc, compare(stream, ref, mine)


# The JAX tool's trials by name (its run_trial is the forward one, here
# run_trial("forward", ...)).
def run_reverse_trial(rng, trial, tmp=None, device="cuda"):
    return run_trial("reverse", rng, trial, tmp, device)


def run_device_trial(rng, trial, tmp=None, device="cuda"):
    return run_trial("gop", rng, trial, tmp, device)


def run_fuzz_trial(rng, trial, tmp=None, device="cuda"):
    return run_trial("fuzz", rng, trial, tmp, device)


def run_hdr_fuzz_trial(rng, trial, tmp=None, device="cuda"):
    return run_trial("hdr", rng, trial, tmp, device)


def run_synth_trial(rng, trial, tmp=None, device="cuda"):
    return run_trial("synth", rng, trial, tmp, device)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    direction = "forward"
    for d in ("reverse", "gop", "fuzz", "synth", "hdr"):
        if f"--{d}" in argv:
            argv.remove(f"--{d}")
            direction = d
    from theora_tpu_torch import resolve_device

    device = resolve_device(device)
    trials = int(argv[0]) if argv else 40
    seed = int(argv[1]) if len(argv) > 1 else 42
    rng = np.random.RandomState(seed)
    fails = 0
    with tempfile.TemporaryDirectory() as td:
        for t in range(trials):
            desc, err = run_trial(direction, rng, t,
                                  os.path.join(td, direction), device)
            if err:
                fails += 1
                print(f"FAIL {desc}: {err}")
    print(f"{trials - fails}/{trials} trials bit-identical "
          f"(reference decoder vs ours, on {WHICH[direction]})")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
