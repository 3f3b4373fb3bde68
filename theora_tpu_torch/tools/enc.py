"""Encode a .y4m file to Ogg Theora (.ogv) with the device GOP encoder,
or with the host encoder (--host).

Usage: python -m theora_tpu_torch.tools.enc [-q QI] [-k KF] [-z SPEED]
           [-b BITRATE [--two-pass [--two-pass-file F] [--rate-buffer N]]]
           [--adaptive-quant {auto,on,off}] [--rd-strength S] [-j N]
           [--host [--drop-frames 0|1]] [-a in.wav [--audio-quality Q]]
           [--device D] in.y4m out.ogv

Counterpart of ``python -m theora_tpu.tools.enc --device`` (the JAX
TpuGopEncoder) with its device-branch options: the qi (with a bitrate, the
quality floor of the rate controller), the keyframe spacing, speed levels
0-4, CBR (-b), 2-pass (--two-pass with -b, the pass-1 metrics file and the
rate buffer), adaptive quantization ("auto" by default, as there) and
the rate-distortion strength (--rd-strength, JAX tools/enc.py:28; 3.0 by
default, GopEncoder's).
Encodes on the card (``--device cuda``, the default); ``cpu`` runs the
plain PyTorch versions of the kernels.

``-j N`` (JAX ``tools/enc.py:38-40,204-220``) encodes GOP-parallel with N
worker processes through the host Encoder, its closed loop decoded on
the device (parallel/transcode.py), byte-identical to one sequential host
Encoder; it takes --rd-strength (JAX :209). Faults of the reference not
copied: JAX's -j silently drops -z and --adaptive-quant (its transcode
builds default encoders); here -j with either set to anything but its
default, or with -b, is a usage error. JAX's --device drops
--rd-strength (:147); here the device encoder takes it.

``--host`` is JAX's default branch (``tools/enc.py:190-245``, taken there
without --device): one host Encoder (encode/encoder.py) at -q, -k, -z,
--adaptive-quant and --rd-strength, its closed loop decoded on --device;
-b is one-pass CBR, where an inter frame that busts the budget is
dropped (a 0-byte packet) unless ``--drop-frames 0``; --two-pass runs a
pass-1 encoder (the fixed-qi measurement pass) and then a pass-2 one on
its metrics, with --rate-buffer as pass 2's window (0: the whole file,
where no frame drops). The output is byte-equal to ``python -m
theora_tpu.tools.enc`` with the same flags. The device encoders never
drop a frame, so --drop-frames without --host is a usage error (JAX's
--device ignores it).

``-a in.wav`` (JAX ``tools/enc.py:50-56,113-140``) encodes a 16-bit PCM
WAV to a Vorbis stream through the system libvorbis (tools/vorbis.py) at
``--audio-quality`` and muxes it with the video by page end time
(ogg.mux_av), on every branch.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def pad_frames(frames, W: int, H: int, pixel_fmt: int):
    """Edge-pad display-orientation frames to multiples of 16, with the
    crop rectangle covering the picture (encode.c:1562-1638). Returns
    (frame width, frame height, padded frames)."""
    fw, fh = (W + 15) & ~15, (H + 15) & ~15
    if (fw, fh) == (W, H):
        return fw, fh, frames
    hd = 0 if pixel_fmt == 3 else 1
    vd = 0 if pixel_fmt >= 2 else 1
    sizes = ((fh, fw), (fh >> vd, fw >> hd), (fh >> vd, fw >> hd))
    return fw, fh, [
        [np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")
         for p, (h, w) in zip(fr, sizes)]
        for fr in frames
    ]


def host_encode(args, info, frames) -> list:
    """JAX's host branch (tools/enc.py:190-245): headers and packets of
    one host Encoder, after a pass-1 encoder with --two-pass."""
    from theora_tpu_torch.encode.encoder import Encoder
    from theora_tpu_torch.encode.rate import RateControl

    def make_encoder():
        e = Encoder(info, device=args.device)
        e.keyframe_freq = args.keyframe_freq
        e.adaptive_quant = {"auto": "auto", "on": True,
                            "off": False}[args.adaptive_quant]
        if args.rd_strength is not None:
            e.rd_strength = args.rd_strength
        if args.speed:
            e.set_splevel(args.speed)
        return e

    blob = None
    if args.two_pass:
        # Pass 1: the fixed-qi measurement pass writing the reference's
        # OT2P metrics (rate.c:878-936, encoder_example.c:1190-1226).
        enc1 = make_encoder()
        enc1.rc = RateControl(info, args.keyframe_freq)
        enc1.rc.start_pass1()
        body = b""
        for fr in frames:
            enc1.encode_frame(fr)
            body += enc1.rc.pass1_frame_data()
        blob = enc1.rc.pass1_summary() + body
        if args.two_pass_file:
            with open(args.two_pass_file, "wb") as f:
                f.write(blob)
        print(f"pass 1: {len(enc1.rc.frame_metrics)} frame metrics "
              f"({len(blob)} bytes OT2P)", file=sys.stderr)
    enc = make_encoder()
    if blob is not None:
        enc.rc = RateControl(info, args.keyframe_freq)
        enc.rc.start_pass2(blob, buf_delay=args.rate_buffer or None)
    if args.bitrate and args.drop_frames == 0:
        if enc.rc is None:
            enc.rc = RateControl(info, args.keyframe_freq)
        enc.rc.drop_frames = False
    pkts = enc.flush_headers()
    for i, fr in enumerate(frames):
        pkts.append(enc.encode_frame(fr, e_o_s=i == len(frames) - 1))
    return pkts


def write_output(path, pkts, info, audio=None, audio_quality=0.2):
    """Write the Theora packets to path as Ogg, muxed with a Vorbis
    encode of the WAV file `audio` where one is given (JAX
    tools/enc.py:113-140)."""
    from theora_tpu_torch.ogg import mux_av, mux_stream

    if not audio:
        with open(path, "wb") as f:
            f.write(mux_stream(pkts))
        return
    from theora_tpu_torch.tools.vorbis import VorbisEncoder, read_wav

    pcm, rate = read_wav(audio)
    venc = VorbisEncoder(pcm.shape[1], rate, audio_quality)
    apkts = venc.headers()
    for off in range(0, len(pcm), 65536):
        apkts += venc.encode(pcm[off : off + 65536])
    apkts += venc.finish()
    shift = info.keyframe_granule_shift
    num, den = info.fps_numerator, info.fps_denominator

    def vtime(gp):
        nfr = (gp >> shift) + (gp & ((1 << shift) - 1))
        return (nfr + 1) * den / num

    with open(path, "wb") as f:
        f.write(mux_av(pkts, apkts, vtime, lambda gp: gp / rate))
    print(
        f"muxed Vorbis audio: {len(apkts) - 3} packets, "
        f"{pcm.shape[0] / rate:.2f}s @ {rate} Hz",
        file=sys.stderr,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-q", "--quality", type=int, default=48)
    ap.add_argument("-k", "--keyframe-freq", type=int, default=64)
    ap.add_argument("-b", "--bitrate", type=int, default=0,
                    help="target bitrate (bps); enables CBR")
    ap.add_argument("--two-pass", action="store_true",
                    help="two-pass rate control (requires --bitrate)")
    ap.add_argument("--two-pass-file", default=None,
                    help="write the OT2P pass-1 metrics file here")
    ap.add_argument("--rate-buffer", type=int, default=0,
                    help="rate buffer size in frames (finite 2-pass "
                         "window; default = whole file)")
    ap.add_argument("-z", "--speed", type=int, default=0,
                    help="speed level 0-4: 0-1 the trellis, 2-3 the R/D "
                         "quantizer, 4 also no motion compensation")
    ap.add_argument("--adaptive-quant", choices=["auto", "on", "off"],
                    nargs="?", const="on", default="auto",
                    help="activity masking: auto (high-qi region, noise-like "
                         "and mixed frames; default), on (every qi the "
                         "spec allows), off; bare --adaptive-quant means "
                         "'on'")
    ap.add_argument("--rd-strength", type=float, default=None,
                    help="scale of the rate-distortion lambdas (the skip "
                         "test, the qi chooser, the R/D quantizer, the "
                         "mode decision's MV bias); default 3.0")
    ap.add_argument("-j", "--workers", type=int, default=0,
                    help="GOP-parallel encode with N worker processes "
                         "through the host encoder (VBR, speed 0, "
                         "adaptive quant auto; byte-identical to "
                         "sequential)")
    ap.add_argument("--host", action="store_true",
                    help="the host encoder (JAX's default branch), its "
                         "closed loop decoded on --device")
    ap.add_argument("--drop-frames", type=int, choices=[0, 1], default=None,
                    help="with --host and -b: drop an inter frame that "
                         "busts the rate budget (1, the default) or not")
    ap.add_argument("-a", "--audio", default=None,
                    help="16-bit PCM WAV to encode as a Vorbis stream and "
                         "mux A/V with reference page ordering "
                         "(encoder_example.c:1790-1860)")
    ap.add_argument("--audio-quality", type=float, default=0.2,
                    help="Vorbis VBR quality -0.1..1.0 (default 0.2)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    if args.two_pass and not args.bitrate:
        ap.error("--two-pass requires --bitrate")
    if args.drop_frames is not None and not args.host:
        ap.error("--drop-frames applies to the host encoder (--host); the "
                 "device encoders never drop a frame")
    if args.workers and (args.speed or args.adaptive_quant != "auto"
                         or args.bitrate):
        ap.error("-j encodes at speed 0 with adaptive quant 'auto' and no "
                 "target bitrate; it takes no -z, --adaptive-quant or -b")

    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.tools.y4m import read_y4m

    W, H, fps, pixel_fmt, frames = read_y4m(args.input)
    fw, fh, frames = pad_frames(frames, W, H, pixel_fmt)
    info = TheoraInfo(frame_width=fw, frame_height=fh, pic_width=W,
                      pic_height=H, fps_numerator=fps[0],
                      fps_denominator=fps[1], quality=args.quality,
                      target_bitrate=args.bitrate, pixel_fmt=pixel_fmt)
    if args.workers:
        from theora_tpu_torch.parallel.transcode import transcode

        t0 = time.perf_counter()
        pkts = transcode(frames, info, keyframe_freq=args.keyframe_freq,
                         max_workers=args.workers,
                         rd_strength=args.rd_strength, use_processes=True,
                         device=args.device)
        dt = time.perf_counter() - t0
        write_output(args.output, pkts, info, args.audio,
                     args.audio_quality)
        total = sum(len(p.data) for p in pkts[3:])
        mpix = len(frames) * W * H * 1.5 / 1e6
        print(f"{len(frames)} frames, {total} bytes, {dt:.2f}s "
              f"({mpix / dt:.2f} Mpix/s, {args.workers} workers on "
              f"{args.device})", file=sys.stderr)
        return
    if args.host:
        t0 = time.perf_counter()
        pkts = host_encode(args, info, frames)
        dt = time.perf_counter() - t0
        write_output(args.output, pkts, info, args.audio,
                     args.audio_quality)
        total = sum(len(p.data) for p in pkts[3:])
        mpix = len(frames) * W * H * 1.5 / 1e6
        print(f"{len(frames)} frames, {total} bytes, {dt:.2f}s "
              f"({mpix / dt:.2f} Mpix/s, host encoder, closed loop on "
              f"{args.device})", file=sys.stderr)
        return
    rd = {} if args.rd_strength is None else {"rd_strength": args.rd_strength}
    enc = GopEncoder(info, qi=args.quality, device=args.device,
                     adaptive_quant={"auto": "auto", "on": True,
                                     "off": False}[args.adaptive_quant], **rd)
    if args.speed:
        enc.set_splevel(args.speed)
    t0 = time.perf_counter()
    if args.two_pass:
        pkts, blob = enc.encode_clip_twopass(
            frames, keyframe_freq=args.keyframe_freq,
            target_bitrate=args.bitrate,
            buf_delay=args.rate_buffer or None)
        if args.two_pass_file:
            with open(args.two_pass_file, "wb") as f:
                f.write(blob)
    else:
        pkts = enc.encode_clip(frames, keyframe_freq=args.keyframe_freq,
                               target_bitrate=args.bitrate)
    dt = time.perf_counter() - t0
    write_output(args.output, pkts, info, args.audio, args.audio_quality)
    total = sum(len(p.data) for p in pkts[3:])
    mpix = len(frames) * W * H * 1.5 / 1e6
    print(f"{len(frames)} frames, {total} bytes, {dt:.2f}s "
          f"({mpix / dt:.2f} Mpix/s on {enc.device})", file=sys.stderr)


if __name__ == "__main__":
    main()
